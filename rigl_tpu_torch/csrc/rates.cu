// Rates probe: what bounds f32-accurate products on this card.  Not a
// port of any TPU kernel; it measures the four rates that sized the f32
// flash backward's design (csrc/flash_attn.cu, section "f32"):
//
//   (a) rates_ffma_kernel: FFMA from registers, 8 independent chains a
//       thread: the CUDA cores' f32 peak.
//   (b) rates_ffma_smem_kernel: FFMA with its operands from shared memory
//       at the FFMA backward's tiling (128 threads on 32-row tiles, 4 x 2
//       outputs a thread; pattern 0 the q kᵀ loop, 6 float4 loads for 32
//       FMAs; pattern 1 the P v loop, 4 + hd / 16 scalar loads for 4 hd /
//       16 FMAs; hd 128, two blocks an SM).
//   (c) rates_wgmma_kernel, modes 0 and 1: wgmma m64nNk8 tf32 with both
//       operands from shared memory (SS) and with A from registers (RS).
//   (d) modes 2 and 3: the same with the three passes of 3xTF32 (a_hi b_hi
//       + a_hi b_lo + a_lo b_hi): SS over tiles split beforehand (2), and
//       the f32 flash backward's own loop (3: hopper.cuh mma_3xtf32, A
//       loaded from the raw tile by Tf32RowFrag and split in registers).
//
// Each wgmma block is two warpgroups over one 64 x 128 A tile and one N x
// 128 B tile (K-major, 128-byte swizzle), N = 16, 32, 64 or 128: the
// widths the backward's products take; `reps` passes over the 16 k-steps
// into one accumulator.  Block 0's warpgroup 0 writes its D (64 x N) so
// the caller can hold one pass (reps = 1) against A Bᵀ in f64, which also
// checks the tf32 register fragment's layout.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

__global__ void __launch_bounds__(256) rates_ffma_kernel(float* out,
                                                         int iters) {
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = 1e-3f * (threadIdx.x + i);
  const float m = 0.9999999f, c = 1e-7f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = fmaf(a[i], m, c);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += a[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// The FFMA backward's shared-memory plan at hd 128: six (32 x 132) f32
// tiles and two (32 x 36) P / dS tiles, 110592 bytes: two blocks an SM.
constexpr int kHd = 128, kLd = kHd + 4, kTile = 32, kPld = kTile + 4;
constexpr int kSmemFloats = 6 * kTile * kLd + 2 * kTile * kPld;

template <int kPattern>
__global__ void __launch_bounds__(128) rates_ffma_smem_kernel(float* out,
                                                              int reps) {
  extern __shared__ __align__(16) float fs[];
  for (int i = threadIdx.x; i < kSmemFloats; i += 128)
    fs[i] = 1e-3f * (i % 7);
  __syncthreads();
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const float* a = fs;
  const float* b = fs + kTile * kLd;
  const float* ps = fs + 6 * kTile * kLd;
  float acc[4][kHd / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kHd / 16; ++c) acc[i][c] = 0.f;
  for (int rep = 0; rep < reps; ++rep) {
    if constexpr (kPattern == 0) {   // c[i][j] += a[row_i] . b[col_j]
#pragma unroll 4
      for (int d = 0; d < kHd; d += 4) {
        float4 av[4], bv[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          av[i] = *reinterpret_cast<const float4*>(a + (tr + 8 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          bv[j] = *reinterpret_cast<const float4*>(b + (tc + 16 * j) * kLd + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            acc[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                         av[i].z * bv[j].z + av[i].w * bv[j].w;
      }
    } else {   // acc[i][c] += sum_k pᵀ(k, row_i) b[k][col_c]
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[k * kPld + tr + 8 * i];
#pragma unroll
        for (int c = 0; c < kHd / 16; ++c) {
          const float bv = b[k * kLd + tc + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * bv;
        }
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kHd / 16; ++c) s += acc[i][c];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

// d (64 x N) += A (64 x 8) @ B (8 x N), tf32, both from shared memory,
// K-major (the probe's SS form).
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d = 1) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "no tf32 SS product of this width");
  if constexpr (N == 16) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 32) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
  }
}

constexpr int kK = 128;   // the tiles' depth: 16 k-steps, as S = Q Kᵀ at hd 128

// Shared memory of the wgmma probe from a 1024-aligned base: A raw, A hi,
// A lo (64 x 128 each), B hi, B lo (N x 128 each), all 128-byte swizzled
// in boxes of 32 columns.
template <int N>
struct RatesPlan {
  static constexpr int kA = 64 * kK * 4, kB = N * kK * 4;
  static constexpr int kBytes = 1024 + 3 * kA + 2 * kB;
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

template <int N, int kMode>
__global__ void __launch_bounds__(256, 1)
    rates_wgmma_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ d,
                       int reps) {
  using L = RatesPlan<N>;
  extern __shared__ unsigned char rs_smem[];
  const uint32_t base = (smem_u32(rs_smem) + 1023) & ~1023u;
  unsigned char* gen = rs_smem + (base - smem_u32(rs_smem));
  const uint32_t a_raw = base, a_hi = base + L::kA, a_lo = a_hi + L::kA;
  const uint32_t b_hi = a_lo + L::kA, b_lo = b_hi + L::kB;
  const int tid = threadIdx.x;
  for (int i = tid; i < 64 * kK; i += 256) {
    uint32_t hi, lo;
    tf32_split(a[i], hi, lo);
    const uint32_t at = f32_sw128(i / kK, i % kK, 64);
    *reinterpret_cast<float*>(gen + at) = a[i];
    *reinterpret_cast<uint32_t*>(gen + L::kA + at) = hi;
    *reinterpret_cast<uint32_t*>(gen + 2 * L::kA + at) = lo;
  }
  for (int i = tid; i < N * kK; i += 256) {
    uint32_t hi, lo;
    tf32_split(b[i], hi, lo);
    const uint32_t at = f32_sw128(i / kK, i % kK, N);
    *reinterpret_cast<uint32_t*>(gen + 3 * L::kA + at) = hi;
    *reinterpret_cast<uint32_t*>(gen + 3 * L::kA + L::kB + at) = lo;
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c = lane % 4;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  auto desc = [&](uint32_t tile, int rows, int kk) {
    return wgmma_desc(tile + (kk / 4) * rows * 128 + (kk % 4) * 32, 16);
  };
  if constexpr (kMode < 3) {
    // Mode 1's A fragments, loaded once (hopper.cuh's tf32 layout).
    uint32_t fa[kK / 8][4];
    if constexpr (kMode == 1) {
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fa[kk][i] = *reinterpret_cast<const uint32_t*>(
              gen + L::kA +
              f32_sw128(r + 8 * (i & 1), 8 * kk + c + 4 * (i >> 1), 64));
    }
    for (int rep = 0; rep < reps; ++rep) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
        if constexpr (kMode == 0) {
          wgmma_tf32_ss<N>(acc, desc(a_hi, 64, kk), desc(b_hi, N, kk));
        } else if constexpr (kMode == 1) {
          wgmma_tf32_rs<N>(acc, fa[kk], desc(b_hi, N, kk));
        } else {
          wgmma_tf32_ss<N>(acc, desc(a_hi, 64, kk), desc(b_hi, N, kk));
          wgmma_tf32_ss<N>(acc, desc(a_hi, 64, kk), desc(b_lo, N, kk));
          wgmma_tf32_ss<N>(acc, desc(a_lo, 64, kk), desc(b_hi, N, kk));
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // one group in flight while the next is issued
    }
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    // The f32 flash backward's product loop itself: A from the raw tile,
    // split in registers (hopper.cuh Tf32RowFrag, mma_3xtf32).
    const Tf32RowFrag<64> frag(a_raw);
    for (int rep = 0; rep < reps; ++rep)
      mma_3xtf32<N, kK / 8>(acc, frag, b_hi, b_lo, N);
  }
  if (blockIdx.x == 0 && wg == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          d[(r + 8 * h) * N + 8 * j + 2 * c + v] = acc[4 * j + 2 * h + v];
  }
}

template <int N, int kMode>
cudaError_t launch_wgmma(const float* a, const float* b, float* d,
                         int blocks, int reps, cudaStream_t stream) {
  constexpr int smem = RatesPlan<N>::kBytes;
  auto kernel = rates_wgmma_kernel<N, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 256, smem, stream>>>(a, b, d, reps);
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches its kernel once on `stream` and returns
// cudaGetLastError() after the launch (0 = launched).

// (a): `blocks` blocks of 256 threads, 256 FLOPs a thread an iteration.
extern "C" int rates_ffma(float* out, int blocks, int iters, void* stream) {
  rates_ffma_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      out, iters);
  return static_cast<int>(cudaGetLastError());
}

// (b): `blocks` blocks of 128 threads, 16 hd = 2048 FLOPs a thread a rep
// in either pattern; out holds blocks * 128 floats.
extern "C" int rates_ffma_smem(float* out, int blocks, int reps, int pattern,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int smem = kSmemFloats * 4;
  cudaError_t err = cudaErrorInvalidValue;
  if (pattern == 0 || pattern == 1) {
    auto kernel = pattern == 0 ? rates_ffma_smem_kernel<0>
                               : rates_ffma_smem_kernel<1>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      kernel<<<blocks, 128, smem, st>>>(out, reps);
      err = cudaGetLastError();
    }
  }
  return static_cast<int>(err);
}

// (c), (d): a (64 x 128) and b (n x 128) f32 row-major, d (64 x n) f32;
// n 16, 32, 64 or 128, mode 0 SS, 1 RS, 2 SS 3xTF32, 3 RS 3xTF32 split in
// the loop (mma_3xtf32); `blocks` blocks of two warpgroups, 2 * 64 * n *
// 128 FLOPs a warpgroup a rep for each pass.
extern "C" int rates_wgmma(const float* a, const float* b, float* d,
                           int blocks, int reps, int n, int mode,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define RATES_CASE(N)                                                 \
  if (n == N && mode == 0) err = launch_wgmma<N, 0>(a, b, d, blocks, reps, \
                                                    st);                   \
  if (n == N && mode == 1) err = launch_wgmma<N, 1>(a, b, d, blocks, reps, \
                                                    st);                   \
  if (n == N && mode == 2) err = launch_wgmma<N, 2>(a, b, d, blocks, reps, \
                                                    st);                   \
  if (n == N && mode == 3) err = launch_wgmma<N, 3>(a, b, d, blocks, reps, \
                                                    st);
  RATES_CASE(16) RATES_CASE(32) RATES_CASE(64) RATES_CASE(128)
#undef RATES_CASE
  return static_cast<int>(err);
}

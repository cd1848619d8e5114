// Packed block-sparse matmul, forward mode: y = x @ W, with W stored as its
// active (bk, bn) blocks, packed (n_active, bk, bn) in column-major order.
// One tiled tensor-core kernel, packed_mm_fwd_kernel, for any m, in bf16 or
// f32, behind the C entry point `packed_mm_fwd`.
//
// Replaces the TPU kernel rigl_tpu/ops/pallas/block_sparse_packed.py
// `_mm_kernel` (launched by `_mm_call` with transpose_w=False, public entry
// `packed_matmul`).  Same result: every output block-column j is the f32 sum
// over column j's active blocks of x[:, rows[a]*bk : +bk] @ w[a], cast once
// to the output type; a column with no active block comes out as zeros.
//
// What bounds it on an H100: at decode (m = 8 rows) each weight byte feeds
// about 8 multiply-adds, far below the ~295 flop/byte where bf16 tensor
// cores become the limit, so decode is weight-bandwidth-bound; at prefill
// (m = 1024) the product is compute-bound.  The kernel streams (x, w) tiles
// through a 3-deep cp.async ring in shared memory while the tensor cores
// (WMMA, bf16 in, f32 accumulate; scalar FMA for f32) work on the tile that
// arrived.  At m <= 32 (one m-tile) it takes 32 x 32 tiles and steps of 256
// rows of bk (128 in f32): few, long steps, because at decode each thread
// block's serial chain of steps, not the loads, bounds it (PERF.md,
// section 6).  At m > 32 the tiles are 64 x 64 x 32 (64 x 64 x 16 in f32).
//
// Work split: one thread block per (m-tile, bn-subtile of block-column j).
// It walks column j's actives [col_ptr[j], col_ptr[j+1]) and, inside each,
// bk in chunks of BK, accumulating in registers; then writes its tile once.
// Nothing carries across thread blocks, so no atomics and no second pass.
// Ragged m and bn / bk smaller than a tile are masked in the kernel (the
// copies zero-fill); the wrapper guarantees 16-byte-aligned rows.
//
// The TPU kernel's panel/slice x-feed variants, dummy entries and VMEM bm
// clamps are Mosaic machinery with no counterpart here.  Not yet here:
// wgmma / TMA, and the transposed (dx) mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps, laid out 2 x 2 over the tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;   // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

template <typename T, int BM, int BN, int BK, int STAGES>
struct Layout {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  // One 16-byte pad per shared row keeps WMMA fragment loads off a single
  // bank and every row start 16-byte aligned for cp.async.
  static constexpr int kXld = BK + kVec;
  static constexpr int kWld = BN + kVec;
  static constexpr int kXBytes = align128(BM * kXld * sizeof(T));
  static constexpr int kWBytes = align128(BK * kWld * sizeof(T));
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kOld = BN + 8;           // f32 epilogue staging
  static constexpr int kOutBytes = BM * kOld * 4;
  static constexpr int kSmemBytes = STAGES * kStageBytes > kOutBytes
                                        ? STAGES * kStageBytes
                                        : kOutBytes;
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 16 == 0, "tile shape");
  static_assert(STAGES >= 2, "ring depth");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory per block");
};

template <typename T, int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
    packed_mm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const int* __restrict__ col_ptr,
                         const int* __restrict__ rows, T* __restrict__ y,
                         int m, int K, int N, int bk, int bn) {
  using L = Layout<T, BM, BN, BK, STAGES>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int tiles_per_col = (bn + BN - 1) / BN;
  const int j = blockIdx.y / tiles_per_col;
  const int n0 = (blockIdx.y % tiles_per_col) * BN;   // offset inside column
  const int a_begin = col_ptr[j];
  const int k_chunks = (bk + BK - 1) / BK;
  const int total = (col_ptr[j + 1] - a_begin) * k_chunks;

  auto x_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes);
  };
  auto w_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes + L::kXBytes);
  };

  // Stage `s` <- the (x, w) tiles of step `it`: active a, bk-chunk k0.
  auto load = [&](int it, int s) {
    const int a = a_begin + it / k_chunks;
    const int k0 = (it % k_chunks) * BK;
    const T* xa = x + static_cast<size_t>(rows[a]) * bk + k0;
    T* xs = x_tile(s);
    for (int c = tid; c < BM * BK / kVec; c += kThreads) {
      const int r = c / (BK / kVec);
      const int kc = (c % (BK / kVec)) * kVec;
      const bool ok = (m0 + r < m) && (k0 + kc < bk);
      const T* src = ok ? xa + static_cast<size_t>(m0 + r) * K + kc : x;
      cp_async16(xs + r * L::kXld + kc, src, ok);
    }
    const T* wa = w + static_cast<size_t>(a) * bk * bn + n0;
    T* ws = w_tile(s);
    for (int c = tid; c < BK * BN / kVec; c += kThreads) {
      const int r = c / (BN / kVec);
      const int nc = (c % (BN / kVec)) * kVec;
      const bool ok = (k0 + r < bk) && (n0 + nc < bn);
      const T* src = ok ? wa + static_cast<size_t>(k0 + r) * bn + nc : w;
      cp_async16(ws + r * L::kWld + nc, src, ok);
    }
  };

  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int FM = BM / 32, FN = BN / 32;   // 16x16 fragments per warp
  const int warp = tid / 32;
  const int wr = warp / 2, wc = warp % 2;
  using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16,
                                         16, float>;
  AccFrag acc[FM][FN];
  constexpr int kPer = BM * BN / kThreads;    // f32 path: outputs per thread
  float facc[kBf16 ? 1 : kPer];
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int jj = 0; jj < FN; ++jj) nvcuda::wmma::fill_fragment(acc[i][jj], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) facc[i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();    // step `it` has landed (this thread)
    __syncthreads();                // ... for every thread; stage it-1 free
    const int next = it + STAGES - 1;
    if (next < total) load(next, next % STAGES);
    cp_async_commit();
    const T* xs = x_tile(it % STAGES);
    const T* ws = w_tile(it % STAGES);
    if constexpr (kBf16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(
              af[i], xs + (wr * (BM / 2) + i * 16) * L::kXld + kk, L::kXld);
#pragma unroll
        for (int jj = 0; jj < FN; ++jj)
          wmma::load_matrix_sync(
              bf[jj], ws + kk * L::kWld + wc * (BN / 2) + jj * 16, L::kWld);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int jj = 0; jj < FN; ++jj)
            wmma::mma_sync(acc[i][jj], af[i], bf[jj], acc[i][jj]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int idx = tid + i * kThreads;
          facc[i] += static_cast<float>(xs[(idx / BN) * L::kXld + k]) *
                     static_cast<float>(ws[k * L::kWld + idx % BN]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: its memory becomes the staging tile

  T* yt = y + static_cast<size_t>(j) * bn + n0;
  if constexpr (kBf16) {
    float* os = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int jj = 0; jj < FN; ++jj)
        nvcuda::wmma::store_matrix_sync(
            os + (wr * (BM / 2) + i * 16) * L::kOld + wc * (BN / 2) + jj * 16,
            acc[i][jj], L::kOld, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < m && n0 + c < bn)
        yt[static_cast<size_t>(m0 + r) * N + c] =
            __float2bfloat16(os[r * L::kOld + c]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < m && n0 + c < bn)
        yt[static_cast<size_t>(m0 + r) * N + c] = static_cast<T>(facc[i]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int STAGES>
cudaError_t launch(const void* x, const void* w, const int* col_ptr,
                   const int* rows, void* y, int m, int K, int nn, int bk,
                   int bn, cudaStream_t stream) {
  constexpr int smem = Layout<T, BM, BN, BK, STAGES>::kSmemBytes;
  auto kernel = packed_mm_fwd_kernel<T, BM, BN, BK, STAGES>;
  // Above 48 KB, dynamic shared memory must be allowed per kernel and
  // device: once for each (instantiation, device), not on every launch.
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  dim3 grid((m + BM - 1) / BM, nn * ((bn + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), col_ptr, rows,
      static_cast<T*>(y), m, K, nn * bn, bk, bn);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches packed_mm_fwd_kernel once
// and returns cudaGetLastError() after the launch (0 = launched).  Runs on
// `stream`; allocates nothing.
extern "C" int packed_mm_fwd(const void* x, const void* w, const void* col_ptr,
                             const void* rows, void* y, int m, int K, int nn,
                             int bk, int bn, int dtype, void* stream) {
  if (m <= 0 || nn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* rw = static_cast<const int*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = m <= 32;   // one m-tile: narrow tiles, long steps
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    err = small ? launch<__nv_bfloat16, 32, 32, 256, 3>(x, w, cp, rw, y, m,
                                                        K, nn, bk, bn, st)
                : launch<__nv_bfloat16, 64, 64, 32, 3>(x, w, cp, rw, y, m, K,
                                                       nn, bk, bn, st);
  } else if (dtype == 0) {
    err = small ? launch<float, 32, 32, 128, 3>(x, w, cp, rw, y, m, K, nn,
                                                bk, bn, st)
                : launch<float, 64, 64, 16, 3>(x, w, cp, rw, y, m, K, nn, bk,
                                               bn, st);
  }
  return static_cast<int>(err);
}

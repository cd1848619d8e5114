// Block-sparse stride-1 SAME convolution of NHWC activations over the active
// (tap, input-block, output-block) entries of a KxK kernel, and its weight
// gradient on those entries only.  Two kernels, each in bf16 or f32:
//
//   tap_conv_kernel<T, false>  behind `tap_conv_fwd`:
//       y[p, j-block] = sum over column j's entries (t, r) of
//                       x[p + shift(t), r-block] @ W[t][r-block, j-block];
//   tap_conv_kernel<T, true>   behind `tap_conv_dx`: the same sum with the
//       taps flipped (t' = T-1-t), gy as input and each W block read
//       transposed: dx[q, r-block] = sum gy[q + shift(t'), j] @ W[t][r, j]ᵀ;
//   tap_dw_kernel<T>           behind `tap_dw`:
//       dW[t][r-block, j-block] = sum over all pixels p of
//                                 x[p + shift(t), r-block]ᵀ gy[p, j-block],
//       for the active entries only.
//
// shift(t) = (t / kw - kh / 2, t % kw - kw / 2) in (row, column) of the image;
// a read that leaves the image is a zero (SAME padding).
//
// Replaces the TPU kernels of rigl_tpu/ops/pallas/block_sparse_conv.py:
// `_conv_kernel` (B4, launched by `_shift_matmul` for the forward and, from
// `_tap_bwd`, for dx with flipped taps and transposed blocks) and its v5 grid
// `_conv_kernel_v5` (B5), which compute the same sums; and `_dw_kernel` (B6,
// launched by `_dw_gather`).  Same results: every output block-column is the
// f32 sum over its entries, cast once to the output type, and a column with
// no entry comes out as zeros (the TPU kernel's dummy entries); dW sums over
// all pixels in f32 and casts once into its block.
//
// The TPU kernel stages x into a zero-padded, batch-minor copy so that every
// tap shift is a constant row offset Mosaic can prove aligned, and walks a
// grid of (row tile, entry) steps.  None of that carries over.  Here the
// activations stay NHWC and unpadded: a thread block owns a tile of BM output
// pixels x BN output channels of one block-column, keeps each pixel's (h, w)
// in shared memory, and for every entry of its column copies the shifted
// (BM x BK) input tile with 16-byte cp.asyncs that zero-fill the pixels whose
// shifted position leaves the image (implicit GEMM).  The copies run through a
// 3-deep ring while the previous tile is multiplied: WMMA 16x16x16 (bf16 in,
// f32 accumulate) or scalar FMA (f32, no TF32).  Each tile is written once, so
// there are no atomics and no second pass, and any batch size works (the TPU
// kernel's N % 16 rule is a Mosaic alignment matter).
//
// What bounds them on an H100: at the WRN-22-2 / RN50 shapes (batch 128,
// block 16 x 16, ERK densities) an entry's product is (BM x 16) @ (16 x 16),
// 16 multiply-adds per input element read, so the forward and dx stream the
// activations once per (entry's column subtile) through L2; the f32 paths are
// bounded by the CUDA cores' FMA rate, the bf16 ones by the loads.
//
// tap_dw_kernel.  One thread block per (active entry, 16 x 16 tile of its
// block), reducing over all N*H*W pixels in chunks of 256 through a 4-deep
// ring in dynamic shared memory: the pixels of a chunk are split over the
// block's 16 warps (bf16: one WMMA accumulator per warp; f32: 32 pixel
// groups of 16 threads, each thread a 4 x 4 micro-tile), and the partial
// sums are added through shared memory at the end.  Each output tile is
// written once.  A layer has few entries (22 at WRN-22-2's first group),
// so few thread blocks each stream a whole (N*H*W x 16) slab of x and of
// gy: the block is wide and the ring deep to keep many loads in flight per
// SM.  Splitting the pixel sum over blocks is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;    // conv: 4 warps
constexpr int kStages = 3;       // conv: cp.async ring depth
constexpr int BM = 128;          // conv: output pixels per thread block
constexpr int BN = 16;           // conv: output channels per thread block
constexpr int BK = 16;           // conv: contraction chunk (input channels)
constexpr int kDwThreads = 512;  // dw: 16 warps
constexpr int kDwStages = 4;     // dw: cp.async ring depth
constexpr int DT = 16;           // dw: output tile is DT x DT
constexpr int DM = 256;          // dw: pixels per chunk

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

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (kIsBf16<T>)
    return __float2bfloat16(v);
  else
    return v;
}

// Shared-memory plan of the conv kernel: a ring of (x tile, W tile) pairs.
// The x tile is (BM x BK), row-major; the W tile (BK x BN) row-major, or for
// dx the stored (BN x BK) region of the block, read as its transpose.  Each
// row carries one 16-byte pad: rows stay 16-byte aligned for cp.async and
// WMMA's fragment loads spread over the banks.
template <typename T, bool kTrans>
struct ConvPlan {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kAld = BK + kVec;
  static constexpr int kBRows = kTrans ? BN : BK;
  static constexpr int kBld = (kTrans ? BK : BN) + kVec;
  static constexpr int kABytes = align128(BM * kAld * sizeof(T));
  static constexpr int kBBytes = align128(kBRows * kBld * sizeof(T));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOld = BN + 4;   // f32 staging of the bf16 epilogue
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBytes =
      kRingBytes > BM * kOld * 4 ? kRingBytes : BM * kOld * 4;
  static_assert(kBytes + 2 * BM * 4 <= 48 * 1024, "static shared memory");
};

// y (M, cy) from x (M, cx), M = N*H*W pixels in NHWC order.  Output block-
// column g walks entries [ptr[g], ptr[g+1]): entry e reads input block
// kblks[e] (width bk) at the shift of taps[e], and the weight block at
// w + woffs[e], whose rows are `w_ld` apart: (bk x bn) row-major, or with
// kTrans the (bn x bk) block it is the transpose of.  bn is the output
// block width.
template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads)
    tap_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ ptr, const int* __restrict__ taps,
                    const int* __restrict__ kblks,
                    const int* __restrict__ woffs, T* __restrict__ y, int M,
                    int H, int W, int cx, int cy, int kh, int kw, int bk,
                    int bn, int w_ld) {
  using L = ConvPlan<T, kTrans>;
  constexpr int kVec = L::kVec;
  __shared__ __align__(128) unsigned char smem[L::kBytes];
  __shared__ int s_h[BM], s_w[BM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int tiles_per_col = (bn + BN - 1) / BN;
  const int g = blockIdx.y / tiles_per_col;
  const int n0 = (blockIdx.y % tiles_per_col) * BN;
  const int e_begin = ptr[g];
  const int k_chunks = (bk + BK - 1) / BK;
  const int total = (ptr[g + 1] - e_begin) * k_chunks;

  // Each pixel's (h, w); rows past M get a row no shift brings back inside.
  for (int i = tid; i < BM; i += kThreads) {
    const int p = m0 + i;
    s_h[i] = p < M ? (p / W) % H : -(1 << 20);
    s_w[i] = p < M ? p % W : 0;
  }
  __syncthreads();

  auto a_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes);
  };
  auto b_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes + L::kABytes);
  };

  // Stage `s` <- the (x, W) tiles of step `it`: entry e, chunk k0.
  auto load = [&](int it, int s) {
    const int e = e_begin + it / k_chunks;
    const int k0 = (it % k_chunks) * BK;
    const int tap = taps[e];
    const int dy = tap / kw - kh / 2, dx = tap % kw - kw / 2;
    const int shift = dy * W + dx;
    const int c0 = kblks[e] * bk + k0;
    T* as = a_tile(s);
    for (int c = tid; c < BM * (BK / kVec); c += kThreads) {
      const int r = c / (BK / kVec);
      const int cc = (c % (BK / kVec)) * kVec;
      const int hh = s_h[r] + dy, ww = s_w[r] + dx;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && cc < bk - k0;
      const T* src =
          ok ? x + static_cast<size_t>(m0 + r + shift) * cx + c0 + cc : x;
      cp_async16(as + r * L::kAld + cc, src, ok);
    }
    const T* wa = w + woffs[e];
    T* bs = b_tile(s);
    constexpr int kCols = kTrans ? BK : BN;
    for (int c = tid; c < L::kBRows * (kCols / kVec); c += kThreads) {
      const int r = c / (kCols / kVec);
      const int cc = (c % (kCols / kVec)) * kVec;
      // rows: chunk k0.. (forward) or output index n0.. (dx).
      const bool ok = kTrans ? (r < bn - n0 && cc < bk - k0)
                             : (r < bk - k0 && cc < bn - n0);
      const T* src =
          ok ? wa + static_cast<size_t>(kTrans ? n0 + r : k0 + r) * w_ld +
                   (kTrans ? k0 : n0) + cc
             : w;
      cp_async16(bs + r * L::kBld + cc, src, ok);
    }
  };

  // Accumulators.  bf16: warp `wid` owns rows [32 wid, +32) as two 16x16
  // WMMA fragments.  f32: thread (tr, tc) = (tid / 4, tid % 4) owns rows
  // tr + 32 i (i < 4) and columns 4 tc + j (j < 4).
  using namespace nvcuda;
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr bool kBf16 = kIsBf16<T>;
  Frag frag[kBf16 ? 2 : 1];
  float acc[kBf16 ? 1 : 4][kBf16 ? 1 : 4];
  const int wid = tid / 32;
  const int tr = tid / 4, tc = tid % 4;
  if constexpr (kBf16) {
    wmma::fill_fragment(frag[0], 0.f);
    wmma::fill_fragment(frag[1], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();   // step `it` has landed (this thread)
    __syncthreads();                // ... for every thread; stage it-1 free
    const int next = it + kStages - 1;
    if (next < total) load(next, next % kStages);
    cp_async_commit();
    const T* as = a_tile(it % kStages);
    const T* bs = b_tile(it % kStages);
    if constexpr (kBf16) {
      using BLayout =
          std::conditional_t<kTrans, wmma::col_major, wmma::row_major>;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> bf;
      wmma::load_matrix_sync(bf, bs, L::kBld);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af;
        wmma::load_matrix_sync(af, as + (32 * wid + 16 * i) * L::kAld,
                               L::kAld);
        wmma::mma_sync(frag[i], af, bf, frag[i]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = static_cast<float>(as[(tr + 32 * i) * L::kAld + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = static_cast<float>(kTrans ? bs[(4 * tc + j) * L::kBld + k]
                                           : bs[k * L::kBld + 4 * tc + j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: it becomes the epilogue's staging

  const int row_lim = M - m0, col_lim = bn - n0;
  T* out = y + static_cast<size_t>(m0) * cy + static_cast<size_t>(g) * bn + n0;
  if constexpr (kBf16) {
    float* os = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::store_matrix_sync(os + (32 * wid + 16 * i) * L::kOld, frag[i],
                              L::kOld, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      if (r < row_lim && c < col_lim)
        out[static_cast<size_t>(r) * cy + c] =
            __float2bfloat16(os[r * L::kOld + c]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 32 * i, c = 4 * tc + j;
        if (r < row_lim && c < col_lim)
          out[static_cast<size_t>(r) * cy + c] = from_float<T>(acc[i][j]);
      }
  }
}

// Shared-memory plan of the dw kernel (dynamic): a ring of (x chunk, gy
// chunk) pairs, each (DM pixels x DT channels) row-major with one 16-byte
// pad per row, and the f32 partial sums of the final reduction, which reuse
// the ring.
template <typename T>
struct DwPlan {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLd = DT + kVec;
  static constexpr int kTileBytes = align128(DM * kLd * sizeof(T));
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingBytes = kDwStages * kStageBytes;
  static constexpr int kWarps = kDwThreads / 32;
  static constexpr int kGroups = kDwThreads / 16;   // f32 pixel groups
  static constexpr int kParts = kIsBf16<T> ? kWarps : kGroups;
  static constexpr int kPartBytes = kParts * DT * DT * 4;
  static constexpr int kBytes =
      kRingBytes > kPartBytes ? kRingBytes : kPartBytes;
  static_assert(kBytes <= 227 * 1024, "dynamic shared memory");
  static_assert(DM == 16 * kWarps && DM % kGroups == 0, "chunk split");
};

// dw of entry e = blockIdx.x, tile blockIdx.y of its (bk x bn) block: rows
// r0.. of input block rblks[e], columns c0.. of output block cblks[e].  x is
// (M, cin), gy (M, cout); the result goes to dw + ooffs[e], rows o_ld apart.
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    tap_dw_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const int* __restrict__ taps, const int* __restrict__ rblks,
                  const int* __restrict__ cblks,
                  const int* __restrict__ ooffs, T* __restrict__ dw, int M,
                  int H, int W, int cin, int cout, int kh, int kw, int bk,
                  int bn, int o_ld) {
  using L = DwPlan<T>;
  constexpr int kVec = L::kVec;
  extern __shared__ __align__(128) unsigned char dw_smem[];

  const int tid = threadIdx.x;
  const int e = blockIdx.x;
  const int tiles_c = (bn + DT - 1) / DT;
  const int r0 = (blockIdx.y / tiles_c) * DT;
  const int c0 = (blockIdx.y % tiles_c) * DT;
  const int tap = taps[e];
  const int dy = tap / kw - kh / 2, dx = tap % kw - kw / 2;
  const int shift = dy * W + dx;
  const int xc = rblks[e] * bk + r0;
  const int gc = cblks[e] * bn + c0;
  const int total = (M + DM - 1) / DM;

  auto x_tile = [&](int s) {
    return reinterpret_cast<T*>(dw_smem + s * L::kStageBytes);
  };
  auto g_tile = [&](int s) {
    return reinterpret_cast<T*>(dw_smem + s * L::kStageBytes + L::kTileBytes);
  };
  auto load = [&](int it, int s) {
    const int p0 = it * DM;
    T* xs = x_tile(s);
    T* gs = g_tile(s);
    for (int c = tid; c < DM * (DT / kVec); c += kDwThreads) {
      const int r = c / (DT / kVec);
      const int cc = (c % (DT / kVec)) * kVec;
      const int p = p0 + r;
      const int hh = (p / W) % H + dy, ww = p % W + dx;
      const bool in = p < M;
      const bool okx = in && hh >= 0 && hh < H && ww >= 0 && ww < W &&
                       cc < bk - r0;
      cp_async16(xs + r * L::kLd + cc,
                 okx ? x + static_cast<size_t>(p + shift) * cin + xc + cc : x,
                 okx);
      const bool okg = in && cc < bn - c0;
      cp_async16(gs + r * L::kLd + cc,
                 okg ? gy + static_cast<size_t>(p) * cout + gc + cc : gy, okg);
    }
  };

  using namespace nvcuda;
  constexpr bool kBf16 = kIsBf16<T>;
  // bf16: warp `wid` sums pixels [16 wid, +16) of every chunk into one
  // fragment.  f32: thread (pg, q) = (tid / 16, tid % 16) sums the pixels
  // m % kGroups == pg into rows 4 (q / 4) .. +4, columns 4 (q % 4) .. +4.
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag;
  float acc[kBf16 ? 1 : 4][kBf16 ? 1 : 4];
  const int wid = tid / 32;
  const int pg = tid / 16, q = tid % 16;
  const int rr = 4 * (q / 4), cq = 4 * (q % 4);
  if constexpr (kBf16) {
    wmma::fill_fragment(frag, 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < total) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    const int next = it + kDwStages - 1;
    if (next < total) load(next, next % kDwStages);
    cp_async_commit();
    const T* xs = x_tile(it % kDwStages);
    const T* gs = g_tile(it % kDwStages);
    if constexpr (kBf16) {
      // A = the x chunk's 16 pixels transposed (channels x pixels): the
      // (pixels x channels) row-major tile read as col_major.
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf;
      wmma::load_matrix_sync(af, xs + 16 * wid * L::kLd, L::kLd);
      wmma::load_matrix_sync(bf, gs + 16 * wid * L::kLd, L::kLd);
      wmma::mma_sync(frag, af, bf, frag);
    } else {
#pragma unroll 4
      for (int m = pg; m < DM; m += L::kGroups) {
        // Rows are 16-byte aligned and rr, cq multiples of 4: one float4
        // load of x's and one of gy's four values.
        const float4 a =
            *reinterpret_cast<const float4*>(xs + m * L::kLd + rr);
        const float4 b =
            *reinterpret_cast<const float4*>(gs + m * L::kLd + cq);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: it holds the partial sums now

  float* part = reinterpret_cast<float*>(dw_smem);
  if constexpr (kBf16) {
    wmma::store_matrix_sync(part + wid * DT * DT, frag, DT,
                            wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        part[pg * DT * DT + (rr + i) * DT + cq + j] = acc[i][j];
  }
  __syncthreads();
  T* out = dw + ooffs[e] + static_cast<size_t>(r0) * o_ld + c0;
  for (int idx = tid; idx < DT * DT; idx += kDwThreads) {
    const int r = idx / DT, c = idx % DT;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < L::kParts; ++k) sum += part[k * DT * DT + idx];
    if (r < bk - r0 && c < bn - c0)
      out[static_cast<size_t>(r) * o_ld + c] = from_float<T>(sum);
  }
}

template <typename T, bool kTrans>
cudaError_t launch_conv(const void* x, const void* w, const void* ptr,
                        const void* taps, const void* kblks,
                        const void* woffs, void* y, int M, int H, int W,
                        int cx, int cy, int ncols, int kh, int kw, int bk,
                        int bn, int w_ld, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, ncols * ((bn + BN - 1) / BN));
  tap_conv_kernel<T, kTrans><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(ptr), static_cast<const int*>(taps),
      static_cast<const int*>(kblks), static_cast<const int*>(woffs),
      static_cast<T*>(y), M, H, W, cx, cy, kh, kw, bk, bn, w_ld);
  return cudaGetLastError();
}

template <bool kTrans>
int dispatch_conv(const void* x, const void* w, const void* ptr,
                  const void* taps, const void* kblks, const void* woffs,
                  void* y, int M, int H, int W, int cx, int cy, int ncols,
                  int kh, int kw, int bk, int bn, int w_ld, int dtype,
                  void* stream) {
  if (M <= 0 || ncols <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch_conv<__nv_bfloat16, kTrans>(x, w, ptr, taps, kblks, woffs,
                                             y, M, H, W, cx, cy, ncols, kh, kw,
                                             bk, bn, w_ld, st);
  else if (dtype == 0)
    err = launch_conv<float, kTrans>(x, w, ptr, taps, kblks, woffs, y, M, H,
                                     W, cx, cy, ncols, kh, kw, bk, bn, w_ld,
                                     st);
  return static_cast<int>(err);
}

template <typename T>
cudaError_t launch_dw(const void* x, const void* gy, const void* taps,
                      const void* rblks, const void* cblks, const void* ooffs,
                      void* dw, int M, int H, int W, int cin, int cout,
                      int n_entries, int kh, int kw, int bk, int bn, int o_ld,
                      cudaStream_t stream) {
  using L = DwPlan<T>;
  cudaError_t err = cudaFuncSetAttribute(
      tap_dw_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(n_entries, ((bk + DT - 1) / DT) * ((bn + DT - 1) / DT));
  tap_dw_kernel<T><<<grid, kDwThreads, L::kBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy),
      static_cast<const int*>(taps), static_cast<const int*>(rblks),
      static_cast<const int*>(cblks), static_cast<const int*>(ooffs),
      static_cast<T*>(dw), M, H, W, cin, cout, kh, kw, bk, bn, o_ld);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point launches its kernel
// once on `stream` and returns cudaGetLastError() after the launch (0 =
// launched); none allocates or synchronises.  Activations are NHWC with
// M = N*H*W pixels; index arrays are int32.

// y (M, ncols*bn) = the tap conv of x (M, cx): output block-column g sums
// entries ptr[g] .. ptr[g+1]-1 (tap taps[e], input block kblks[e] of width
// bk, weight block at w + woffs[e], (bk x bn) with rows w_ld apart).
extern "C" int tap_conv_fwd(const void* x, const void* w, const void* ptr,
                            const void* taps, const void* kblks,
                            const void* woffs, void* y, int M, int H, int W,
                            int cx, int ncols, int kh, int kw, int bk, int bn,
                            int w_ld, int dtype, void* stream) {
  return dispatch_conv<false>(x, w, ptr, taps, kblks, woffs, y, M, H, W, cx,
                              ncols * bn, ncols, kh, kw, bk, bn, w_ld, dtype,
                              stream);
}

// The same with each weight block read transposed: the block at w + woffs[e]
// is stored (bn x bk), rows w_ld apart (dx: gy in, flipped taps).
extern "C" int tap_conv_dx(const void* gy, const void* w, const void* ptr,
                           const void* taps, const void* kblks,
                           const void* woffs, void* dx, int M, int H, int W,
                           int cx, int ncols, int kh, int kw, int bk, int bn,
                           int w_ld, int dtype, void* stream) {
  return dispatch_conv<true>(gy, w, ptr, taps, kblks, woffs, dx, M, H, W, cx,
                             ncols * bn, ncols, kh, kw, bk, bn, w_ld, dtype,
                             stream);
}

// dW of each of the n_entries active entries: the (bk x bn) block at
// dw + ooffs[e] (rows o_ld apart) = sum over pixels of x (M, cin) at the
// shift of taps[e], input block rblks[e], times gy (M, cout), output block
// cblks[e]; f32 sums, one cast.
extern "C" int tap_dw(const void* x, const void* gy, const void* taps,
                      const void* rblks, const void* cblks, const void* ooffs,
                      void* dw, int M, int H, int W, int cin, int cout,
                      int n_entries, int kh, int kw, int bk, int bn, int o_ld,
                      int dtype, void* stream) {
  if (M <= 0 || n_entries <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch_dw<__nv_bfloat16>(x, gy, taps, rblks, cblks, ooffs, dw, M, H,
                                   W, cin, cout, n_entries, kh, kw, bk, bn,
                                   o_ld, st);
  else if (dtype == 0)
    err = launch_dw<float>(x, gy, taps, rblks, cblks, ooffs, dw, M, H, W, cin,
                           cout, n_entries, kh, kw, bk, bn, o_ld, st);
  return static_cast<int>(err);
}

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
//   tap_dw_kernel<T, STAGES>   behind `tap_dw` (with tap_dw_reduce_kernel
//       where the pixel sum is split):
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
// bounded by the CUDA cores' FMA rate, the bf16 ones by the loads.  dW has
// few outputs (a layer's active 16 x 16 blocks) and one long sum each, so
// it is bound by how many SMs the sum is spread over and, then, by the
// bytes of x and gy it reads.
//
// tap_dw_kernel.  The entries are grouped by (input block, output block),
// at most 9 taps a group in bf16, 4 in f32, 2 where an index holds about
// one tap a pair (ops/block_sparse_conv.py builds the groups once per
// index): every tap of a group multiplies a shifted copy of the same x
// columns by the same gy columns.  One 256-thread block per (group, 16 x
// 16 tile of the block, slice of the pixels) walks its slice in chunks of
// 256 pixels through a cp.async ring, 4, 3 or 2 deep (the deepest with
// which 2 thread blocks share an SM, or 4 with groups of 2 taps, whose
// few registers let more blocks keep loads in flight): it loads the chunk's gy rows once, and its x rows once, widened by
// the group's smallest and largest shift (within the halo, W * (kh / 2) +
// kw / 2 rows on each side; zeros outside [0, M)), and computes every tap
// of the group from those two tiles, tap t reading the x tile at row
// offset shift(t).  A shifted row that leaves the image sideways wraps
// to a real pixel of the next image row, so each pixel carries a mask of
// the taps whose shifted pixel lies in the image, applied to the operand
// in registers.  bf16: mma.sync m16n8k16 fed by ldmatrix (wgmma's 64-row
// tile does not fit a 16 x 16 block, and a shifted start row breaks its
// swizzle alignment), each warp 32 pixels of the chunk into one pair of
// accumulators per tap; f32: the same structure on FMA, each half-warp 16
// of the 32 pixels, each lane a 4 x 4 micro-tile per tap.  The warps'
// partial tiles are added in shared memory in a fixed order.  Where the
// groups' tiles alone leave SMs idle the pixel sum is split into slices
// (ops/dw_split.py): each slice writes f32 partials to a workspace and
// tap_dw_reduce_kernel adds them in slice order and casts once, so there
// are no atomics and repeated calls give the same bits.  A 1x1 kernel's dw
// has no shifts: ops/block_sparse_conv.py runs it on packed_mm.cu's block
// dw kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 128;    // conv: 4 warps
constexpr int kStages = 3;       // conv: cp.async ring depth
constexpr int BM = 128;          // conv: output pixels per thread block
constexpr int BN = 16;           // conv: output channels per thread block
constexpr int BK = 16;           // conv: contraction chunk (input channels)
constexpr int kDwThreads = 256;  // dw: 8 warps
constexpr int DT = 16;           // dw: output tile is DT x DT channels
constexpr int DP = 256;          // dw: pixels per chunk, 32 per warp
constexpr int kGroupTaps = 9;    // dw: the most taps of any group
constexpr int kSparseTaps = 2;   // dw: the taps of a sparse index's groups
constexpr int kDwMaxSmem = 200 * 1024;   // dw: dynamic shared memory cap

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

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// dw: the most taps of a group (ops/block_sparse_conv.py groups the
// entries so): 9 in bf16, 4 in f32 (whose 4 x 4 micro-tile a lane keeps
// per tap would not fit 9 taps in registers); kSparseTaps in either for
// an index of about one tap per (input block, output block) pair, where
// groups share little and the kernel runs 4 thread blocks an SM instead
// of 2 (kBlocksPerSm), to keep the SMs' loads in flight with no split.
template <typename T>
constexpr int kDenseTaps = kIsBf16<T> ? 9 : 4;

__host__ __device__ constexpr int kBlocksPerSm(int taps) {
  return taps == kSparseTaps ? 4 : 2;
}

// dw: the most dynamic shared memory with which `blocks` thread blocks
// share an SM (228 KB, less 1 KB a block and the kernel's static arrays).
constexpr int smem_per_block(int blocks) {
  return 228 * 1024 / blocks - 1024 - 256;
}

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

// Shared-memory plan of the dw kernel (dynamic), per stage of its ring:
// the chunk's per-pixel tap masks, its (DP pixels x DT channels) gy tile,
// and its x tile of DP + 2 * halo pixel rows (the chunk widened by the
// largest shift on each side), rows of DT channels; in bf16 each row
// carries one 16-byte pad, so that ldmatrix reads 8 consecutive rows
// without bank conflicts (in f32 a warp reads one row at a time).  The
// per-warp f32 partial sums of the epilogue reuse the ring.
template <typename T, int TAPS>
struct DwPlan {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kLd = DT + (kIsBf16<T> ? kVec : 0);   // row stride
  static constexpr int kMaskBytes = align128(DP * 4);
  static constexpr int kGyBytes = align128(DP * kLd * sizeof(T));
  static constexpr int kWarps = kDwThreads / 32;
  // Partial tiles: one per warp in bf16, one per half-warp in f32.
  static constexpr int kParts = kIsBf16<T> ? kWarps : 2 * kWarps;
  static constexpr int kPartBytes = kParts * TAPS * DT * DT * 4;
  __host__ __device__ static constexpr int stage_bytes(int halo) {
    return kMaskBytes + kGyBytes +
           align128((DP + 2 * halo) * kLd * static_cast<int>(sizeof(T)));
  }
  __host__ __device__ static constexpr int bytes(int halo, int stages) {
    return stages * stage_bytes(halo) > kPartBytes
               ? stages * stage_bytes(halo)
               : kPartBytes;
  }
  static_assert(DP == 32 * kWarps, "a warp takes 32 pixels of a chunk");
  static_assert(DP == kDwThreads, "a thread masks one pixel of a chunk");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices, each transposed on the way: lanes 8i .. 8i+7 give
// the row addresses of matrix i, whose fragment lands in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_16816(float* c, const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dW of tap group g = blockIdx.x -- the entries ptr[g] .. ptr[g+1]-1, at
// most TAPS, all of input block rblks[g] and output block cblks[g],
// entry e of tap taps[e] with its block at dw + ooffs[e] (rows o_ld apart)
// -- on the DT x DT tile blockIdx.y of the block (rows r0.. of the input
// block, columns c0.. of the output block), over the pixels of slice
// blockIdx.z, [z * slice_rows, min(M, (z + 1) * slice_rows)).  x is (M,
// cin), gy (M, cout), M = N*H*W pixels in NHWC order; halo = W * (kh / 2)
// + kw / 2.  With ws null (one slice) it writes each entry's tile, cast
// once; with ws, the f32 partial tiles (TAPS of them, unused ones
// unwritten) of (slice, group, tile).  Chunks stream through a ring of
// STAGES stages in dynamic shared memory (DwPlan).
template <typename T, int STAGES, int TAPS>
__global__ void __launch_bounds__(kDwThreads, kBlocksPerSm(TAPS))
    tap_dw_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                  const int* __restrict__ ptr, const int* __restrict__ rblks,
                  const int* __restrict__ cblks,
                  const int* __restrict__ taps,
                  const int* __restrict__ ooffs, T* __restrict__ dw,
                  float* __restrict__ ws, int M, int H, int W, int cin,
                  int cout, int kh, int kw, int bk, int bn, int o_ld,
                  int slice_rows, int halo) {
  using L = DwPlan<T, TAPS>;
  constexpr int kVec = L::kVec, kCopies = DT / kVec;   // 16-byte copies/row
  extern __shared__ __align__(128) unsigned char dw_smem[];
  constexpr int kTaps = TAPS;
  __shared__ int s_dy[kGroupTaps], s_dx[kGroupTaps], s_shift[kGroupTaps];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = blockIdx.x;
  const int e0 = ptr[g], nt = ptr[g + 1] - e0;
  const int tiles_c = (bn + DT - 1) / DT;
  const int r0 = (blockIdx.y / tiles_c) * DT;
  const int c0 = (blockIdx.y % tiles_c) * DT;
  const int xc = rblks[g] * bk + r0, gc = cblks[g] * bn + c0;
  const int p_begin = blockIdx.z * slice_rows;
  const int p_end = min(M, p_begin + slice_rows);
  const int total = (p_end - p_begin + DP - 1) / DP;
  if (tid < kTaps) {
    const int t = tid < nt ? taps[e0 + tid] : kh / 2 * kw + kw / 2;
    s_dy[tid] = t / kw - kh / 2;
    s_dx[tid] = t % kw - kw / 2;
    s_shift[tid] = s_dy[tid] * W + s_dx[tid];
  }
  __syncthreads();
  // The group's smallest and largest shift: the x rows a chunk needs are
  // p0 + lo .. p0 + DP + hi, within the halo on each side.
  int lo = s_shift[0], hi = s_shift[0];
  for (int j = 1; j < nt; ++j) {
    lo = min(lo, s_shift[j]);
    hi = max(hi, s_shift[j]);
  }
  // Thread tid masks pixel tid of each chunk (DP == kDwThreads): its image
  // row and column (mh, mw) start from one division and advance by DP
  // pixels a chunk, (sh, sw) in rows and columns, with no division.
  const int hw = H * W, step = DP % hw;
  const int sh = step / W, sw = step % W;
  int mh = ((p_begin + tid) % hw) / W, mw = (p_begin + tid) % W;

  const int stage_bytes = L::stage_bytes(halo);
  auto masks = [&](int st) {
    return reinterpret_cast<uint32_t*>(dw_smem + st * stage_bytes);
  };
  auto g_tile = [&](int st) {
    return reinterpret_cast<T*>(dw_smem + st * stage_bytes + L::kMaskBytes);
  };
  auto x_tile = [&](int st) {
    return reinterpret_cast<T*>(dw_smem + st * stage_bytes + L::kMaskBytes +
                                L::kGyBytes);
  };
  // Stage st <- chunk `it` (called for it = 0, 1, 2, ... in turn): gy rows
  // p0 .. p0 + DP (zeros past the slice), x rows p0 + lo .. p0 + DP + hi
  // (zeros outside [0, M)), and per pixel p a mask whose bit j says that
  // tap j's shifted pixel lies in the image (no bit past the slice).  A
  // shifted row that leaves the image sideways is a real pixel of the next
  // image row: the masks, not the copies, zero it.
  auto load = [&](int it, int st) {
    const int p0 = p_begin + it * DP;
    T* gs = g_tile(st);
    for (int c = tid; c < DP * kCopies; c += kDwThreads) {
      const int r = c / kCopies, cc = (c % kCopies) * kVec;
      const int p = p0 + r;
      const bool ok = p < p_end && cc < bn - c0;
      cp_async16(gs + r * L::kLd + cc,
                 ok ? gy + static_cast<size_t>(p) * cout + gc + cc : gy, ok);
    }
    T* xs = x_tile(st);
    for (int c = tid; c < (DP + hi - lo) * kCopies; c += kDwThreads) {
      const int r = c / kCopies, cc = (c % kCopies) * kVec;
      const int p = p0 + lo + r;
      const bool ok = p >= 0 && p < M && cc < bk - r0;
      cp_async16(xs + r * L::kLd + cc,
                 ok ? x + static_cast<size_t>(p) * cin + xc + cc : x, ok);
    }
    uint32_t bits = 0;
    if (p0 + tid < p_end) {
      for (int j = 0; j < nt; ++j) {
        const int hh = mh + s_dy[j], ww = mw + s_dx[j];
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) bits |= 1u << j;
      }
    }
    masks(st)[tid] = bits;
    mw += sw;   // to the same thread's pixel of chunk it + 1
    mh += sh + (mw >= W);
    if (mw >= W) mw -= W;
    if (mh >= H) mh -= H;
  };

  // Accumulators, per tap j of the group.  bf16: the warp's two m16n8k16
  // accumulators (output columns 0-7 and 8-15): acc[j][4h + v] is row
  // lane / 4 + 8 (v / 2), column 8 h + 2 (lane % 4) + v % 2.  f32: lane
  // (rr, cq) = (4 ((lane % 16) / 4), 4 (lane % 4)) of half-warp lane / 16
  // owns a 4 x 4 micro-tile: acc[j][4 a + b] is row rr + a, column cq + b.
  constexpr int kAcc = kIsBf16<T> ? 8 : 16;
  float acc[kTaps][kAcc];
#pragma unroll
  for (int j = 0; j < kTaps; ++j)
#pragma unroll
    for (int v = 0; v < kAcc; ++v) acc[j][v] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();   // chunk `it` has landed (this thread)
    __syncthreads();   // ... every thread's, with its masks; stage it-1 free
    const int next = it + STAGES - 1;
    if (next < total) load(next, next % STAGES);
    cp_async_commit();
    const uint32_t* mk = masks(it % STAGES);
    const T* gs = g_tile(it % STAGES);
    const T* xs = x_tile(it % STAGES);
    if constexpr (kIsBf16<T>) {
      // The warp's 32 pixels, 16 at a time.  A = the shifted x rows
      // transposed (channels x pixels), B = the gy rows (pixels x
      // channels): both stored pixel-major, so ldmatrix transposes.
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int pix = 32 * warp + 16 * ks;
        uint32_t b[4];
        ldmatrix_x4_trans(b, gs + (pix + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                      L::kLd +
                                  (lane >> 4) * 8);
        // This lane's pixels (the k of its A fragment): 2t, 2t+1 (a[0],
        // a[1]) and 2t+8, 2t+9 (a[2], a[3]).
        const int q = pix + 2 * (lane % 4);
        const uint32_t m0 = mk[q], m1 = mk[q + 1], m2 = mk[q + 8],
                       m3 = mk[q + 9];
        const T* a_rows =
            xs + (pix + (lane & 7) + (lane >> 4) * 8 - lo) * L::kLd +
            ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          if (j < nt) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, a_rows + s_shift[j] * L::kLd);
            const uint32_t k01 = (((m0 >> j) & 1) ? 0x0000FFFFu : 0u) |
                                 (((m1 >> j) & 1) ? 0xFFFF0000u : 0u);
            const uint32_t k23 = (((m2 >> j) & 1) ? 0x0000FFFFu : 0u) |
                                 (((m3 >> j) & 1) ? 0xFFFF0000u : 0u);
            a[0] &= k01;
            a[1] &= k01;
            a[2] &= k23;
            a[3] &= k23;
            mma_16816(acc[j], a, b[0], b[1]);
            mma_16816(acc[j] + 4, a, b[2], b[3]);
          }
        }
      }
    } else {
      // Half-warp lane / 16 takes every other pixel of the warp's 32.
      const int rr = 4 * ((lane % 16) / 4), cq = 4 * (lane % 4);
      for (int i = 32 * warp + lane / 16; i < 32 * warp + 32; i += 2) {
        const uint32_t bits = mk[i];
        // Rows are 64-byte aligned and rr, cq multiples of 4: one float4
        // of gy's four values, one float4 of x's four per tap.
        const float4 gv = *reinterpret_cast<const float4*>(
            reinterpret_cast<const float*>(gs) + i * L::kLd + cq);
        const float* xrow =
            reinterpret_cast<const float*>(xs) + (i - lo) * L::kLd + rr;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          if (j < nt) {
            float4 xv = *reinterpret_cast<const float4*>(
                xrow + s_shift[j] * L::kLd);
            if (!((bits >> j) & 1)) xv = make_float4(0.f, 0.f, 0.f, 0.f);
            const float a4[4] = {xv.x, xv.y, xv.z, xv.w};
            const float b4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < 4; ++b) acc[j][4 * a + b] += a4[a] * b4[b];
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: it holds the partial tiles now

  // The partial tiles, part[k][j] (DT x DT, row-major; k the warp in bf16,
  // the half-warp in f32), summed over k in order.
  float* part = reinterpret_cast<float*>(dw_smem);
  const int producer = kIsBf16<T> ? warp : 2 * warp + lane / 16;
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    if (j < nt) {
      float* pw = part + (producer * kTaps + j) * DT * DT;
#pragma unroll
      for (int v = 0; v < kAcc; ++v) {
        int r, c;
        if constexpr (kIsBf16<T>) {
          r = lane / 4 + 8 * ((v % 4) / 2);
          c = 8 * (v / 4) + 2 * (lane % 4) + v % 2;
        } else {
          r = 4 * ((lane % 16) / 4) + v / 4;
          c = 4 * (lane % 4) + v % 4;
        }
        pw[r * DT + c] = acc[j][v];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nt * DT * DT; idx += kDwThreads) {
    const int j = idx / (DT * DT), rc = idx % (DT * DT);
    const int r = rc / DT, c = rc % DT;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < L::kParts; ++k)
      sum += part[(k * kTaps + j) * DT * DT + rc];
    if (ws)
      ws[((static_cast<size_t>(blockIdx.z) * gridDim.x + g) * gridDim.y +
          blockIdx.y) *
             (kTaps * DT * DT) +
         idx] = sum;
    else if (r < bk - r0 && c < bn - c0)
      dw[ooffs[e0 + j] + static_cast<size_t>(r0 + r) * o_ld + c0 + c] =
          from_float<T>(sum);
  }
}

// The partial tiles of every (group, tile) in the `slices` slices,
// ws[z][g][tile][j] (DT x DT each, j < TAPS), added in slice order
// and cast once into each entry's block, masked to the block.  One thread
// an output, grid-strided over all groups and tiles.
template <typename T, int TAPS>
__global__ void __launch_bounds__(256)
    tap_dw_reduce_kernel(const float* __restrict__ ws,
                         const int* __restrict__ ptr,
                         const int* __restrict__ ooffs, T* __restrict__ dw,
                         int slices, int n_groups, int tiles, int bk, int bn,
                         int o_ld) {
  constexpr int kTile = TAPS * DT * DT;
  const size_t total = static_cast<size_t>(n_groups) * tiles * kTile;
  const int tiles_c = (bn + DT - 1) / DT;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int idx = static_cast<int>(i % kTile);
    const int t = static_cast<int>((i / kTile) % tiles);
    const int g = static_cast<int>(i / (static_cast<size_t>(kTile) * tiles));
    const int j = idx / (DT * DT), rc = idx % (DT * DT);
    const int e0 = ptr[g];
    if (j >= ptr[g + 1] - e0) continue;
    const int r = (t / tiles_c) * DT + rc / DT;
    const int c = (t % tiles_c) * DT + rc % DT;
    if (r >= bk || c >= bn) continue;
    float sum = ws[i];
    for (int z = 1; z < slices; ++z) sum += ws[z * total + i];
    dw[ooffs[e0 + j] + static_cast<size_t>(r) * o_ld + c] = from_float<T>(sum);
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

// Above 48 KB, dynamic shared memory must be allowed per kernel and device:
// once for each (instantiation, device), not on every launch.  The dw
// kernel's need depends on the image width (its halo), so it is allowed up
// to kDwMaxSmem once and each launch checks its own size against that.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<uint64_t>& allowed) {
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
  return cudaSuccess;
}

// The dw kernel at STAGES stages, its dynamic shared memory allowed once
// per (instantiation, device) up to kDwMaxSmem.
template <typename T, int STAGES, int TAPS>
cudaError_t launch_dw_stages(const void* x, const void* gy, const int* ptr,
                             const int* rblks, const int* cblks,
                             const int* taps, const int* ooffs, void* dw,
                             float* ws, int M, int H, int W, int cin,
                             int cout, int n_groups, int tiles, int kh,
                             int kw, int bk, int bn, int o_ld, int slices,
                             int slice_rows, int halo, cudaStream_t stream) {
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  cudaError_t err =
      allow_smem(tap_dw_kernel<T, STAGES, TAPS>, kDwMaxSmem, allowed);
  if (err != cudaSuccess) return err;
  tap_dw_kernel<T, STAGES, TAPS><<<dim3(n_groups, tiles, slices), kDwThreads,
                                   DwPlan<T, TAPS>::bytes(halo, STAGES),
                                   stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), ptr, rblks, cblks,
      taps, ooffs, static_cast<T*>(dw), slices > 1 ? ws : nullptr, M, H, W,
      cin, cout, kh, kw, bk, bn, o_ld, slice_rows, halo);
  return cudaGetLastError();
}

// The deepest ring (4, 3 or 2 stages) with which kBlocksPerSm(TAPS) thread
// blocks share an SM, else 2 stages on fewer; then, with more than one
// slice, tap_dw_reduce_kernel over every output, at most 8 blocks an SM.
template <typename T, int TAPS>
cudaError_t launch_dw(const void* x, const void* gy, const int* ptr,
                      const int* rblks, const int* cblks, const int* taps,
                      const int* ooffs, void* dw, float* ws, int M, int H,
                      int W, int cin, int cout, int n_groups, int kh, int kw,
                      int bk, int bn, int o_ld, int slices, int slice_rows,
                      cudaStream_t stream) {
  using L = DwPlan<T, TAPS>;
  const int halo = W * (kh / 2) + kw / 2;
  const int budget = smem_per_block(kBlocksPerSm(TAPS));
  int stages = 4;
  while (stages > 2 && L::bytes(halo, stages) > budget) --stages;
  if (L::bytes(halo, stages) > kDwMaxSmem) return cudaErrorInvalidValue;
  const int tiles = ((bk + DT - 1) / DT) * ((bn + DT - 1) / DT);
  auto launch = stages == 4   ? launch_dw_stages<T, 4, TAPS>
                : stages == 3 ? launch_dw_stages<T, 3, TAPS>
                              : launch_dw_stages<T, 2, TAPS>;
  cudaError_t err =
      launch(x, gy, ptr, rblks, cblks, taps, ooffs, dw, ws, M, H, W, cin,
             cout, n_groups, tiles, kh, kw, bk, bn, o_ld, slices, slice_rows,
             halo, stream);
  if (err != cudaSuccess || slices == 1) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long outputs =
      static_cast<long long>(n_groups) * tiles * TAPS * DT * DT;
  const int blocks =
      static_cast<int>(std::min<long long>((outputs + 255) / 256, 8LL * sms));
  tap_dw_reduce_kernel<T, TAPS><<<blocks, 256, 0, stream>>>(
      ws, ptr, ooffs, static_cast<T*>(dw), slices, n_groups, tiles, bk, bn,
      o_ld);
  return cudaGetLastError();
}

// The kernel whose group size is max_taps: kDenseTaps<T> or kSparseTaps.
template <typename T>
cudaError_t launch_dw_taps(int max_taps, const void* x, const void* gy,
                           const int* ptr, const int* rblks, const int* cblks,
                           const int* taps, const int* ooffs, void* dw,
                           float* ws, int M, int H, int W, int cin, int cout,
                           int n_groups, int kh, int kw, int bk, int bn,
                           int o_ld, int slices, int slice_rows,
                           cudaStream_t stream) {
  if (max_taps == kDenseTaps<T>)
    return launch_dw<T, kDenseTaps<T>>(x, gy, ptr, rblks, cblks, taps, ooffs,
                                       dw, ws, M, H, W, cin, cout, n_groups,
                                       kh, kw, bk, bn, o_ld, slices,
                                       slice_rows, stream);
  if (max_taps == kSparseTaps)
    return launch_dw<T, kSparseTaps>(x, gy, ptr, rblks, cblks, taps, ooffs,
                                     dw, ws, M, H, W, cin, cout, n_groups, kh,
                                     kw, bk, bn, o_ld, slices, slice_rows,
                                     stream);
  return cudaErrorInvalidValue;
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

// dW of the active entries, in tap groups: group g holds entries ptr[g] ..
// ptr[g+1]-1 (at most max_taps: 9 in bf16 or 4 in f32, or 2 for a sparse
// index), all of input block rblks[g] and output block cblks[g], entry e
// the tap taps[e] and the (bk x bn) block at dw + ooffs[e] (rows o_ld
// apart) = the sum over pixels of x (M, cin) at the tap's shift, times gy
// (M, cout); f32 sums, one cast.  The pixel sum runs in `slices` slices of
// `slice_rows` pixels (the last may be shorter); with slices > 1, `ws` is
// an f32 workspace of slices * n_groups * tiles * max_taps * 16 * 16
// elements (ops/block_sparse_conv.py, tap_dw_plan) and a second kernel
// adds the partials in slice order.
extern "C" int tap_dw(const void* x, const void* gy, const void* ptr,
                      const void* rblks, const void* cblks, const void* taps,
                      const void* ooffs, void* dw, void* ws, int M, int H,
                      int W, int cin, int cout, int n_groups, int kh, int kw,
                      int bk, int bn, int o_ld, int max_taps, int slices,
                      int slice_rows, int dtype, void* stream) {
  if (M <= 0 || n_groups <= 0 || H <= 0 || W <= 0 || slices <= 0 ||
      slice_rows <= 0 || (slices > 1 && !ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(ptr);
  const int* rb = static_cast<const int*>(rblks);
  const int* cb = static_cast<const int*>(cblks);
  const int* tp = static_cast<const int*>(taps);
  const int* of = static_cast<const int*>(ooffs);
  float* w = static_cast<float*>(ws);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch_dw_taps<__nv_bfloat16>(max_taps, x, gy, p, rb, cb, tp, of,
                                        dw, w, M, H, W, cin, cout, n_groups,
                                        kh, kw, bk, bn, o_ld, slices,
                                        slice_rows, st);
  else if (dtype == 0)
    err = launch_dw_taps<float>(max_taps, x, gy, p, rb, cb, tp, of, dw, w, M,
                                H, W, cin, cout, n_groups, kh, kw, bk, bn,
                                o_ld, slices, slice_rows, st);
  return static_cast<int>(err);
}

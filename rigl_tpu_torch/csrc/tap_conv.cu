// Block-sparse stride-1 SAME convolution of NHWC activations over the active
// (tap, input-block, output-block) entries of a KxK kernel, and its weight
// gradient on those entries only:
//
//   forward, behind `tap_conv_fwd`:
//       y[p, j-block] = sum over column j's entries (t, r) of
//                       x[p + shift(t), r-block] @ W[t][r-block, j-block];
//   dx, behind `tap_conv_dx`: the same sum with the taps flipped (t' =
//       T-1-t), gy as input and each W block read transposed:
//       dx[q, r-block] = sum gy[q + shift(t'), j] @ W[t][r, j]ᵀ;
//   dw, behind `tap_dw`: tap_dw_kernel<T, STAGES, TAPS> (with
//       tap_dw_reduce_kernel where the pixel sum is split):
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
// activations stay NHWC and unpadded, and each kernel copies the shifted
// input tiles itself with 16-byte cp.asyncs that zero-fill the pixels whose
// shifted position leaves the image (implicit GEMM).  Each output tile is
// written once, so there are no atomics and no second pass, and any batch
// size works (the TPU kernel's N % 16 rule is a Mosaic alignment matter).
//
// The forward and dx run the branch that ops/block_sparse_conv.py
// `tap_branch` names (dispatch_conv refuses a branch that cannot take the
// call):
//   mm (a 1x1 kernel, either dtype): no shifts, so the conv is a block-
//     sparse matmul over the pixels; the wrapper runs packed_mm.cu's forward
//     / dx kernels on the index's lists and this library is not called.
//   wgmma (bf16, KxK, bk and bn multiples of 16): tap_conv_wgmma_kernel<N,
//     kTrans, kGroups>.  One thread block of two warpgroups per (128 output
//     pixels, output tile of N <= 128 channels; the caller names N,
//     ops/block_sparse_conv.py tap_wgmma_tile), heaviest first.  A tile
//     covers one output block-column (several tiles where it is wider than
//     128), or, where blocks are at most 64 wide and it pays
//     (tap_wgmma_gcols), a group of block-columns (kGroups): the group walks
//     the union of its columns' (tap, input block) entries, each shifted x
//     tile copied once for all of them and multiplied, 16 columns a wgmma
//     (A from registers), into the columns that hold the entry only.  The entries are a stream
//     of 16-channel k-steps; each ring stage holds 4 of them: a 128 x 64
//     shifted x tile (several entries, each at its own shift, where blocks
//     are 16 or 32 wide) and the matching 64 x N piece of W, copied by every
//     thread with zero-filling cp.asyncs into the swizzled layouts wgmma
//     reads (x K-major with 128-byte swizzle, a warp's copies on whole
//     128-byte rows; W MN-major in the forward, with 128-byte swizzle at N
//     >= 64 without groups and 32-byte otherwise; W K-major in dx, the
//     stored block read transposed in place).  A stage
//     completes on its mbarrier once every thread's copies have landed (and
//     are fenced to the async proxy); each warpgroup then runs wgmma
//     m64nNk16 on its 64 rows, f32 in registers, while the stage freed by
//     the previous products takes the next copies.  The epilogue is staged
//     in the ring and stored in 16-byte pieces, masked to real pixels and
//     the tile's channels.
//   tf32 (f32, KxK): tap_w_split_kernel<kTrans> copies every entry's
//     block K-major (the forward's transposed) as hi / lo halves for
//     error-compensated TF32, then tap_conv_3xtf32_kernel<N, kGroups>, an
//     implicit GEMM on wgmma in 3xTF32 (a b = a_hi b_hi + a_hi b_lo + a_lo
//     b_hi, hi = a as the tensor cores read it truncated): one thread block
//     of two warpgroups and a copying warp per (128 output pixels, output
//     tile of N <= 128 channels: one block-column, or at blocks of 16 a
//     group of two, ops/block_sparse_conv.py tap_tf32_tile), heaviest
//     first.  A group's entries run in (input block, tap) order, in
//     panels of one input block and 16 of its channels: the panel's x
//     tile, 128 pixel rows widened by the panel's shifts (within the halo,
//     W (kh / 2) + kw / 2 rows a side; taps split by tap row where that is
//     too large), is copied once by TMA and is the register A operand of
//     every tap of the panel at its row offset, the shifted pixels outside
//     the image predicated to zero in the fragment loads.  W's hi / lo
//     tiles (B) come by TMA, one box a block, into a 4-deep ring of 2
//     entries a stage; the copying warp walks a stage table the host
//     builds once per index.
//   wmma (bf16, KxK, a block of 8s that 16 does not divide):
//     tap_conv_kernel<kTrans>, BM = 128 pixels x BN = 16 channels a thread
//     block (one per 16-channel subtile of a column), a 3-deep cp.async
//     ring of 16-channel chunks, WMMA 16x16x16.
//
// What bounds them on an H100: a bf16 call is bound by bytes: x is read
// from L2 once per entry of each output tile (its shifted copy for that
// tap), and y written once, against a bound that reads x once; at blocks
// of 16 an entry is a (128 x 16) @ (16 x N) product, so the copies of x,
// about 2.4 TB/s from L2 at RN50's block-16 shapes, bound it, which the
// column groups cut where entries overlap.  The f32 branch is bound by the
// bytes of x and y at WRN-22-2's shapes and by the 3xTF32 rate (a third of
// the 495 TFLOP/s tf32 peak) at RN50's first; in practice by issue: a
// tf32 wgmma costs about as much to issue at 16 columns as at 32, and at
// blocks of 16 an entry is a 16- or 32-column product, so the kernel
// merges a_hi b_hi and a_hi b_lo into one product twice as wide; and by
// the copies of x from L2, once per input block of each output tile (not
// once per entry), which column groups share.  dW has few
// outputs (a layer's active blocks) and one long sum each, so it is bound
// by how many SMs the sum is spread over and, then, by the bytes of x and
// gy it reads.
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
#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;    // wmma conv: 4 warps
constexpr int kStages = 3;       // wmma conv: cp.async ring depth
constexpr int BM = 128;          // wmma conv: output pixels per thread block
constexpr int BN = 16;           // wmma conv: output channels per block
constexpr int BK = 16;           // wmma conv: contraction chunk
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

// The same with the shared-memory destination as its address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* gmem,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0));
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

// Shared-memory plan of tap_conv_kernel (bf16, blocks of 8s): a ring of (x
// tile, W tile) pairs.  The x tile is (BM x BK), row-major; the W tile (BK x
// BN) row-major, or for dx the stored (BN x BK) region of the block, read as
// its transpose.  Each row carries one 16-byte pad: rows stay 16-byte
// aligned for cp.async and WMMA's fragment loads spread over the banks.
template <bool kTrans>
struct ConvPlan {
  using T = __nv_bfloat16;
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kAld = BK + kVec;
  static constexpr int kBRows = kTrans ? BN : BK;
  static constexpr int kBld = (kTrans ? BK : BN) + kVec;
  static constexpr int kABytes = align128(BM * kAld * sizeof(T));
  static constexpr int kBBytes = align128(kBRows * kBld * sizeof(T));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOld = BN + 4;   // f32 staging of the epilogue
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kBytes =
      kRingBytes > BM * kOld * 4 ? kRingBytes : BM * kOld * 4;
  static_assert(kBytes + 2 * BM * 4 <= 48 * 1024, "static shared memory");
};

// y (M, cy) from x (M, cx), M = N*H*W pixels in NHWC order, bf16.  Output
// block-column g walks entries [ptr[g], ptr[g+1]): entry e reads input block
// kblks[e] (width bk) at the shift of taps[e], and the weight block at w +
// woffs[e], whose rows are `w_ld` apart: (bk x bn) row-major, or with
// kTrans the (bn x bk) block it is the transpose of.  bn is the output
// block width.
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
    tap_conv_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const int* __restrict__ ptr, const int* __restrict__ taps,
                    const int* __restrict__ kblks,
                    const int* __restrict__ woffs,
                    __nv_bfloat16* __restrict__ y, int M, int H, int W,
                    int cx, int cy, int kh, int kw, int bk, int bn,
                    int w_ld) {
  using T = __nv_bfloat16;
  using L = ConvPlan<kTrans>;
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

  // Accumulators: warp `wid` owns rows [32 wid, +32) as two 16x16 WMMA
  // fragments.
  using namespace nvcuda;
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Frag frag[2];
  const int wid = tid / 32;
  wmma::fill_fragment(frag[0], 0.f);
  wmma::fill_fragment(frag[1], 0.f);

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
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: it becomes the epilogue's staging

  const int row_lim = M - m0, col_lim = bn - n0;
  T* out = y + static_cast<size_t>(m0) * cy + static_cast<size_t>(g) * bn + n0;
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
}

// ---- tap_conv_wgmma_kernel (bf16, KxK, blocks of 16s) -----------------------
// Four 8 x 8 b16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8: with rows 0-15 of a 16 x 16 tile at lanes
// 0-15 (columns 0-7) and 16-31 (columns 8-15), the mma / wgmma A fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

constexpr int kWgRows = 128;            // output pixels per thread block
constexpr int kWgK = 64;                // contraction per ring stage
constexpr int kWgSteps = kWgK / 16;     // k-steps of 16 a stage
constexpr int kWgThreads = 256;         // two warpgroups; all load, all multiply
constexpr int kWgABytes = kWgRows * kWgK * 2;   // 16 KB: 128 rows of 128 bytes

// Shared-memory plan of tap_conv_wgmma_kernel at an output tile N channels
// wide: a ring of kStages stages, each the 128 x 64 shifted x tile (A,
// K-major, 128-byte swizzle) and the 64 x N piece of W (B); then one
// mbarrier a stage; then a stage's column masks (8 bytes, a byte a warp;
// column groups only).  Three stages, four at N = 64: two thread blocks an SM at N >= 64,
// three or four below, whose thread blocks have less work.
template <int N>
struct WgPlan {
  static constexpr int kStages = N == 64 ? 4 : 3;
  static constexpr int kBBytes = kWgK * N * 2;
  static constexpr int kStageBytes = kWgABytes + kBBytes;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 16 * kStages;
  // The epilogue's bf16 staging row: N + 8 values, so that a warp's
  // fragment stores (8 rows x 4 pairs) fall on 32 distinct banks.
  static constexpr int kStageLd = N + 8;
  static_assert(kStageBytes % 1024 == 0, "stages start 1024-byte aligned");
  static_assert(kWgRows * kStageLd * 2 <= kStages * kStageBytes,
                "the staging tile fits in the ring");
  static_assert(2 * kSmem <= 227 * 1024, "two thread blocks an SM");
};

// Thread block (tile, m-tile): output pixels m0 .. m0 + 127 and channels
// n0 .. n0 + N - 1 of the output block-columns of group G = order[blockIdx.x
// / tiles] (columns G gcols .. G gcols + gcols - 1, see ops/block_sparse_
// conv.py TapGroupLists): the f32 sum over G's entries u in [ptr[G],
// ptr[G+1]) of x[p + shift(taps[u]), kblks[u]-block] @ the W block of
// each column c of the group at w + woffs[u gcols + c] (seg x out_w, rows
// w_ld apart; with kTrans the stored out_w x seg block read transposed;
// zeros where woffs is -1).  The entries are walked as a stream of
// k-steps of 16 channels (entry u, channels k0 .. k0 + 15); a stage holds
// 4 of them, so that with blocks of 16 or 32 a stage carries 4 or 2
// entries, each at its own shift.  Every thread copies its part of a
// stage with 16-byte cp.asyncs that zero-fill what lies outside: the x
// chunks of pixels whose shifted position leaves the image (SAME padding)
// or lies past M, W's columns past the group or of a column without the
// entry, and the k-steps past the group's last entry.
//   A group of several columns (kGroups) copies each shifted x tile once
// for all of them and multiplies it, 16 columns a wgmma (m64n16k16, x
// from registers: ldmatrix once a stage), only into the columns that hold
// the k-step's entry; the others' products are predicated off.  The
// stage's column masks come with its copies: each warp ORs the columns
// whose W its lanes copied (bit c for column c of the group) into a byte,
// two warps a k-step.  So each column sums its own entries only, and a
// non-finite value in an input block that a column does not read stays
// out of it, as in the plain version.
//   A (x): row r = pixel m0 + r, 128 bytes; chunk c at c ^ (r % 8).
//   B forward (W block rows = contraction, MN-major): N >= 64 and one
//     column a tile, 64-column blocks of 64 rows x 128 bytes, 8 KB apart,
//     chunk c of row k at c ^ (k % 8); else 16-column blocks of 64 rows x
//     32 bytes, 2 KB apart, chunk c of row k at c ^ ((k / 4) % 2).
//   B dx (the stored block's rows = output channels, K-major): row n, 128
//     bytes, chunk c at c ^ (n % 8), as A.
template <int N, bool kTrans, bool kGroups>
__global__ void __launch_bounds__(kWgThreads, 2)
    tap_conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const int* __restrict__ ptr,
                          const int* __restrict__ taps,
                          const int* __restrict__ kblks,
                          const int* __restrict__ woffs,
                          const int* __restrict__ order,
                          __nv_bfloat16* __restrict__ y, int M, int H, int W,
                          int cx, int cy, int kh, int kw, int seg, int out_w,
                          int w_ld, int gcols) {
  using L = WgPlan<N>;
  constexpr int S = L::kStages;
  constexpr bool kSw128 = N >= 64 && !kGroups;   // forward W's layout
  extern __shared__ unsigned char wg_smem[];
  const int tid = threadIdx.x;
  const int tiles = (gcols * out_w + N - 1) / N;
  const int g = order[blockIdx.x / tiles];
  const int n0 = (blockIdx.x % tiles) * N;
  const int m0 = blockIdx.y * kWgRows;
  const int g0 = g * gcols * out_w;                     // the group's channels
  const int width = min(gcols * out_w, cy - g0);       // g0 .. g0 + width
  const int e_begin = ptr[g];
  const int spe = seg / 16;                         // k-steps an entry
  const int ksteps = (ptr[g + 1] - e_begin) * spe;
  const int total = (ksteps + kWgSteps - 1) / kWgSteps;   // stages

  const uint32_t base = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t full = base + S * L::kStageBytes;
  unsigned char* const masks = wg_smem + (full + 8 * S - smem_u32(wg_smem));
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full + 8 * s, kWgThreads);
    mbar_fence_init();
  }
  __syncthreads();

  // What a thread copies, the same in every stage: chunk xc of pixel rows
  // xr + 32 j (j < 4) of the x tile -- k-step xc / 2 of the stage, so that
  // a warp's copies cover 4 whole 128-byte rows -- and chunks z = zl + 64 j
  // of k-step zi of the W piece (2N chunks a k-step; consecutive threads
  // on consecutive chunks of a row).  Each walks its k-step's (entry,
  // k-step of the entry) with a cursor that advances 4 k-steps a stage,
  // so no division runs per stage.  A row past M gets a row no shift
  // brings back inside.
  const int xc = tid % 8, xr = tid / 8;
  int ph[4], pw[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = m0 + xr + 32 * j;
    ph[j] = p < M ? (p / W) % H : -(1 << 20);
    pw[j] = p < M ? p % W : 0;
  }
  const uint32_t x_dst = xr * 128 + ((xc ^ (xr & 7)) << 4);
  constexpr int kWz = (2 * N + 63) / 64;   // W chunks a thread, at most
  const int zi = tid / 64, zl = tid % 64;
  int wcol[kWz], wrel[kWz];   // the chunk's column of the group (-1: none)
  uint32_t wdst[kWz];         // and element offset in the column's block
#pragma unroll
  for (int j = 0; j < kWz; ++j) {
    const int z = zl + 64 * j;
    int krem, n;              // row of the k-step, channel of the tile
    if constexpr (kTrans) {
      n = z / 2;
      krem = 8 * (z % 2);
      wdst[j] = n * 128 + (((2 * zi + z % 2) ^ (n & 7)) << 4);
    } else {
      krem = z / (N / 8);
      const int cc = z % (N / 8), kr = 16 * zi + krem;
      n = 8 * cc;
      wdst[j] = kSw128 ? (cc / 8) * 8192 + kr * 128 +
                              (((cc % 8) ^ (kr & 7)) << 4)
                        : (cc / 2) * 2048 + kr * 32 +
                              (((cc % 2) ^ ((kr >> 2) & 1)) << 4);
    }
    const int q = n0 + n;     // the group's channel
    const bool in = z < 2 * N && q < width;
    wcol[j] = in ? q / out_w : -1;
    wrel[j] = kTrans ? (q % out_w) * w_ld + krem : krem * w_ld + q % out_w;
  }
  // Cursors: entry e and k-step k of the entry for k-step 4 it + i.
  const int q4 = kWgSteps / spe, r4 = kWgSteps % spe;
  int xe = e_begin + (xc / 2) / spe, xk = (xc / 2) % spe;
  int we = e_begin + zi / spe, wk = zi % spe;
  const int e_end = ptr[g + 1];

  // Stage s <- the next stage's k-steps (called for stages 0, 1, 2, ...).
  auto load = [&](int s) {
    const uint32_t a = base + s * L::kStageBytes;
    const uint32_t b = a + kWgABytes;
    int dy = -(1 << 20), dx = 0;   // past the last entry: zeros
    const __nv_bfloat16* col = x;
    if (xe < e_end) {
      const int tap = taps[xe];
      dy = tap / kw - kh / 2;
      dx = tap % kw - kw / 2;
      col = x + kblks[xe] * seg + xk * 16 + (xc % 2) * 8;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = xr + 32 * j;
      const bool ok =
          static_cast<unsigned>(ph[j] + dy) < static_cast<unsigned>(H) &&
          static_cast<unsigned>(pw[j] + dx) < static_cast<unsigned>(W);
      const __nv_bfloat16* src =
          ok ? col + static_cast<size_t>(m0 + r + dy * W + dx) * cx : x;
      cp_async16(a + x_dst + 4096 * j, src, ok);
    }
    const size_t k_off = static_cast<size_t>(16 * wk) * (kTrans ? 1 : w_ld);
    unsigned bits = 0;   // the group columns whose W this thread copies
#pragma unroll
    for (int j = 0; j < kWz; ++j) {
      if (zl + 64 * j >= 2 * N) break;
      const int off = wcol[j] >= 0 && we < e_end
                          ? woffs[we * gcols + wcol[j]]
                          : -1;
      const bool ok = off >= 0;
      cp_async16(b + wdst[j], ok ? w + off + wrel[j] + k_off : w, ok);
      if (kGroups && ok) bits |= 1u << wcol[j];
    }
    if constexpr (kGroups) {
      // The columns that hold k-step zi's entry: warps 2 zi and 2 zi + 1
      // copy its W, a byte each.
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (tid % 32 == 0)
        masks[8 * s + tid / 32] = static_cast<unsigned char>(bits);
    }
    xk += r4;
    xe += q4 + (xk >= spe);
    xk -= xk >= spe ? spe : 0;
    wk += r4;
    we += q4 + (wk >= spe);
    wk -= wk >= spe ? spe : 0;
  };

  const int wg = tid / 128;   // this warpgroup's 64 rows of the tile
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // kGroups: the mask bit of the group column that 16-column slice i of
  // the tile lies in (0 past the group); and where this lane's ldmatrix
  // reads the x tile: row 64 wg + 16 (warp % 4) + lane % 16, the k-step's
  // chunk (lane / 16) of 8 channels, swizzled as the copies wrote it.
  unsigned slice_bit[N / 16];
#pragma unroll
  for (int i = 0; i < N / 16; ++i)
    slice_bit[i] = n0 + 16 * i < width ? 1u << ((n0 + 16 * i) / out_w) : 0u;
  const int a_row = 64 * wg + 16 * ((tid / 32) % 4) + tid % 16;
  const int a_half = (tid % 32) / 16;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    const int s = it % S;
    // This thread's copies into stage s have landed; made visible to the
    // async proxy that wgmma reads through, they complete its share of the
    // stage's barrier, whose phase completes once every thread's have.
    cp_async_wait<S - 2>();
    fence_proxy_async();
    mbar_arrive(full + 8 * s);
    mbar_wait(full + 8 * s, (it / S) & 1);
    // The stage's column masks.
    const unsigned long long mask =
        kGroups ? *reinterpret_cast<const unsigned long long*>(masks + 8 * s)
                : 0ull;
    // Every thread has passed iteration it - 1, products included: its
    // stage takes the loads of it + S - 1 while these products run.
    const int next = it + S - 1;
    if (next < total) load(next % S);
    cp_async_commit();
    const uint32_t a = base + s * L::kStageBytes;   // x tile: 128 rows
    const uint32_t b = a + kWgABytes;
    // kGroups: the x tile's fragments in registers, read once for the
    // group's products (wgmma reads them until the wait below).
    uint32_t frag[kGroups ? kWgSteps : 1][4];
    if constexpr (kGroups) {
#pragma unroll
      for (int k = 0; k < kWgSteps; ++k)
        ldmatrix_x4(frag[k], a + a_row * 128 +
                                 (((2 * k + a_half) ^ (a_row & 7)) << 4));
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgSteps; ++k) {
      if constexpr (kGroups) {
        // 16 columns a product, into the columns that hold the entry.
#pragma unroll
        for (int i = 0; i < N / 16; ++i) {
          const uint64_t db =
              kTrans ? wgmma_desc(b + 2048 * i + 32 * k, 16)
                     : wgmma_desc_sw32(b + 2048 * i + 512 * k, 2048);
          wgmma_m64n16k16_rs_if<kTrans ? 0 : 1>(
              *reinterpret_cast<float(*)[8]>(acc + 8 * i), frag[k], db,
              static_cast<unsigned>((mask >> (16 * k)) |
                                    (mask >> (16 * k + 8))) &
                  slice_bit[i]);
        }
      } else {
        const uint64_t da =
            wgmma_desc(a + wg * (kWgABytes / 2) + 32 * k, 16);
        uint64_t db;
        if constexpr (kTrans)
          db = wgmma_desc(b + 32 * k, 16);
        else if constexpr (kSw128)
          db = wgmma_desc(b + 2048 * k, 8192);
        else
          db = wgmma_desc_sw32(b + 512 * k, 2048);
        wgmma_ss<N, 0, kTrans ? 0 : 1>(acc, da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: it becomes the staging tile

  // acc[4j + 2h + v] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane
  // % 4) + v of the warpgroup's 64 x N result; cast once to bf16.
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
      wg_smem + (base - smem_u32(wg_smem)));
  const int lane = tid % 32;
  const int row = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8 * h) * L::kStageLd +
                                         8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncthreads();
  // 16 bytes a thread, masked to real pixels (rows < M) and the group's
  // channels (width - n0 is a multiple of 16: 8 channels are in or out).
  const int rows = M - m0, cols = width - n0;
  __nv_bfloat16* out = y + static_cast<size_t>(m0) * cy + g0 + n0;
  for (int i = tid; i < kWgRows * N / 8; i += kWgThreads) {
    const int rr = i / (N / 8), c = 8 * (i % (N / 8));
    if (rr < rows && c < cols)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(rr) * cy + c) =
          *reinterpret_cast<const uint4*>(stage + rr * L::kStageLd + c);
  }
}

// ---- tap_conv_3xtf32_kernel (f32, KxK) ---------------------------------------
constexpr int kTfRows = 128;       // output pixels per thread block
constexpr int kTfConsumers = 256;  // two warpgroups multiply
constexpr int kTfThreads = kTfConsumers + 32;   // and one warp copies
constexpr int kTfStages = 4;       // W ring stages; as many x tiles
constexpr int kTfChunk = 16;       // input channels of an x tile (64 bytes)
constexpr int kTfEntries = 2;      // entries a stage, 2 k-steps of 8 each
constexpr int kTfBoxRows = 64;     // pixel rows of a TMA box of an x tile
constexpr int kTfFlush = 32;       // stages between flushes of the sum to y
constexpr int kTfRow = 32;         // ints a stage's row: one a lane
constexpr int kTfMaxSmem = 227 * 1024;
// The most pixel rows of an x tile (ops/block_sparse_conv.py
// TAP_TF32_XROWS: past it a panel's taps are split by tap row).
constexpr int kTfMaxXRows = 512;

// Shared-memory plan of tap_conv_3xtf32_kernel at an output tile N channels
// wide, whose x tiles hold `xrows` pixel rows: kTfStages W stages, each of
// kTfEntries entries, each entry 2 N rows of its 16 contraction values
// (K-major, 64-byte swizzle, as TMA writes them): one column, the tile's
// hi rows then its lo rows; a group, column c's 16 hi rows at 32 c and its
// lo rows after them; kTfStages x tiles of xrows rows (whole boxes) of
// kTfChunk channels, 64 bytes a row as TMA writes them (a quarter-warp's
// 16-byte fragment loads read two consecutive rows, 32 distinct banks,
// whatever row a shift starts at); each stage's entry records (16 bytes
// each); a full and an empty mbarrier a stage.
template <int N>
struct TfPlan {
  static constexpr int kBTile = N * 64;
  static constexpr int kWBytes = kTfEntries * 2 * kBTile;
  static_assert(kBTile % 1024 == 0, "B tiles start 1024-byte aligned");
  static constexpr int x_bytes(int xrows) {
    return (xrows + kTfBoxRows - 1) / kTfBoxRows * kTfBoxRows * 64;
  }
  static constexpr int smem(int xrows) {
    return 1024 + kTfStages * (kWBytes + x_bytes(xrows) + kTfEntries * 16 +
                               16);
  }
};

// The f32 channel of x that k-step kk's contraction index k (0-7) of a
// 16-channel chunk takes: thread q = lane % 4 of a quad loads channels 4 q
// .. 4 q + 3 of its row in one 16-byte load and takes them as its tf32 A
// fragment's values k = q and q + 4 of k-step 0 (channels 4 q, 4 q + 1)
// and of k-step 1 (4 q + 2, 4 q + 3); W's copy puts the same channels at
// those contraction indices.
__host__ __device__ constexpr int tf_channel(int kk, int k) {
  return 4 * (k % 4) + 2 * kk + k / 4;
}

// The K-major hi / lo copy of the weight blocks the tf32 branch reads: row
// e out_w + n of wt (hi) and of wt + lo_rows segp (lo), segp floats each,
// holds output channel n of entry e's block (woffs[e], rows w_ld apart):
// chunk c's 16 values in contraction order, 8 kk + k the block's channel
// 16 c + tf_channel(kk, k) (zero past seg); hi = the f32 value (the tensor
// cores read it truncated), lo = the value less that truncation
// (tf32_split).  The forward's block (seg x out_w, output channels along
// its rows) is read transposed; dx's stored block (out_w x seg) as it is.
// One thread block an entry, and one more (e = n_ent) writing a block of
// zeros, which the kernel copies for a column without the entry.
template <bool kTrans>
__global__ void __launch_bounds__(256)
    tap_w_split_kernel(const float* __restrict__ w,
                       const int* __restrict__ woffs, float* __restrict__ wt,
                       int n_ent, int lo_rows, int seg, int segp, int out_w,
                       int w_ld) {
  const int e = blockIdx.x;
  float* hi = wt + static_cast<size_t>(e) * out_w * segp;
  for (int i = threadIdx.x; i < out_w * segp; i += blockDim.x) {
    const int n = i / segp, l = i % segp;
    const int k = (l / kTfChunk) * kTfChunk +
                  tf_channel((l % kTfChunk) / 8, l % 8);
    float v = 0.f;
    if (e < n_ent && k < seg)
      v = w[woffs[e] + (kTrans ? static_cast<size_t>(n) * w_ld + k
                               : static_cast<size_t>(k) * w_ld + n)];
    uint32_t h, l32;
    tf32_split(v, h, l32);
    hi[i] = __uint_as_float(h);
    hi[static_cast<size_t>(lo_rows) * segp + i] = __uint_as_float(l32);
  }
}

// Thread block (tile, m-tile): output pixels m0 .. m0 + 127 (m-tile
// m_base + blockIdx.y) and channels n0 .. n0 + N - 1 of the output
// block-columns of group G = order[blockIdx.x / tiles] (columns G gcols ..
// G gcols + gcols - 1; ops/block_sparse_conv.py TapPanelLists), in f32:
// y = the sum over G's entries, for each column of the group that holds
// the entry, of the shifted x block @ the entry's W block.  G's entries
// run in (input block, tap) order, in panels of one input block and
// kTfChunk of its channels, kTfEntries a stage (a panel
// starts a stage): stage rows sptr[G] .. sptr[G+1]-1 of `stab`, kTfRow
// ints each (TapPanelLists.stab): 0-4 the panel's x channel, its smallest
// shift lo, its x tile's TMA boxes (the panel's first stage, else 0), 0
// and the chunk's offset k0 in the block; 8 + 4 e ..: entry e's record
// (byte offset of its shifted row 0 in the panel's x tile, dy << 16 | dx
// & 0xFFFF, column mask, channel quads; a slot past the panel's entries
// reads nothing); 8 + 4 kTfEntries + e gcols + c: the row in the W copy of
// column c's block of entry e (the zero block where the column lacks it).
// A panel's x tile -- pixel rows m0 + lo .. of those channels, 128 plus
// the span of its shifts -- is copied once, in TMA boxes with its first
// stage, into x tile (its rank in G) % kTfStages, and every entry of the
// panel reads it at row offset shift - lo: the taps of an input block
// share one copy of x.  A shifted pixel that leaves its image (above,
// below, or sideways into the next image row) reads as zero by a
// predicated load of its fragment; rows outside [0, M) TMA fills with
// zeros.
//   Warp specialised.  The copying warp runs up to kTfStages stages ahead
// of the products: lane l holds int l of a stage's row, loaded a stage
// ahead; lanes 8 .. write the entry records, lane 0 sets the stage's
// bytes on its full barrier, lanes 0 .. copy the x boxes and the W lanes
// their block's hi and lo rows (one column: the tile's rows, the zero
// block past the panel's entries; kGroups: each column that holds the
// entry, the others none); it reuses a stage once both warpgroups have
// released it.  Each warpgroup takes 64 rows: per stage, its A fragments
// (x, one 16-byte load a row and entry: both k-steps, tf_channel) are
// split into hi / lo in registers, and per k-step a_hi (b_hi | b_lo) --
// the lo rows follow the hi ones, so one product twice the width, into a
// second half of the sum -- and a_lo b_hi run into the f32 sum in
// registers.
// kGroups: each column's products run only where it holds the entry
// (predicated), so a column sums its own entries only and a non-finite x
// reaches only the columns that read it.  The roles and the predicates
// are broadcast from lane 0, so that ptxas sees them uniform over the
// warpgroup: it serialises a wgmma on a path it cannot (C7520).  The
// tensor cores' f32 accumulation drops low bits, which adds up over a
// long sum: every kTfFlush stages (beyond any layer of the repo's models
// at blocks of 16) the sum is added into y in f32 and starts afresh.  The
// epilogue stores the tile from registers, 8 bytes a thread, masked to
// real pixels and the group's channels.
template <int N, bool kGroups>
__global__ void __launch_bounds__(kTfThreads, N <= 32 ? 2 : 1)
    tap_conv_3xtf32_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const int* __restrict__ sptr,
                           const int* __restrict__ order,
                           const int* __restrict__ stab,
                           float* __restrict__ y, int M, int H, int W,
                           int cy, int out_w, int gcols, int x_bytes,
                           int lo_rows, int m_base) {
  using P = TfPlan<N>;
  constexpr int S = kTfStages, E = kTfEntries;
  extern __shared__ unsigned char tf_smem[];
  const int tid = threadIdx.x, lane = tid % 32;
  const int tiles = (gcols * out_w + N - 1) / N;
  const int g = order[blockIdx.x / tiles];
  const int n0 = (blockIdx.x % tiles) * N;
  const int m0 = (m_base + blockIdx.y) * kTfRows;
  const int s_begin = sptr[g];
  const int total = sptr[g + 1] - s_begin;           // stages

  const uint32_t base = (smem_u32(tf_smem) + 1023) & ~1023u;
  const uint32_t xs = base + S * P::kWBytes;
  const uint32_t meta = xs + S * x_bytes;
  const uint32_t full = meta + S * E * 16, empty = full + 8 * S;
  unsigned char* const gbase = tf_smem + (base - smem_u32(tf_smem));
  // B tile rows no box writes (past a narrow column's block) stay zeros;
  // a group's column without the entry keeps a former stage's rows, its
  // products predicated off.
  for (int i = tid; i < S * P::kWBytes / 16; i += kTfThreads)
    reinterpret_cast<int4*>(gbase)[i] = make_int4(0, 0, 0, 0);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kTfConsumers);
    }
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();

  // The roles by warp, its index broadcast so that ptxas sees them
  // uniform: a wgmma on a path it cannot prove uniform over the warpgroup
  // (this branch, a predicate) is serialised (C7520).
  if (__shfl_sync(0xffffffffu, tid / 32, 0) >= kTfConsumers / 32) {
    // The copying warp.  A stage's W boxes: per entry and hi / lo, one a
    // column of the group (kGroups) or the tile's rows of the one column.
    // x tile pc % S takes the group's pc-th panel.
    const int box_rows = min(out_w, N);
    const int w_lane = 8 + 4 * E;   // lanes w_lane + e gcols + c: W rows
    if (lane == 0) {
      prefetch_tensormap(&tx);
      prefetch_tensormap(&tw);
    }
    int pc = -1;
    int row = total > 0 ? stab[s_begin * kTfRow + lane] : 0;
    for (int it = 0; it < total; ++it) {
      const int s = it % S;
      const int next =
          it + 1 < total ? stab[(s_begin + it + 1) * kTfRow + lane] : 0;
      if (it >= S) mbar_wait(empty + 8 * s, (it / S - 1) & 1);
      const int ch0 = __shfl_sync(0xffffffffu, row, 0);
      const int lo = __shfl_sync(0xffffffffu, row, 1);
      const int nbox = __shfl_sync(0xffffffffu, row, 2);
      const int k0 = __shfl_sync(0xffffffffu, row, 4);
      pc += nbox > 0;
      const int xoff = (pc % S) * x_bytes;
      const uint32_t fb = full + 8 * s;
      if (lane >= 8 && lane < w_lane)
        reinterpret_cast<int*>(gbase + (meta - base))[s * E * 4 + lane - 8] =
            row + ((lane - 8) % 4 == 0 ? xoff : 0);
      // W lane b: entry b / gcols, column b % gcols.  kGroups: no copy
      // where the column lacks the entry (its products are predicated
      // off); one column: every slot's (the zero block past the panel).
      const int b = lane - w_lane;
      const bool w_box = b >= 0 && b < E * gcols &&
                         (kGroups ? row != lo_rows - out_w : b % gcols == 0);
      const int n_w = __popc(__ballot_sync(0xffffffffu, w_box));
      __syncwarp();   // the records, then the arrival that releases them
      if (lane == 0)
        mbar_expect_tx(fb, nbox * kTfBoxRows * 64 + n_w * 2 * box_rows * 64);
      __syncwarp();
      if (lane < nbox)
        tma_load(xs + xoff + lane * kTfBoxRows * 64, &tx, ch0,
                 m0 + lo + lane * kTfBoxRows, fb);
      if (w_box) {
        // kGroups: column c's hi rows, then its lo rows; one column: the
        // tile's hi rows, then its lo rows.
        const int e = b / gcols, c = b % gcols;
        const uint32_t dst = base + s * P::kWBytes + 2 * e * P::kBTile +
                             (kGroups ? 2 * c * out_w * 64 : 0);
        const int r = row + (kGroups ? 0 : n0);
        tma_load(dst, &tw, k0, r, fb);
        tma_load(dst + (kGroups ? out_w * 64 : P::kBTile), &tw, k0,
                 r + lo_rows, fb);
      }
      row = next;
    }
    return;
  }

  // The consumers.  This thread's rows of its warpgroup's 64 (the A
  // fragment's and the accumulator's: 16 warp + lane / 4 + 8 h) and where
  // its 16-byte fragment loads start in an x tile (channels 4 (lane % 4)
  // ..).
  const int wg = tid / 128;
  int rb[2];
  uint32_t at[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rb[h] = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4 + 8 * h;
    at[h] = xs + rb[h] * 64 + (lane & 3) * 16;
  }
  const int4* const meta_p =
      reinterpret_cast<const int4*>(gbase + (meta - base));
  const int g0 = g * gcols * out_w;                  // the group's channels
  const int width = min(gcols * out_w, cy - g0);    // g0 .. g0 + width
  // The rows' pixels (h, w); a row past M gets a row no shift brings
  // inside.
  int ph[2], pw[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = m0 + rb[h];
    ph[h] = p < M ? (p / W) % H : -(1 << 20);
    pw[h] = p < M ? p % W : 0;
  }
  // a_hi (b_hi | b_lo) is one product twice the width (the lo B rows
  // follow the hi ones), its second half added to the first in f32 at the
  // end; a_lo b_hi goes into the first.  One column: the tile's, the
  // second half at acc[N / 2 ..].  kGroups: per 16-column block-column c,
  // acc[16 c .. 16 c + 15], the second half from 16 c + 8.
  float acc[N];
  float(&sum)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(acc);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  bool flushed = false;
  const int rows = M - m0, cols = width - n0;
  float* out = y + static_cast<size_t>(m0) * cy + g0 + n0;
  // Row rb[h], columns 8 j + 2 (lane % 4) + v of the tile: y there +=
  // the sum, or = it before the first flush (8 bytes a store; width - n0
  // is a multiple of 4: a pair is in or out).
  auto add_into_y = [&]() {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * (lane & 3);
        if (rb[h] < rows && c < cols) {
          float2* o = reinterpret_cast<float2*>(
              out + static_cast<size_t>(rb[h]) * cy + c);
          const int i = kGroups ? 16 * (j / 2) + 4 * (j % 2) + 2 * h
                                : 4 * j + 2 * h;
          const int i2 = i + (kGroups ? 8 : N / 2);
          float2 v = make_float2(acc[i] + acc[i2], acc[i + 1] + acc[i2 + 1]);
          if (flushed) {
            const float2 before = *o;
            v.x += before.x;
            v.y += before.y;
          }
          *o = v;
        }
      }
  };

  for (int it = 0; it < total; ++it) {
    const int s = it % S;
    mbar_wait(full + 8 * s, (it / S) & 1);
    // The stage's A fragments: per entry and row, 4 channels.
    float v[E][2][4];
    unsigned mk[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int4 m = meta_p[s * E + e];
      // The entry's column mask, broadcast: uniform to ptxas.
      mk[e] = __shfl_sync(0xffffffffu, static_cast<unsigned>(m.z), 0);
      const int dy = m.y >> 16, dx = static_cast<short>(m.y & 0xFFFF);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool in =
            static_cast<unsigned>(ph[h] + dy) < static_cast<unsigned>(H) &&
            static_cast<unsigned>(pw[h] + dx) < static_cast<unsigned>(W) &&
            (lane & 3) < m.w;
        ld_shared_v4_if(at[h] + m.x, in, v[e][h]);
      }
    }
    // k-step kk of entry e: a[h + 2 j] = channel 4 (lane % 4) + 2 kk + j.
    uint32_t hi[E][2][4], lo[E][2][4];
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tf32_split(v[e][h][2 * kk + j], hi[e][kk][h + 2 * j],
                       lo[e][kk][h + 2 * j]);
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        fence_regs(hi[e][kk]);
        fence_regs(lo[e][kk]);
      }
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t bh = base + s * P::kWBytes + 2 * e * P::kBTile +
                            32 * kk;
        if constexpr (kGroups) {
          // Column c's hi and lo rows: 2 KB from 2 c KB, its products
          // only where it holds the entry.
#pragma unroll
          for (int c = 0; c < N / 16; ++c) {
            const uint64_t d = wgmma_desc_sw64(bh + 2048 * c);
            float(&a32)[16] = *reinterpret_cast<float(*)[16]>(acc + 16 * c);
            float(&a16)[8] = *reinterpret_cast<float(*)[8]>(acc + 16 * c);
            wgmma_tf32_rs_if<32>(a32, hi[e][kk], d, (mk[e] >> c) & 1);
            wgmma_tf32_rs_if<16>(a16, lo[e][kk], d, (mk[e] >> c) & 1);
          }
        } else {
          wgmma_tf32_rs<2 * N>(acc, hi[e][kk], wgmma_desc_sw64(bh));
          wgmma_tf32_rs<N>(sum, lo[e][kk], wgmma_desc_sw64(bh));
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);   // this thread is done with stage s
    const bool flush = (it + 1) % kTfFlush == 0 && it + 1 < total;
    if (flush) {
      add_into_y();
      flushed = true;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = flush ? 0.f : acc[i];
  }
  add_into_y();
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

// Arguments common to every forward / dx launch, in the kernel's terms: the
// input x (M, cx) and the output y (M, cy = ncols * out_w); each entry's
// contraction is `seg` channels (bk forward, bn dx) and its weight block
// (seg x out_w, or with kTrans the stored out_w x seg) has rows w_ld apart.
struct ConvArgs {
  const void* x;
  const void* w;
  const int* ptr;
  const int* taps;
  const int* kblks;
  const int* woffs;
  const int* order;   // wgmma, tf32: the column groups, longest first
  const int* stab;    // tf32: the stage table (TapPanelLists.stab)
  const int* ewoffs;  // tf32: every entry's block offset in w
  void* wt;           // tf32: room for the blocks' K-major hi / lo copy
  void* y;
  int M, H, W, cx, cy, ncols, kh, kw, seg, out_w, w_ld;
  int gcols;          // wgmma, tf32: the output block-columns a group holds
  int tile;           // wgmma, tf32: the output tile's channels (its N)
  int xrows;          // tf32: the pixel rows of the largest x tile
  int n_entries;      // tf32: the entries of ewoffs
  cudaStream_t stream;
};

template <bool kTrans>
cudaError_t launch_conv(const ConvArgs& a) {
  dim3 grid((a.M + BM - 1) / BM, a.ncols * ((a.out_w + BN - 1) / BN));
  tap_conv_kernel<kTrans><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w), a.ptr, a.taps, a.kblks,
      a.woffs, static_cast<__nv_bfloat16*>(a.y), a.M, a.H, a.W, a.cx, a.cy,
      a.kh, a.kw, a.seg, a.out_w, a.w_ld);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<uint64_t>& allowed, int carveout = -1);

template <int N, bool kTrans, bool kGroups>
cudaError_t launch_conv_wgmma(const ConvArgs& a) {
  const int m_tiles = (a.M + kWgRows - 1) / kWgRows;
  if (m_tiles > 65535 || !a.order) return cudaErrorInvalidValue;
  auto kernel = tap_conv_wgmma_kernel<N, kTrans, kGroups>;
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  cudaError_t err = allow_smem(kernel, WgPlan<N>::kSmem, allowed,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int groups = (a.ncols + a.gcols - 1) / a.gcols;
  const dim3 grid(groups * ((a.gcols * a.out_w + N - 1) / N), m_tiles);
  kernel<<<grid, kWgThreads, WgPlan<N>::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x),
      static_cast<const __nv_bfloat16*>(a.w), a.ptr, a.taps, a.kblks,
      a.woffs, a.order, static_cast<__nv_bfloat16*>(a.y), a.M, a.H, a.W,
      a.cx, a.cy, a.kh, a.kw, a.seg, a.out_w, a.w_ld, a.gcols);
  return cudaGetLastError();
}

// The instance of output tile N: column groups (gcols > 1) or not.
template <int N, bool kTrans>
cudaError_t launch_tile(const ConvArgs& a) {
  if constexpr (N == 16) {
    return launch_conv_wgmma<16, kTrans, false>(a);   // no room for a group
  } else {
    return a.gcols > 1 ? launch_conv_wgmma<N, kTrans, true>(a)
                       : launch_conv_wgmma<N, kTrans, false>(a);
  }
}

// The wgmma branch at the output tile the caller names (ops/block_sparse_
// conv.py tap_wgmma_tile; the tiles are the cases below); blocks (seg and
// out_w) must be multiples of 16, and a group of several columns, at most
// 8 (a byte of mask bits), must fit in one tile.
template <bool kTrans>
cudaError_t launch_wgmma(const ConvArgs& a) {
  if (a.seg % 16 || a.out_w % 16 || a.seg <= 0 || a.out_w <= 0 ||
      a.gcols <= 0 || a.gcols > 8 ||
      (a.gcols > 1 && a.gcols * a.out_w > a.tile))
    return cudaErrorInvalidValue;
  switch (a.tile) {
    case 16: return launch_tile<16, kTrans>(a);
    case 32: return launch_tile<32, kTrans>(a);
    case 48: return launch_tile<48, kTrans>(a);
    case 64: return launch_tile<64, kTrans>(a);
    case 128: return launch_tile<128, kTrans>(a);
    default: return cudaErrorInvalidValue;
  }
}

// tap_conv_3xtf32_kernel at output tile N, its dynamic shared memory
// allowed once per (instance, device) up to kTfMaxSmem and sized for the
// call's largest x tile (at most kTfMaxXRows rows, which every tile's plan
// fits).  The groups' tiles run along x, so that the thread blocks that
// run together share their pixel tiles' x in L2, the m-tiles along y, in
// launches of at most 65535.
template <int N, bool kGroups>
cudaError_t launch_tf32_tile(const ConvArgs& a, const CUtensorMap& tx,
                             const CUtensorMap& tw, int m_tiles,
                             int lo_rows) {
  static_assert(TfPlan<N>::smem(kTfMaxXRows) <= kTfMaxSmem,
                "the largest x tile fits shared memory at this tile");
  const int groups = (a.ncols + a.gcols - 1) / a.gcols;
  const long long gtiles =
      static_cast<long long>(groups) * ((a.gcols * a.out_w + N - 1) / N);
  if (gtiles > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = tap_conv_3xtf32_kernel<N, kGroups>;
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  cudaError_t err = allow_smem(kernel, kTfMaxSmem, allowed,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int smem = TfPlan<N>::smem(a.xrows);
  for (int m = 0; m < m_tiles; m += 65535) {
    const dim3 grid(static_cast<unsigned>(gtiles),
                    static_cast<unsigned>(std::min(m_tiles - m, 65535)));
    kernel<<<grid, kTfThreads, smem, a.stream>>>(
        tx, tw, a.ptr, a.order, a.stab, static_cast<float*>(a.y), a.M, a.H,
        a.W, a.cy, a.out_w, a.gcols, TfPlan<N>::x_bytes(a.xrows), lo_rows,
        m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The tf32 branch: tap_w_split_kernel makes the K-major hi / lo copy of
// every entry's block and a block of zeros (forward: transposed), then
// tap_conv_3xtf32_kernel runs at the output tile the caller names
// (ops/block_sparse_conv.py tap_tf32_tile; the tiles are the cases below)
// over TapPanelLists' stages (ptr: the groups' stage rows, stab: the
// stage table), x and the copy read by TMA.  Blocks must be multiples of
// 4; tile 32 takes groups of two 16-wide columns, tiles 16 and 64 one
// column (a wider one in several tiles).  wt holds 2 (n_entries + 1)
// out_w segp floats, segp = seg rounded up to 16.
template <bool kTrans>
cudaError_t launch_tf32(const ConvArgs& a) {
  const int m_tiles = (a.M + kTfRows - 1) / kTfRows;
  if (a.seg % 4 || a.out_w % 4 || a.seg <= 0 || a.out_w <= 0 ||
      a.gcols <= 0 || !a.order || !a.wt || a.xrows < kTfRows ||
      a.xrows > kTfMaxXRows || a.n_entries < 0 ||
      (a.gcols > 1 && (a.out_w != 16 || a.gcols * a.out_w > a.tile ||
                       a.tile != 32)))
    return cudaErrorInvalidValue;
  if (a.n_entries > 0 && (!a.ewoffs || !a.stab))
    return cudaErrorInvalidValue;
  const int segp = (a.seg + kTfChunk - 1) / kTfChunk * kTfChunk;
  const long long lo_rows = static_cast<long long>(a.n_entries + 1) * a.out_w;
  if (2 * lo_rows * segp >= (1LL << 31)) return cudaErrorInvalidValue;
  tap_w_split_kernel<kTrans><<<a.n_entries + 1, 256, 0, a.stream>>>(
      static_cast<const float*>(a.w), a.ewoffs, static_cast<float*>(a.wt),
      a.n_entries, static_cast<int>(lo_rows), a.seg, segp, a.out_w, a.w_ld);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // x as (M rows, cx channels), boxes of 64 rows x 16 channels, no
  // swizzle; the copy as (2 lo_rows rows, segp), boxes of a column's rows
  // (at most the tile's) x 16, 64-byte swizzle.
  CUtensorMap tx, tw;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(a.cx),
                               static_cast<cuuint64_t>(a.M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(a.cx) * 4};
  const cuuint32_t xbox[2] = {kTfChunk, kTfBoxRows};
  err = f32_map_nd(&tx, a.x, 2, xdims, xstride, xbox,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(segp),
                               static_cast<cuuint64_t>(2 * lo_rows)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(segp) * 4};
  const cuuint32_t wbox[2] = {kTfChunk, static_cast<cuuint32_t>(
                                            std::min(a.out_w, a.tile))};
  err = f32_map_nd(&tw, a.wt, 2, wdims, wstride, wbox,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return err;
  const int lo = static_cast<int>(lo_rows);
  switch (a.tile) {
    case 16:
      return a.gcols > 1 ? cudaErrorInvalidValue
                         : launch_tf32_tile<16, false>(a, tx, tw, m_tiles, lo);
    case 32:
      return a.gcols > 1 ? launch_tf32_tile<32, true>(a, tx, tw, m_tiles, lo)
                         : cudaErrorInvalidValue;
    case 64:
      return a.gcols > 1 ? cudaErrorInvalidValue
                         : launch_tf32_tile<64, false>(a, tx, tw, m_tiles, lo);
    default: return cudaErrorInvalidValue;
  }
}

// The branches, in the order of ops/block_sparse_conv.py TAP_BRANCHES.  The
// caller names one by the rule of tap_branch there:
//   mm:    a 1x1 kernel -- not here: the wrapper runs packed_mm.cu's
//          forward / dx kernels, so this library refuses it;
//   wgmma: bf16, KxK, blocks of 16s -- tap_conv_wgmma_kernel;
//   tf32:  f32, KxK -- tap_w_split_kernel, then tap_conv_3xtf32_kernel;
//   wmma:  bf16, KxK, a block of 8s that 16 does not divide --
//          tap_conv_kernel.
// A branch that cannot take the call (another dtype, blocks the tiles do
// not divide, more than 65535 m-tiles) is refused with
// cudaErrorInvalidValue; no other branch is tried.
enum TapBranch { kTapMm = 0, kTapWgmma = 1, kTapTf32 = 2, kTapWmma = 3 };

template <bool kTrans>
int dispatch_conv(const ConvArgs& a, int branch, int dtype) {
  if (a.M <= 0 || a.ncols <= 0 || a.H <= 0 || a.W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (branch) {
    case kTapWgmma:
      if (dtype == 1) err = launch_wgmma<kTrans>(a);
      break;
    case kTapTf32:
      if (dtype == 0) err = launch_tf32<kTrans>(a);
      break;
    case kTapWmma:
      if (dtype == 1) err = launch_conv<kTrans>(a);
      break;
  }
  return static_cast<int>(err);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel and device:
// once for each (instantiation, device), not on every launch; `carveout`
// (percent of the unified L1 / shared memory) is set with it where given.
// The dw kernel's need depends on the image width (its halo), so it is
// allowed up to kDwMaxSmem once and each launch checks its own size
// against that.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<uint64_t>& allowed, int carveout) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (!(allowed.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && carveout >= 0)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
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
// `branch`: dispatch_conv's TapBranch, named by the caller.  The wgmma
// branch reads the lists of the output block-columns in groups of gcols
// (ops/block_sparse_conv.py TapGroupLists: ptr over the groups, woffs
// gcols a entry, -1 where a column lacks it) and `order`, the groups
// longest first, in output tiles of `tile` channels; the tf32 branch
// TapPanelLists' stages (ptr, order, stab; see launch_tf32) with ewoffs
// (the n_entries blocks' offsets in w), wt (room for their copy) and the
// largest x tile's rows; wmma the column lists (gcols 1; the rest unused).
extern "C" int tap_conv_fwd(const void* x, const void* w, const void* ptr,
                            const void* taps, const void* kblks,
                            const void* woffs, const void* order,
                            const void* stab, const void* ewoffs, void* wt,
                            void* y, int M,
                            int H, int W, int cx, int ncols, int kh, int kw,
                            int bk, int bn, int w_ld, int gcols, int tile,
                            int xrows, int n_entries, int branch, int dtype,
                            void* stream) {
  return dispatch_conv<false>(
      {x, w, static_cast<const int*>(ptr), static_cast<const int*>(taps),
       static_cast<const int*>(kblks), static_cast<const int*>(woffs),
       static_cast<const int*>(order), static_cast<const int*>(stab),
       static_cast<const int*>(ewoffs), wt,
       y, M, H, W, cx, ncols * bn, ncols, kh, kw, bk, bn, w_ld, gcols, tile,
       xrows, n_entries, static_cast<cudaStream_t>(stream)},
      branch, dtype);
}

// The same with each weight block read transposed: the block at w + woffs[e]
// is stored (bn x bk), rows w_ld apart (dx: gy in, flipped taps).
extern "C" int tap_conv_dx(const void* gy, const void* w, const void* ptr,
                           const void* taps, const void* kblks,
                           const void* woffs, const void* order,
                           const void* stab, const void* ewoffs, void* wt,
                           void* dx, int M,
                           int H, int W, int cx, int ncols, int kh, int kw,
                           int bk, int bn, int w_ld, int gcols, int tile,
                           int xrows, int n_entries, int branch, int dtype,
                           void* stream) {
  return dispatch_conv<true>(
      {gy, w, static_cast<const int*>(ptr), static_cast<const int*>(taps),
       static_cast<const int*>(kblks), static_cast<const int*>(woffs),
       static_cast<const int*>(order), static_cast<const int*>(stab),
       static_cast<const int*>(ewoffs), wt,
       dx, M, H, W, cx, ncols * bn, ncols, kh, kw, bk, bn, w_ld, gcols, tile,
       xrows, n_entries, static_cast<cudaStream_t>(stream)},
      branch, dtype);
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

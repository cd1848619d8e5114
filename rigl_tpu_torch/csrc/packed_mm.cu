// Packed block-sparse matmul and its gradients, with W stored as its active
// (bk, bn) blocks, packed (n_active, bk, bn) in column-major order.  Tiled
// kernels for any m, in bf16 or f32:
//
//   the mm kernels, kTransW = false behind `packed_mm_fwd`: y = x @ W;
//       kTransW = true behind `packed_mm_dx`: dx = gy @ Wᵀ.  Four branches
//       (dispatch_mm): packed_mm_wgmma_kernel (bf16), packed_mm_ffma_kernel
//       (f32), and packed_mm_kernel at m <= 32 and for a bf16 contraction
//       that 64 does not divide.
//   the dw kernels                  behind `packed_dw`:
//       dw[s] = x[:, rows[s]*bk : +bk]ᵀ @ gy[:, cols[s]*bn : +bn]:
//       packed_dw_wgmma_kernel (bf16) or packed_dw_ffma_kernel (f32), and
//       packed_dw_reduce_kernel where the m-sum is split.
//
// Replaces the TPU kernels of rigl_tpu/ops/pallas/block_sparse_packed.py:
// `_mm_kernel` (launched by `_mm_call`, transpose_w=False for the forward,
// transpose_w=True through the bwd packing for dx) and `_dw_kernel` /
// `_dw_panel_kernel` (launched by `_dw_call`).  Same results: every output
// block-column is the f32 sum over its active blocks, cast once to the
// output type; a block-column with no active block comes out as zeros; dw
// sums over m in f32 and casts once into the packed slot.
//
// What bounds them on an H100: at decode (m = 8 rows) each weight byte feeds
// about 8 multiply-adds, far below the ~295 flop/byte where bf16 tensor
// cores become the limit, so decode is weight-bandwidth-bound; at training
// and prefill sizes (m = 1024) all three products are compute-bound.  The
// products of a few large blocks over many rows (ResNet-50's 1x1 convs: 2-19
// blocks of 128 x 128 over 6272-401408 rows) are bound by the bytes of x,
// gy and y.
//
// The mm kernels.  One thread block per (subtile of one output
// block-column, m-tile), column subtiles fastest, so the thread blocks in
// flight share their x rows in L2.  Each walks that column's actives from a
// CSR -- for the forward the per-column list (col_ptr, rows), for dx the
// per-block-row list (row_ptr, cols, slots) of the bwd packing -- and,
// inside each active, the contraction in chunks, accumulating in registers;
// then writes its tile once.  Nothing carries across thread blocks, so no
// atomics, no second pass, and the same bits on every call.  The caller
// names the branch by the rule of ops/block_sparse_packed.py `mm_branch`;
// dispatch_mm refuses a branch that cannot take the call:
//
//   wgmma (bf16, m > 32, 64 divides the contraction per active, `seg` =
//     bk forward, bn dx): packed_mm_wgmma_kernel.  128 x 128 output tiles,
//     two thread blocks an SM.  One producer warp fills a 3-deep ring by
//     TMA; each stage is one (active, 64-deep chunk): a 128 x 64 box of x
//     at (column seg_idx[a] * seg + k0, row m0), K-major with 128-byte
//     swizzle, and the W block's part, through a 4-D tensor map over W
//     viewed as (block-row, row, block-column, column) -- packed storage is
//     (n_active, bk, 1, bn) -- so that a box never reads past its block:
//     rows and columns outside it come in as zeros.  Forward: two 64 x 64
//     boxes (rows k0.., columns n0.. and n0 + 64..), B in MN-major layout;
//     dx: one 128 x 64 box (rows n0.., columns k0..), B in K-major layout,
//     so Wᵀ is never built.  Two consumer warpgroups, 64 rows each, run
//     wgmma m64n128k16 with f32 in registers, one stage's products in
//     flight while the next are issued; the epilogue casts the fragments
//     to bf16 into shared memory (the ring's, once both warpgroups are
//     done) and stores whole 16-byte groups, masked to rows < m and columns
//     < the block's width.  Rows of x past m come in as zeros.  Two thread
//     blocks an SM, each a 3-deep ring (6 stages in flight an SM), so one
//     block's epilogue and first loads overlap the other's products.
//   ffma (f32, m > 32): packed_mm_ffma_kernel, on the CUDA cores with no
//     TF32.  64 x 128 tiles on 128 threads, four thread blocks an SM, 8 x 8
//     outputs a thread from register micro-tiles: the x chunk (transposed)
//     and the W chunk go through registers into a double-buffered 8-deep
//     shared tile, and each k reads 8 values of each into registers for 64
//     fmaf.  The uneven per-column active counts of a sparse layer make
//     the longest columns' thread blocks the critical path: 64-row tiles
//     spread each column over twice as many of them.  Each output is
//     one fmaf chain over the actives in list order and k ascending, the
//     order of packed_mm_kernel, so the two give the same bits.
//   decode (m <= 32, either dtype) and tiled (bf16, m > 32, a contraction
//     that 64 does not divide): packed_mm_kernel, WMMA (bf16) or scalar FMA
//     (f32) on tiles that stream through a 3-deep cp.async ring, with a
//     barrier a step.  For dx the (output-subtile x contraction-chunk)
//     region of the W block is copied row-major and read by WMMA as a
//     col_major matrix_b.  At m <= 32 (one m-tile) the tiles are 32 x 32
//     with contraction steps of 256 (128 in f32): few, long steps, because
//     at decode each thread block's serial chain of steps, not the loads,
//     bounds it (PERF.md, section 6).  The tiled branch takes 64 x 64 x 32
//     tiles, masked to the segment: a 64-deep box of x would read x's
//     neighbouring segment, whose products with the zero-filled rows past
//     the W block vanish only while that segment is finite.

// The dw kernels: one thread block per (entry s, output tile, slice of m).
// The m-sum is split into S slices of whole chunks when the tiles alone
// leave SMs idle (ops/dw_split.py: tiles x S fills about two waves of the
// SMs; S = 1 when the tiles fill the card, as the MLP's 208 tiles do, or
// m is under two chunks).  With S > 1 each thread block writes its f32
// partial tile to a workspace the wrapper allocates, (S, entries, tiles,
// tile), and packed_dw_reduce_kernel adds the S partials in slice order
// and casts once into the output: no atomics, so repeated calls give the
// same bits.  With S = 1 the tile is cast and stored directly.
//
// packed_dw_wgmma_kernel (bf16).  Output tiles of 128 x 128: a whole block
// at ResNet-50's block of 128, 16 tiles of a 512 block.  One producer warp
// fills a 4-deep ring of (64-row m-chunk x 128) x and gy tiles by TMA, two
// 64-column boxes each, through tensor maps over x (m, K) and gy (m, N),
// with 128-byte swizzle and an mbarrier per stage for arrival and one for
// release.  Two consumer warpgroups, 64 rows of the tile each, run wgmma
// m64n128k16 (bf16 in, f32 in registers) on the stage that arrived.  Both
// operands sit in shared memory with m, the contraction, outermost, so A =
// xᵀ and B = gy are the transposed ("MN-major") layouts wgmma accepts for
// 16-bit types and nothing is transposed in memory.  A block narrower than
// 128, or one 128 does not divide, still takes the 128-wide boxes: they
// read neighbouring columns (zeros past the matrix's edge, and past m),
// whose products land only in rows / columns the store masks.  Halves of a
// box wholly outside the block are not loaded.  The tensor-map encoder
// comes from cudaGetDriverEntryPoint, so the library links nothing beyond
// the CUDA runtime.
//
// packed_dw_ffma_kernel (f32).  64 x 64 tiles, scalar FMA with no TF32
// (the f32 checks hold it to summation order), m in chunks of 16 through a
// 3-deep cp.async ring: A = the x chunk, (m-chunk x bk-tile) row-major,
// B = the gy chunk.  It takes the same split.
//
// Dense storage.  The same kernels also read W in place as the (K, N)
// matrix of a dense-masked layer, only at its active blocks (`dense_mm_fwd`,
// `dense_mm_dx`, `dense_dw`): a block is found by its element offset
// woffs[e] and rows N apart, instead of by its packed slot and rows bn
// apart (packed_mm_wgmma_kernel turns woffs[e] into the block's
// (block-row, block-column) of its tensor map); dx reads those blocks
// transposed, as it reads packed ones, so no Wᵀ is built; dw writes each
// active block into a zeroed (K, N) output.
// These replace the TPU kernels of rigl_tpu/ops/pallas/: `_v4_kernel`
// (block_sparse_v4.py, B7: the flat column-major packing), `_v3_kernel`
// (block_sparse_v3.py, B8: per-column index lists) -- the same sums from
// two index forms, turned here into one list of entries per output
// block-column, [beg[g], end[g]) -- `_dw_v2_kernel` (block_sparse_v3.py,
// B9), whose grid over all blocks with an active flag is the flags array,
// and `_dw_kernel` (block_sparse.py, B12), the same flags over every block.
// At ResNet-50's 1x1 shapes (m = 6272 .. 401408 rows, 128 .. 2048
// channels, block 128 x 128, ERK densities) chip_smoke.py computes each
// call's bound from its bytes and its FLOPs on the active blocks.
//
// Ragged m, and bn / bk smaller than a tile, are masked in the kernels (the
// copies zero-fill), so the TPU path's row padding and its dw ValueError on
// an m no bm divides have no counterpart; the wrappers guarantee 16-byte
// aligned rows (the TMA branches check the 16-byte alignment of every base
// and row stride, and refuse the call otherwise).  The TPU kernels' x-feed
// variants, dummy entries and VMEM bm clamps are Mosaic machinery with no
// counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

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

// Shared-memory plan of a ring of STAGES (A, B) tile pairs plus the f32
// staging tile of the epilogue, which reuses the ring.  A is (a_rows x
// a_cols), B (b_rows x b_cols), both row-major with one 16-byte pad per row:
// the pad keeps WMMA fragment loads off a single bank and every row start
// 16-byte aligned for cp.async.
template <typename T, int BM, int BN, int ARows, int ACols, int BRows,
          int BCols, int STAGES>
struct Ring {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte copy
  static constexpr int kAld = ACols + kVec;
  static constexpr int kBld = BCols + kVec;
  static constexpr int kABytes = align128(ARows * kAld * sizeof(T));
  static constexpr int kBBytes = align128(BRows * kBld * sizeof(T));
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOld = BN + 8;           // f32 epilogue staging
  static constexpr int kOutBytes = BM * kOld * 4;
  static constexpr int kSmemBytes = STAGES * kStageBytes > kOutBytes
                                        ? STAGES * kStageBytes
                                        : kOutBytes;
  static_assert(BM % 32 == 0 && BN % 32 == 0, "tile shape");
  static_assert(STAGES >= 2, "ring depth");
  static_assert(kSmemBytes <= 227 * 1024, "shared memory per block");
};

// packed_mm: A = the x (gy for dx) tile (BM x BK); B = the W tile, (BK x BN)
// for the forward, (BN x BK) -- Wᵀ's tile, column-major -- for dx.
template <typename T, int BM, int BN, int BK, int STAGES, bool kTransW>
using MmRing = Ring<T, BM, BN, BM, BK, kTransW ? BN : BK, kTransW ? BK : BN,
                    STAGES>;

// dw: A = the x chunk (BK x BM), B = the gy chunk (BK x BN).
template <typename T, int BM, int BN, int BK, int STAGES>
using DwRing = Ring<T, BM, BN, BK, BM, BK, BN, STAGES>;

// The accumulators of one thread: WMMA fragments (bf16) or BM*BN/kThreads
// scalars (f32), and the epilogue that writes the (BM x BN) tile at `out`
// (row stride ld), masked to rows < row_lim and columns < col_lim, cast once.
template <typename T, int BM, int BN>
struct Acc {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int FM = BM / 32, FN = BN / 32;  // 16x16 frags per warp
  static constexpr int kPer = BM * BN / kThreads;   // f32: outputs / thread
  using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                      float>;
  Frag frag[kBf16 ? FM : 1][kBf16 ? FN : 1];
  float scalar[kBf16 ? 1 : kPer];

  __device__ __forceinline__ void zero() {
    if constexpr (kBf16) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          nvcuda::wmma::fill_fragment(frag[i][j], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) scalar[i] = 0.f;
    }
  }

  // Call after the ring is idle and every thread has passed a barrier: the
  // bf16 path stages its fragments through the ring's shared memory.  The
  // f32 path may store into an f32 workspace (O = float) of any T.
  template <typename O>
  __device__ __forceinline__ void store(unsigned char* smem, O* out, int ld,
                                        int row_lim, int col_lim) {
    const int tid = threadIdx.x;
    if constexpr (kBf16) {
      constexpr int kOld = BN + 8;
      const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
      float* os = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          nvcuda::wmma::store_matrix_sync(
              os + (wr * (BM / 2) + i * 16) * kOld + wc * (BN / 2) + j * 16,
              frag[i][j], kOld, nvcuda::wmma::mem_row_major);
      __syncthreads();
      for (int idx = tid; idx < BM * BN; idx += kThreads) {
        const int r = idx / BN, c = idx % BN;
        if (r < row_lim && c < col_lim)
          out[static_cast<size_t>(r) * ld + c] =
              __float2bfloat16(os[r * kOld + c]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / BN, c = idx % BN;
        if (r < row_lim && c < col_lim)
          out[static_cast<size_t>(r) * ld + c] = static_cast<O>(scalar[i]);
      }
    }
  }
};

// Copies a (rows x cols) tile, row-major with source row stride `ld`, into
// shared memory with row stride `sld`, as 16-byte cp.asyncs; chunks outside
// (row_lim, col_lim) are zero-filled.  `base` is any valid global address.
template <typename T, int Rows, int Cols>
__device__ __forceinline__ void load_tile(T* dst, int sld, const T* src,
                                          size_t ld, int row_lim, int col_lim,
                                          const T* base) {
  constexpr int kVec = 16 / sizeof(T);
  for (int c = threadIdx.x; c < Rows * Cols / kVec; c += kThreads) {
    const int r = c / (Cols / kVec);
    const int cc = (c % (Cols / kVec)) * kVec;
    const bool ok = r < row_lim && cc < col_lim;
    cp_async16(dst + r * sld + cc, ok ? src + r * ld + cc : base, ok);
  }
}

// y (m, ngroups * out_w) for the forward / dx (m, ngroups * out_w) for dx.
// Output block-column g walks actives [beg[g], end[g]); active a reads x's
// segment seg_idx[a] (width `seg`: bk forward, bn dx) and one (bk, bn)
// weight block, row-major with rows `w_ld` apart.  Packed storage (woffs
// null, w_ld = bn): the block is w[slot], slot = a for the forward and
// slots[a] for dx.  Dense storage (W (K, N) itself, w_ld = N): the block
// starts at element woffs[a] of w.  `x_ld` / `y_ld` are the row strides of
// x and y.
template <typename T, int BM, int BN, int BK, int STAGES, bool kTransW>
__global__ void __launch_bounds__(kThreads)
    packed_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const int* __restrict__ beg, const int* __restrict__ end,
                     const int* __restrict__ seg_idx,
                     const int* __restrict__ slots,
                     const int* __restrict__ woffs, T* __restrict__ y, int m,
                     int x_ld, int y_ld, int bk, int bn, int w_ld) {
  using L = MmRing<T, BM, BN, BK, STAGES, kTransW>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int seg = kTransW ? bn : bk;      // contraction length per active
  const int out_w = kTransW ? bk : bn;    // width of an output block-column

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int tiles_per_col = (out_w + BN - 1) / BN;
  const int g = blockIdx.y / tiles_per_col;
  const int n0 = (blockIdx.y % tiles_per_col) * BN;   // offset in the column
  const int a_begin = beg[g];
  const int k_chunks = (seg + BK - 1) / BK;
  const int total = (end[g] - a_begin) * k_chunks;

  auto a_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes);
  };
  auto b_tile = [&](int s) {
    return reinterpret_cast<T*>(smem + s * L::kStageBytes + L::kABytes);
  };

  // Stage `s` <- the (x, w) tiles of step `it`: active a, chunk k0.
  auto load = [&](int it, int s) {
    const int a = a_begin + it / k_chunks;
    const int k0 = (it % k_chunks) * BK;
    load_tile<T, BM, BK>(
        a_tile(s), L::kAld,
        x + static_cast<size_t>(m0) * x_ld +
            static_cast<size_t>(seg_idx[a]) * seg + k0,
        x_ld, m - m0, seg - k0, x);
    const T* wa =
        w + (woffs ? static_cast<size_t>(woffs[a])
                   : static_cast<size_t>(kTransW ? slots[a] : a) * bk * bn);
    if constexpr (kTransW)   // rows: output index n0.., columns: chunk k0..
      load_tile<T, BN, BK>(b_tile(s), L::kBld,
                           wa + static_cast<size_t>(n0) * w_ld + k0, w_ld,
                           bk - n0, bn - k0, w);
    else                     // rows: chunk k0.., columns: output index n0..
      load_tile<T, BK, BN>(b_tile(s), L::kBld,
                           wa + static_cast<size_t>(k0) * w_ld + n0, w_ld,
                           bk - k0, bn - n0, w);
  };

  using A = Acc<T, BM, BN>;
  A acc;
  acc.zero();
  const int warp = tid / 32, wr = warp / 2, wc = warp % 2;

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
    const T* xs = a_tile(it % STAGES);
    const T* ws = b_tile(it % STAGES);
    if constexpr (A::kBf16) {
      using namespace nvcuda;
      using BLayout =
          std::conditional_t<kTransW, wmma::col_major, wmma::row_major>;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af[A::FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout>
            bf[A::FN];
#pragma unroll
        for (int i = 0; i < A::FM; ++i)
          wmma::load_matrix_sync(
              af[i], xs + (wr * (BM / 2) + i * 16) * L::kAld + kk, L::kAld);
#pragma unroll
        for (int j = 0; j < A::FN; ++j) {
          const int col = wc * (BN / 2) + j * 16;
          const T* b = kTransW ? ws + col * L::kBld + kk
                               : ws + kk * L::kBld + col;
          wmma::load_matrix_sync(bf[j], b, L::kBld);
        }
#pragma unroll
        for (int i = 0; i < A::FM; ++i)
#pragma unroll
          for (int j = 0; j < A::FN; ++j)
            wmma::mma_sync(acc.frag[i][j], af[i], bf[j], acc.frag[i][j]);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
#pragma unroll
        for (int i = 0; i < A::kPer; ++i) {
          const int idx = tid + i * kThreads;
          const int r = idx / BN, c = idx % BN;
          const float wv = static_cast<float>(
              kTransW ? ws[c * L::kBld + k] : ws[k * L::kBld + c]);
          acc.scalar[i] += static_cast<float>(xs[r * L::kAld + k]) * wv;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is idle: its memory becomes the staging tile
  acc.store(smem,
            y + static_cast<size_t>(m0) * y_ld +
                static_cast<size_t>(g) * out_w + n0,
            y_ld, m - m0, out_w - n0);
}

// The output block of entry s and its row stride: dw[s] of (n_active, bk,
// bn) in packed storage (dense = 0); block (rows[s], cols[s]) of a (K, N)
// dw in dense storage (dense = 1).
template <typename T>
__device__ __forceinline__ T* dw_block(T* dw, const int* rows,
                                       const int* cols, int s, int N, int bk,
                                       int bn, int dense, int& ld) {
  ld = dense ? N : bn;
  return dense ? dw + static_cast<size_t>(rows[s]) * bk * N +
                     static_cast<size_t>(cols[s]) * bn
               : dw + static_cast<size_t>(s) * bk * bn;
}

// The partial tile of thread block (s, tile, slice) in the workspace
// (slices, entries, tiles, TM x TN), f32.
__device__ __forceinline__ float* dw_partial(float* ws, int tile_elems) {
  return ws + ((static_cast<size_t>(blockIdx.z) * gridDim.x + blockIdx.x) *
                   gridDim.y +
               blockIdx.y) *
                  tile_elems;
}

// ---- packed_dw_ffma_kernel (f32) ------------------------------------------
// Thread block (s, tile, slice) computes the (BM x BN) tile at (r0, c0) of
// x[:, rows[s]*bk + r0 ..]ᵀ @ gy[:, cols[s]*bn + c0 ..] over the slice's
// rows [z * slice_rows, min(m, (z + 1) * slice_rows)); x is (m, K), gy is
// (m, N).  With ws null (one slice) it writes the block of dw_block; with
// ws it writes the f32 partial tile.  An entry with flags[s] == 0 (flags
// non-null) writes nothing.
template <int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
    packed_dw_ffma_kernel(const float* __restrict__ x,
                          const float* __restrict__ gy,
                          const int* __restrict__ rows,
                          const int* __restrict__ cols,
                          const int* __restrict__ flags,
                          float* __restrict__ dw, float* __restrict__ ws,
                          int m, int K, int N, int bk, int bn, int dense,
                          int slice_rows) {
  using L = DwRing<float, BM, BN, BK, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  if (flags && flags[s] == 0) return;   // uniform: before any barrier
  const int tiles_n = (bn + BN - 1) / BN;
  const int r0 = (blockIdx.y / tiles_n) * BM;
  const int c0 = (blockIdx.y % tiles_n) * BN;
  const int m_begin = blockIdx.z * slice_rows;
  const int m_end = min(m, m_begin + slice_rows);
  const float* xa = x + static_cast<size_t>(rows[s]) * bk + r0;
  const float* ga = gy + static_cast<size_t>(cols[s]) * bn + c0;
  const int total = (m_end - m_begin + BK - 1) / BK;

  auto a_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStageBytes);
  };
  auto b_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + st * L::kStageBytes + L::kABytes);
  };
  auto load = [&](int it, int st) {
    const int mm0 = m_begin + it * BK;
    load_tile<float, BK, BM>(a_tile(st), L::kAld,
                             xa + static_cast<size_t>(mm0) * K, K,
                             m_end - mm0, bk - r0, x);
    load_tile<float, BK, BN>(b_tile(st), L::kBld,
                             ga + static_cast<size_t>(mm0) * N, N,
                             m_end - mm0, bn - c0, gy);
  };

  using A = Acc<float, BM, BN>;
  A acc;
  acc.zero();

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < total) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = it + STAGES - 1;
    if (next < total) load(next, next % STAGES);
    cp_async_commit();
    const float* xs = a_tile(it % STAGES);
    const float* gs = b_tile(it % STAGES);
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
#pragma unroll
      for (int i = 0; i < A::kPer; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / BN, c = idx % BN;
        acc.scalar[i] += xs[k * L::kAld + r] * gs[k * L::kBld + c];
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (ws) {
    acc.store(smem, dw_partial(ws, BM * BN), BN, BM, BN);
  } else {
    int ld;
    float* out = dw_block(dw, rows, cols, s, N, bk, bn, dense, ld);
    acc.store(smem, out + static_cast<size_t>(r0) * ld + c0, ld, bk - r0,
              bn - c0);
  }
}

// ---- packed_dw_wgmma_kernel (bf16) ----------------------------------------
constexpr int kWgTile = 128;      // output tile: 128 x 128
constexpr int kWgChunk = 64;      // m rows per ring stage
constexpr int kWgStages = 4;      // ring depth
constexpr int kWgBox = 64;        // columns per TMA box: 128 bytes, the swizzle
constexpr int kWgBoxBytes = kWgChunk * kWgBox * 2;   // 8 KB
constexpr int kWgStageBytes = 4 * kWgBoxBytes;       // x, gy: two boxes each
constexpr int kWgConsumers = 256;                    // two warpgroups
constexpr int kWgThreads = kWgConsumers + 32;        // + the producer warp
constexpr int kWgSmem = 1024 + kWgStages * kWgStageBytes + 2 * kWgStages * 8;

// Thread block (s, tile, slice): the (128 x 128) tile at (r0, c0) of entry
// s's block, over the slice's rows, as packed_dw_ffma_kernel computes it;
// x and gy are read through the tensor maps tx (m, K) and tg (m, N).
// Threads 0-255 are two consumer warpgroups (rows 64 wg .. 64 wg + 63 of
// the tile), 256-287 the producer warp, of which one thread issues TMA.
__global__ void __launch_bounds__(kWgThreads, 1)
    packed_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tg,
                           const int* __restrict__ rows,
                           const int* __restrict__ cols,
                           const int* __restrict__ flags,
                           __nv_bfloat16* __restrict__ dw,
                           float* __restrict__ ws, int m, int N, int bk,
                           int bn, int dense, int slice_rows) {
  extern __shared__ unsigned char wg_smem[];
  const int s = blockIdx.x;
  if (flags && flags[s] == 0) return;   // uniform: before any barrier
  const int tiles_n = (bn + kWgTile - 1) / kWgTile;
  const int r0 = (blockIdx.y / tiles_n) * kWgTile;
  const int c0 = (blockIdx.y % tiles_n) * kWgTile;
  const int m_begin = blockIdx.z * slice_rows;
  const int total = (min(m, m_begin + slice_rows) - m_begin + kWgChunk - 1) /
                    kWgChunk;
  const int tid = threadIdx.x;

  // Stage st: x boxes at base + st * kWgStageBytes (+ kWgBoxBytes for the
  // second 64 columns), gy boxes after them; then the barriers: full[st]
  // (TMA arrival) and empty[st] (released by every consumer thread).
  const uint32_t base = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t full = base + kWgStages * kWgStageBytes;
  const uint32_t empty = full + 8 * kWgStages;
  if (tid == 0) {
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {   // the producer warp
    if (tid == kWgConsumers) {
      const int xc = rows[s] * bk + r0, gc = cols[s] * bn + c0;
      const bool x_hi = bk - r0 > kWgBox, g_hi = bn - c0 > kWgBox;
      const int bytes = (2 + x_hi + g_hi) * kWgBoxBytes;
      for (int it = 0; it < total; ++it) {
        const int st = it % kWgStages;
        if (it >= kWgStages)   // the consumers released round it/kWgStages-1
          mbar_wait(empty + 8 * st, ((it / kWgStages) - 1) & 1);
        const uint32_t bar = full + 8 * st;
        const uint32_t dst = base + st * kWgStageBytes;
        const int mm = m_begin + it * kWgChunk;
        mbar_expect_tx(bar, bytes);
        tma_load(dst, &tx, xc, mm, bar);
        if (x_hi) tma_load(dst + kWgBoxBytes, &tx, xc + kWgBox, mm, bar);
        tma_load(dst + 2 * kWgBoxBytes, &tg, gc, mm, bar);
        if (g_hi) tma_load(dst + 3 * kWgBoxBytes, &tg, gc + kWgBox, mm, bar);
      }
    }
    return;
  }

  const int wg = tid / 128;   // this warpgroup's 64 rows of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // One stage's products stay in flight while the next stage's are
  // issued; a stage is released once its products have completed.
  for (int it = 0; it < total; ++it) {
    const int st = it % kWgStages;
    mbar_wait(full + 8 * st, (it / kWgStages) & 1);
    const uint32_t xs = base + st * kWgStageBytes + wg * kWgBoxBytes;
    const uint32_t gs = base + st * kWgStageBytes + 2 * kWgBoxBytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kWgChunk / 16; ++k)   // 16 rows of 128 bytes a step
      wgmma_m64n128k16<1, 1>(acc, wgmma_desc(xs + k * 2048, kWgBoxBytes),
                             wgmma_desc(gs + k * 2048, kWgBoxBytes));
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kWgStages));
  }
  wgmma_wait<0>();

  // acc[4j + 2h + v] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane
  // % 4) + v of the warpgroup's 64 x 128 result.
  const int lane = tid % 32;
  const int row = 64 * wg + 16 * ((tid / 32) % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  if (ws) {
    float* out = dw_partial(ws, kWgTile * kWgTile);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (row + 8 * h) * kWgTile + 8 * j +
                                   col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  } else {
    int ld;
    __nv_bfloat16* out = dw_block(dw, rows, cols, s, N, bk, bn, dense, ld);
    out += static_cast<size_t>(r0) * ld + c0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h, c = 8 * j + col;
        // bn - c0 is a multiple of 8: both columns of a pair are in or out.
        if (r < bk - r0 && c < bn - c0)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<size_t>(r) * ld + c) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
  }
}

// ---- packed_mm_wgmma_kernel (bf16) ----------------------------------------
constexpr int kMmTile = 128;      // output tile: 128 rows x 128 columns
constexpr int kMmChunk = 64;      // contraction per ring stage
constexpr int kMmStages = 3;      // ring depth; two thread blocks an SM
constexpr int kMmXBytes = kMmTile * kMmChunk * 2;   // 16 KB: 128 x 64 x
constexpr int kMmStageBytes = 2 * kMmXBytes;        // + 16 KB of W
constexpr int kMmSmem = 1024 + kMmStages * kMmStageBytes + 2 * kMmStages * 8;
// The epilogue's staging row: 128 bf16 + 16 bytes, so that a warp's
// fragment stores (8 rows x 4 pairs) fall on 32 distinct banks.
constexpr int kMmStageLd = kMmTile + 8;
static_assert(2 * 64 * kMmStageLd * 2 <= kMmStages * kMmStageBytes,
              "the staging tiles fit in the ring");

// Thread block (column subtile, m-tile): the (128 x 128) tile at (m0, n0)
// of output block-column g, the f32 sum over g's actives [beg[g], end[g])
// of x's segment seg_idx[a] (tensor map tx over x (m, x_ld), boxes of 128
// rows x 64) times the W block of a (tensor map tw over W as (block-row,
// row, block-column, column); boxes 64 x 64 forward, 128 x 64 dx).  The
// block of a is (slot, 0) in packed storage (woffs null; slot = a forward,
// slots[a] dx) and (woffs[a] / (bk w_ld), woffs[a] % w_ld / bn) in dense
// storage.  Threads 0-255 are two consumer warpgroups (rows 64 wg .. 64 wg
// + 63 of the tile), 256-287 the producer warp, of which one thread issues
// TMA.
template <bool kTransW>
__global__ void __launch_bounds__(kWgThreads, 2)
    packed_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const int* __restrict__ beg,
                           const int* __restrict__ end,
                           const int* __restrict__ seg_idx,
                           const int* __restrict__ slots,
                           const int* __restrict__ woffs,
                           __nv_bfloat16* __restrict__ y, int m, int y_ld,
                           int bk, int bn, int w_ld) {
  extern __shared__ unsigned char mm_smem[];
  const int seg = kTransW ? bn : bk;      // contraction per active
  const int out_w = kTransW ? bk : bn;    // width of an output block-column
  const int tiles_per_col = (out_w + kMmTile - 1) / kMmTile;
  const int g = blockIdx.x / tiles_per_col;
  const int n0 = (blockIdx.x % tiles_per_col) * kMmTile;
  const int m0 = blockIdx.y * kMmTile;
  const int a_begin = beg[g];
  const int chunks = seg / kMmChunk;
  const int total = (end[g] - a_begin) * chunks;
  const int tid = threadIdx.x;

  // Stage st: the x box at base + st * kMmStageBytes, the W box(es) after
  // it; then the barriers full[st] (TMA arrival) and empty[st] (released
  // by every consumer thread).
  const uint32_t base = (smem_u32(mm_smem) + 1023) & ~1023u;
  const uint32_t full = base + kMmStages * kMmStageBytes;
  const uint32_t empty = full + 8 * kMmStages;
  if (tid == 0) {
    for (int st = 0; st < kMmStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kWgConsumers) {   // the producer warp
    if (tid == kWgConsumers) {
      // Forward: W columns n0 + 64 .. are loaded only where the block has
      // any; the stale half of the stage feeds only masked columns.
      const bool w_hi = !kTransW && out_w - n0 > kWgBox;
      const int bytes = kMmXBytes + (kTransW ? kMmXBytes
                                             : (1 + w_hi) * kWgBoxBytes);
      for (int it = 0; it < total; ++it) {
        const int st = it % kMmStages;
        if (it >= kMmStages)   // the consumers released round it/S - 1
          mbar_wait(empty + 8 * st, ((it / kMmStages) - 1) & 1);
        const int a = a_begin + it / chunks;
        const int k0 = (it % chunks) * kMmChunk;
        int br, bc;            // the W block: (block-row, block-column)
        if (woffs) {
          const int o = woffs[a];
          br = o / (bk * w_ld);
          bc = (o % w_ld) / bn;
        } else {
          br = kTransW ? slots[a] : a;
          bc = 0;
        }
        const uint32_t bar = full + 8 * st;
        const uint32_t dst = base + st * kMmStageBytes;
        mbar_expect_tx(bar, bytes);
        tma_load(dst, &tx, seg_idx[a] * seg + k0, m0, bar);
        if (kTransW) {   // rows n0 .. n0 + 127 of the block, columns k0 ..
          tma_load_4d(dst + kMmXBytes, &tw, k0, bc, n0, br, bar);
        } else {         // rows k0 .. k0 + 63, columns n0 .. (and n0 + 64 ..)
          tma_load_4d(dst + kMmXBytes, &tw, n0, bc, k0, br, bar);
          if (w_hi)
            tma_load_4d(dst + kMmXBytes + kWgBoxBytes, &tw, n0 + kWgBox, bc,
                        k0, br, bar);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;   // this warpgroup's 64 rows of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < total; ++it) {
    const int st = it % kMmStages;
    mbar_wait(full + 8 * st, (it / kMmStages) & 1);
    // A: this warpgroup's 64 rows of the x box (8 KB); B: the W box(es).
    const uint32_t xs = base + st * kMmStageBytes + wg * kWgBoxBytes;
    const uint32_t ws = base + st * kMmStageBytes + kMmXBytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kMmChunk / 16; ++k) {
      const uint64_t da = wgmma_desc(xs + 32 * k, 16);
      if constexpr (kTransW)   // B = Wᵀ: the W box's rows are B's columns
        wgmma_m64n128k16<0, 0>(acc, da, wgmma_desc(ws + 32 * k, 16));
      else                     // B = W: 16 rows of 128 bytes a step
        wgmma_m64n128k16<0, 1>(acc, da,
                               wgmma_desc(ws + 2048 * k, kWgBoxBytes));
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % kMmStages));
  }
  wgmma_wait<0>();

  // The epilogue goes through shared memory, so that each warp stores
  // whole 256-byte row segments: every consumer has finished its products
  // (named barrier 1) before the ring's memory becomes the staging tiles,
  // one (64 x kMmStageLd) bf16 tile a warpgroup (barriers 2 and 3).
  // acc[4j + 2h + v] is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane
  // % 4) + v of the warpgroup's 64 x 128 result.
  bar_sync(1, kWgConsumers);
  const int lane = tid % 32;
  const int row = 16 * ((tid / 32) % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
                             mm_smem + (base - smem_u32(mm_smem))) +
                         wg * 64 * kMmStageLd;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8 * h) * kMmStageLd +
                                         8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  bar_sync(2 + wg, 128);
  // 16 bytes a thread, masked to rows < m and columns < the block's width
  // (out_w - n0 is a multiple of 8: a group of 8 columns is in or out).
  __nv_bfloat16* out = y + static_cast<size_t>(m0 + 64 * wg) * y_ld +
                       static_cast<size_t>(g) * out_w + n0;
  const int rows = m - m0 - 64 * wg, cols = out_w - n0;
#pragma unroll
  for (int q = 0; q < 64 * kMmTile / 8 / 128; ++q) {
    const int i = tid % 128 + 128 * q;
    const int r = i / (kMmTile / 8), c = 8 * (i % (kMmTile / 8));
    if (r < rows && c < cols)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(r) * y_ld + c) =
          *reinterpret_cast<const uint4*>(stage + r * kMmStageLd + c);
  }
}

// ---- packed_mm_ffma_kernel (f32) ------------------------------------------
constexpr int kFfRows = 64;       // output tile: 64 rows x 128 columns
constexpr int kFfCols = 128;
constexpr int kFfChunk = 8;       // contraction per shared-memory stage
constexpr int kFfThreads = 128;   // 8 x 16, 8 x 8 outputs each
// Row strides of the shared tiles: the transposing stores of a warp's two
// column halves land 16 banks apart.
constexpr int kFfXLd = kFfRows + 4;
constexpr int kFfWLd = kFfCols + 4;

// Thread block (column subtile, m-tile): the (64 x 128) tile at (m0, n0)
// of output block-column g, the sums of packed_mm_wgmma_kernel, from x (m,
// x_ld) and W read at its packed slot (woffs null) or at element woffs[a]
// (rows w_ld apart).  Thread (ty, tx) owns rows 4 ty + i and 32 + 4 ty + i,
// columns 4 tx + j and 64 + 4 tx + j (i, j < 4).  Each step the threads
// fetch the next 8-deep chunk -- x (64 x 8: one float4 a thread) and W (8
// x 128 forward; 128 x 8 of the block's rows for dx: two each) -- into
// registers, and store it k-major into the free half of the shared tiles
// while the other half feeds 8 x 64 fmaf a thread.  Zeros fill what lies
// past m, seg or the block's width (seg and out_w are multiples of 4).
template <bool kTransW>
__global__ void __launch_bounds__(kFfThreads, 4)
    packed_mm_ffma_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const int* __restrict__ beg,
                          const int* __restrict__ end,
                          const int* __restrict__ seg_idx,
                          const int* __restrict__ slots,
                          const int* __restrict__ woffs,
                          float* __restrict__ y, int m, int x_ld, int y_ld,
                          int bk, int bn, int w_ld) {
  __shared__ __align__(16) float xs[2][kFfChunk][kFfXLd];   // [k][row]
  __shared__ __align__(16) float ws[2][kFfChunk][kFfWLd];   // [k][column]
  const int seg = kTransW ? bn : bk;
  const int out_w = kTransW ? bk : bn;
  const int tiles_per_col = (out_w + kFfCols - 1) / kFfCols;
  const int g = blockIdx.x / tiles_per_col;
  const int n0 = (blockIdx.x % tiles_per_col) * kFfCols;
  const int m0 = blockIdx.y * kFfRows;
  const int a_begin = beg[g];
  const int chunks = (seg + kFfChunk - 1) / kFfChunk;
  const int total = (end[g] - a_begin) * chunks;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // This thread's float4s of a chunk: x at (row xr, columns xc ..); W at
  // (rows wr and wr + kWStep, columns wc ..) of the block -- k-rows
  // forward, n-rows for dx.
  const int xr = tid / 2, xc = 4 * (tid % 2);
  const int wr = kTransW ? tid / 2 : tid / 32;
  const int wc = kTransW ? 4 * (tid % 2) : 4 * (tid % 32);
  constexpr int kWStep = kTransW ? 64 : 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 rx = zero, rw[2] = {zero, zero};

  auto fetch = [&](int it) {
    const int a = a_begin + it / chunks;
    const int k0 = (it % chunks) * kFfChunk;
    const float* wa =
        w + (woffs ? static_cast<size_t>(woffs[a])
                   : static_cast<size_t>(kTransW ? slots[a] : a) * bk * bn);
    rx = m0 + xr < m && k0 + xc < seg
             ? __ldg(reinterpret_cast<const float4*>(
                   x + static_cast<size_t>(m0 + xr) * x_ld +
                   static_cast<size_t>(seg_idx[a]) * seg + k0 + xc))
             : zero;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + h * kWStep;
      const bool ok = kTransW ? n0 + r < out_w && k0 + wc < seg
                              : k0 + r < seg && n0 + wc < out_w;
      const float* wp = kTransW ? wa + static_cast<size_t>(n0 + r) * w_ld +
                                      k0 + wc
                                : wa + static_cast<size_t>(k0 + r) * w_ld +
                                      n0 + wc;
      rw[h] = ok ? __ldg(reinterpret_cast<const float4*>(wp)) : zero;
    }
  };
  auto stash = [&](int buf) {
    xs[buf][xc][xr] = rx.x;
    xs[buf][xc + 1][xr] = rx.y;
    xs[buf][xc + 2][xr] = rx.z;
    xs[buf][xc + 3][xr] = rx.w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr + h * kWStep;
      if constexpr (kTransW) {
        ws[buf][wc][r] = rw[h].x;
        ws[buf][wc + 1][r] = rw[h].y;
        ws[buf][wc + 2][r] = rw[h].z;
        ws[buf][wc + 3][r] = rw[h].w;
      } else {
        *reinterpret_cast<float4*>(&ws[buf][r][wc]) = rw[h];
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (total > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) fetch(it + 1);   // in flight during the products
#pragma unroll
    for (int k = 0; k < kFfChunk; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&xs[buf][k][4 * ty]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&xs[buf][k][32 + 4 * ty]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&ws[buf][k][4 * tx]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&ws[buf][k][64 + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (it + 1 < total) stash(buf ^ 1);   // its last readers passed the
    __syncthreads();                      // previous step's barrier
  }

  float* out = y + static_cast<size_t>(m0) * y_ld +
               static_cast<size_t>(g) * out_w + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 32) + 4 * ty + i % 4;
    if (r >= m - m0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * h + 4 * tx;
      if (c < out_w - n0)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * y_ld + c) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---- packed_dw_reduce_kernel ----------------------------------------------
// The (tm x tn) f32 partials of every (entry s, tile) in the `slices`
// slices, ws[z][s][tile], added in slice order and cast once into entry s's
// block (dw_block), masked to the block; nothing for flags[s] == 0.  One
// thread a group of 4 columns, grid-strided over all entries and tiles.
template <typename T>
__global__ void __launch_bounds__(256)
    packed_dw_reduce_kernel(const float* __restrict__ ws,
                            const int* __restrict__ rows,
                            const int* __restrict__ cols,
                            const int* __restrict__ flags,
                            T* __restrict__ dw, int slices, int n_ent,
                            int tiles, int tm, int tn, int N, int bk, int bn,
                            int dense) {
  const int per_tile = tm * tn / 4;
  const size_t total = static_cast<size_t>(n_ent) * tiles * per_tile;
  const size_t slice_stride = total * 4;
  const int tiles_n = (bn + tn - 1) / tn;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(i % per_tile);
    const int t = static_cast<int>((i / per_tile) % tiles);
    const int s = static_cast<int>(i / (static_cast<size_t>(per_tile) * tiles));
    if (flags && flags[s] == 0) continue;
    const int r = (t / tiles_n) * tm + q / (tn / 4);
    const int c = (t % tiles_n) * tn + 4 * (q % (tn / 4));
    // bn is a multiple of 4: a group of 4 columns is in the block or out.
    if (r >= bk || c >= bn) continue;
    float4 v = *reinterpret_cast<const float4*>(ws + 4 * i);
    for (int z = 1; z < slices; ++z) {
      const float4 p =
          *reinterpret_cast<const float4*>(ws + z * slice_stride + 4 * i);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    int ld;
    T* o = dw_block(dw, rows, cols, s, N, bk, bn, dense, ld) +
           static_cast<size_t>(r) * ld + c;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<const uint32_t*>(&lo);
      packed.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(o) = packed;
    }
  }
}

// The tensor map of a row-major (rows, cols) bf16 matrix, boxes of
// box_rows rows x kWgBox columns.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kWgBox, static_cast<cuuint32_t>(box_rows)};
  return bf16_map_nd(map, base, 2, dims, strides, box);
}

// Arguments common to every mm launch.  W's block (r, c) starts at element
// (r bk) w_ld + c bn and holds bk rows of bn; W has w_rows rows (n_active bk
// in packed storage, where w_ld = bn; K in dense storage, where w_ld = N).
struct MmArgs {
  const void* x;
  const void* w;
  const int* beg;
  const int* end;
  const int* seg_idx;
  const int* slots;   // dx in packed storage: the packed slot of each entry
  const int* woffs;   // dense storage: each entry's W block offset
  void* y;
  int m, x_ld, ngroups, bk, bn, w_ld, w_rows;
  cudaStream_t stream;
};

// Above 48 KB, dynamic shared memory must be allowed per kernel and device:
// once for each (instantiation, device), not on every launch.  `carveout`
// (percent of the unified L1 / shared memory) is set with it where given.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem,
                       std::atomic<uint64_t>& allowed, int carveout = -1) {
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

// packed_mm_kernel (the decode and tiled branches): grid (m-tiles, column
// subtiles).
template <typename T, int BM, int BN, int BK, int STAGES, bool kTransW>
cudaError_t launch_mm(const MmArgs& a) {
  constexpr int smem = MmRing<T, BM, BN, BK, STAGES, kTransW>::kSmemBytes;
  auto kernel = packed_mm_kernel<T, BM, BN, BK, STAGES, kTransW>;
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const int out_w = kTransW ? a.bk : a.bn;
  dim3 grid((a.m + BM - 1) / BM, a.ngroups * ((out_w + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), a.beg, a.end,
      a.seg_idx, a.slots, a.woffs, static_cast<T*>(a.y), a.m, a.x_ld,
      a.ngroups * out_w, a.bk, a.bn, a.w_ld);
  return cudaGetLastError();
}

// The column-subtile-major grid of the wgmma and ffma branches: (column
// subtiles, m-tiles) of (rows x cols) tiles, at most 65535 m-tiles.
cudaError_t tile_grid(const MmArgs& a, int out_w, int rows, int cols,
                      dim3* grid) {
  const int m_tiles = (a.m + rows - 1) / rows;
  if (m_tiles > 65535) return cudaErrorInvalidValue;
  *grid = dim3(a.ngroups * ((out_w + cols - 1) / cols), m_tiles);
  return cudaSuccess;
}

template <bool kTransW>
cudaError_t launch_mm_wgmma(const MmArgs& a) {
  const int seg = kTransW ? a.bn : a.bk;
  const int out_w = kTransW ? a.bk : a.bn;
  if (seg % kMmChunk || a.bk % 8 || a.bn % 8 || a.w_ld % a.bn ||
      a.w_rows % a.bk)
    return cudaErrorInvalidValue;
  dim3 grid;
  cudaError_t err = tile_grid(a, out_w, kMmTile, kMmTile, &grid);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tw{};
  err = bf16_map(&tx, a.x, a.m, a.x_ld, kMmTile);
  if (err != cudaSuccess) return err;
  // W as (block-row, row, block-column, column); with no block (an empty
  // packing) no column has an active, nothing is loaded, and tw stays
  // unencoded.
  if (a.w_rows > 0) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.bn),
                                static_cast<cuuint64_t>(a.w_ld / a.bn),
                                static_cast<cuuint64_t>(a.bk),
                                static_cast<cuuint64_t>(a.w_rows / a.bk)};
    const cuuint64_t ld = static_cast<cuuint64_t>(a.w_ld) * 2;
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.bn) * 2, ld,
                                   ld * a.bk};
    const cuuint32_t box[4] = {kWgBox, 1, kTransW ? kMmTile : kMmChunk, 1};
    err = bf16_map_nd(&tw, a.w, 4, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  auto kernel = packed_mm_wgmma_kernel<kTransW>;
  static std::atomic<uint64_t> allowed{0};
  err = allow_smem(kernel, kMmSmem, allowed,
                   cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, kMmSmem, a.stream>>>(
      tx, tw, a.beg, a.end, a.seg_idx, a.slots, a.woffs,
      static_cast<__nv_bfloat16*>(a.y), a.m, a.ngroups * out_w, a.bk, a.bn,
      a.w_ld);
  return cudaGetLastError();
}

template <bool kTransW>
cudaError_t launch_mm_ffma(const MmArgs& a) {
  const int out_w = kTransW ? a.bk : a.bn;
  dim3 grid;
  const cudaError_t err = tile_grid(a, out_w, kFfRows, kFfCols, &grid);
  if (err != cudaSuccess) return err;
  packed_mm_ffma_kernel<kTransW><<<grid, kFfThreads, 0, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w), a.beg,
      a.end, a.seg_idx, a.slots, a.woffs, static_cast<float*>(a.y), a.m,
      a.x_ld, a.ngroups * out_w, a.bk, a.bn, a.w_ld);
  return cudaGetLastError();
}

// The branches, in the order of ops/block_sparse_packed.py MM_BRANCHES.
// The caller names one by the rule of mm_branch there:
//   decode: m <= 32, either dtype -- packed_mm_kernel, 32 x 32 tiles,
//           contraction steps of 256 (128 in f32);
//   tiled:  bf16, m > 32, a contraction per active (bk forward, bn dx)
//           that 64 does not divide -- packed_mm_kernel, 64 x 64 x 32;
//   wgmma:  bf16, m > 32, 64 divides the contraction --
//           packed_mm_wgmma_kernel;
//   ffma:   f32, m > 32 -- packed_mm_ffma_kernel.
// A branch that cannot take the call (another dtype, a contraction the
// wgmma boxes do not divide, unaligned operands, more than 65535 m-tiles)
// is refused with cudaErrorInvalidValue; no other branch is tried.
enum MmBranch { kMmDecode = 0, kMmTiled = 1, kMmWgmma = 2, kMmFfma = 3 };

template <bool kTransW>
int dispatch_mm(const MmArgs& a, int branch, int dtype) {
  if (a.m <= 0 || a.ngroups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  using B = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  switch (branch) {
    case kMmDecode:   // one m-tile at decode: narrow tiles, long steps
      if (dtype == 1)
        err = launch_mm<B, 32, 32, 256, 3, kTransW>(a);
      else if (dtype == 0)
        err = launch_mm<float, 32, 32, 128, 3, kTransW>(a);
      break;
    case kMmTiled:
      if (dtype == 1) err = launch_mm<B, 64, 64, 32, 3, kTransW>(a);
      break;
    case kMmWgmma:
      if (dtype == 1) err = launch_mm_wgmma<kTransW>(a);
      break;
    case kMmFfma:
      if (dtype == 0) err = launch_mm_ffma<kTransW>(a);
      break;
  }
  return static_cast<int>(err);
}

// Arguments common to every dw launch.
struct DwArgs {
  const void* x;
  const void* gy;
  const int* rows;
  const int* cols;
  const int* flags;   // null: every entry writes
  void* dw;
  float* ws;          // the (slices, entries, tiles, tile) f32 workspace
  int m, K, N, n_ent, bk, bn, dense, slices, slice_rows;
  cudaStream_t stream;
};

// With more than one slice, the second pass: packed_dw_reduce_kernel over
// every output group of 4 columns, at most 8 thread blocks an SM.
template <typename T>
cudaError_t launch_reduce(const DwArgs& a, int tiles, int tm, int tn) {
  if (a.slices == 1) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long groups = static_cast<long long>(a.n_ent) * tiles * tm *
                           tn / 4;
  const int blocks =
      static_cast<int>(std::min<long long>((groups + 255) / 256, 8LL * sms));
  packed_dw_reduce_kernel<T><<<blocks, 256, 0, a.stream>>>(
      a.ws, a.rows, a.cols, a.flags, static_cast<T*>(a.dw), a.slices,
      a.n_ent, tiles, tm, tn, a.N, a.bk, a.bn, a.dense);
  return cudaGetLastError();
}

cudaError_t launch_dw_bf16(const DwArgs& a) {
  CUtensorMap tx, tg;
  cudaError_t err = bf16_map(&tx, a.x, a.m, a.K, kWgChunk);
  if (err != cudaSuccess) return err;
  err = bf16_map(&tg, a.gy, a.m, a.N, kWgChunk);
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> allowed{0};
  err = allow_smem(packed_dw_wgmma_kernel, kWgSmem, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.bk + kWgTile - 1) / kWgTile) *
                    ((a.bn + kWgTile - 1) / kWgTile);
  packed_dw_wgmma_kernel<<<dim3(a.n_ent, tiles, a.slices), kWgThreads,
                           kWgSmem, a.stream>>>(
      tx, tg, a.rows, a.cols, a.flags, static_cast<__nv_bfloat16*>(a.dw),
      a.slices > 1 ? a.ws : nullptr, a.m, a.N, a.bk, a.bn, a.dense,
      a.slice_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<__nv_bfloat16>(a, tiles, kWgTile, kWgTile);
}

template <int BM, int BN, int BK, int STAGES>
cudaError_t launch_dw_f32(const DwArgs& a) {
  constexpr int smem = DwRing<float, BM, BN, BK, STAGES>::kSmemBytes;
  auto kernel = packed_dw_ffma_kernel<BM, BN, BK, STAGES>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.bk + BM - 1) / BM) * ((a.bn + BN - 1) / BN);
  kernel<<<dim3(a.n_ent, tiles, a.slices), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.gy),
      a.rows, a.cols, a.flags, static_cast<float*>(a.dw),
      a.slices > 1 ? a.ws : nullptr, a.m, a.K, a.N, a.bk, a.bn, a.dense,
      a.slice_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<float>(a, tiles, BM, BN);
}

int dispatch_dw(const DwArgs& a, int dtype) {
  if (a.m <= 0 || a.n_ent <= 0 || a.slices <= 0 || a.slice_rows <= 0 ||
      (a.slices > 1 && !a.ws))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch_dw_bf16(a);
  else if (dtype == 0)
    err = launch_dw_f32<64, 64, 16, 3>(a);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point launches its kernel
// once and returns cudaGetLastError() after the launch (0 = launched), or
// the error that refused it.  All run on `stream` and allocate nothing.

// y (m, nn*bn) = x (m, nk*bk) @ W (n_act, bk, bn); column j's actives are
// packed slots col_ptr[j] .. col_ptr[j+1]-1, block-row rows[a] each.
// `branch`: dispatch_mm's MmBranch, named by the caller.
extern "C" int packed_mm_fwd(const void* x, const void* w, const void* col_ptr,
                             const void* rows, void* y, int m, int K, int nn,
                             int bk, int bn, int n_act, int branch, int dtype,
                             void* stream) {
  const int* p = static_cast<const int*>(col_ptr);
  return dispatch_mm<false>({x, w, p, p + 1, static_cast<const int*>(rows),
                             nullptr, nullptr, y, m, K, nn, bk, bn, bn,
                             n_act * bk, static_cast<cudaStream_t>(stream)},
                            branch, dtype);
}

// dx (m, nk*bk) = gy (m, nn*bn) @ Wᵀ; block-row k's actives are entries
// row_ptr[k] .. row_ptr[k+1]-1, block-column cols[e] and packed slot
// slots[e] each.
extern "C" int packed_mm_dx(const void* gy, const void* w,
                            const void* row_ptr, const void* cols,
                            const void* slots, void* dx, int m, int N, int nk,
                            int bk, int bn, int n_act, int branch, int dtype,
                            void* stream) {
  const int* p = static_cast<const int*>(row_ptr);
  return dispatch_mm<true>({gy, w, p, p + 1, static_cast<const int*>(cols),
                            static_cast<const int*>(slots), nullptr, dx, m, N,
                            nk, bk, bn, bn, n_act * bk,
                            static_cast<cudaStream_t>(stream)},
                           branch, dtype);
}

// dw (n_act, bk, bn): slot s is block (rows[s], cols[s]); x is (m, K), gy
// (m, N); f32 sums over m, one cast to the output type.  The m-sum runs in
// `slices` slices of `slice_rows` rows (the last may be shorter); with
// slices > 1, `ws` is an f32 workspace of slices * n_act * tiles * tile
// elements (ops/block_sparse_packed.py, dw_plan) and a second kernel adds
// the partials in slice order.
extern "C" int packed_dw(const void* x, const void* gy, const void* rows,
                         const void* cols, void* dw, void* ws, int m, int K,
                         int N, int n_act, int bk, int bn, int slices,
                         int slice_rows, int dtype, void* stream) {
  return dispatch_dw({x, gy, static_cast<const int*>(rows),
                      static_cast<const int*>(cols), nullptr, dw,
                      static_cast<float*>(ws), m, K, N, n_act, bk, bn, 0,
                      slices, slice_rows, static_cast<cudaStream_t>(stream)},
                     dtype);
}

// Dense storage: W is the (K, N) matrix itself, row-major, and only its
// active (bk, bn) blocks are read.
//
// y (m, nn*bn) = x (m, K) @ W over the actives: output block-column j sums
// entries beg[j] .. end[j]-1, each reading x's block-column rows[e] and the
// W block at element woffs[e] (rows N apart).
extern "C" int dense_mm_fwd(const void* x, const void* w, const void* beg,
                            const void* end, const void* rows,
                            const void* woffs, void* y, int m, int K, int nn,
                            int bk, int bn, int N, int branch, int dtype,
                            void* stream) {
  return dispatch_mm<false>(
      {x, w, static_cast<const int*>(beg), static_cast<const int*>(end),
       static_cast<const int*>(rows), nullptr,
       static_cast<const int*>(woffs), y, m, K, nn, bk, bn, N, K,
       static_cast<cudaStream_t>(stream)},
      branch, dtype);
}

// dx (m, nk*bk) = gy (m, N) @ Wᵀ over the actives: output block-column k
// sums entries beg[k] .. end[k]-1, each reading gy's block-column cols[e]
// and the W block at element woffs[e] (rows N apart), transposed in the
// kernel (no Wᵀ is built).
extern "C" int dense_mm_dx(const void* gy, const void* w, const void* beg,
                           const void* end, const void* cols,
                           const void* woffs, void* dx, int m, int N, int nk,
                           int bk, int bn, int branch, int dtype,
                           void* stream) {
  return dispatch_mm<true>(
      {gy, w, static_cast<const int*>(beg), static_cast<const int*>(end),
       static_cast<const int*>(cols), nullptr,
       static_cast<const int*>(woffs), dx, m, N, nk, bk, bn, N, nk * bk,
       static_cast<cudaStream_t>(stream)},
      branch, dtype);
}

// dw (K, N) += the active blocks of xᵀ @ gy: entry s is block (rows[s],
// cols[s]) and writes it, unless flags is non-null and flags[s] == 0.  The
// caller zeroes dw; f32 sums over m, one cast to the output type; slices
// and ws as for packed_dw.
extern "C" int dense_dw(const void* x, const void* gy, const void* rows,
                        const void* cols, const void* flags, void* dw,
                        void* ws, int m, int K, int N, int n_ent, int bk,
                        int bn, int slices, int slice_rows, int dtype,
                        void* stream) {
  return dispatch_dw({x, gy, static_cast<const int*>(rows),
                      static_cast<const int*>(cols),
                      static_cast<const int*>(flags), dw,
                      static_cast<float*>(ws), m, K, N, n_ent, bk, bn, 1,
                      slices, slice_rows, static_cast<cudaStream_t>(stream)},
                     dtype);
}

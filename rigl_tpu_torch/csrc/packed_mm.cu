// Packed block-sparse matmul and its gradients, with W stored as its active
// (bk, bn) blocks, packed (n_active, bk, bn) in column-major order.  Two
// tiled tensor-core kernels, each for any m, in bf16 or f32:
//
//   packed_mm_kernel<..., kTransW>  behind `packed_mm_fwd` (kTransW = false):
//       y = x @ W;  and behind `packed_mm_dx` (kTransW = true): dx = gy @ Wᵀ.
//   packed_dw_kernel                behind `packed_dw`:
//       dw[s] = x[:, rows[s]*bk : +bk]ᵀ @ gy[:, cols[s]*bn : +bn].
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
// and prefill sizes (m = 1024) all three products are compute-bound.  Each
// kernel streams its two operand tiles through a 3-deep cp.async ring in
// shared memory while the tensor cores (WMMA, bf16 in, f32 accumulate;
// scalar FMA for f32) work on the tile that arrived.
//
// packed_mm_kernel.  One thread block per (m-tile, subtile of one output
// block-column), which walks that column's actives from a CSR -- for the
// forward the per-column list (col_ptr, rows), for dx the per-block-row
// list (row_ptr, cols, slots) of the bwd packing -- and, inside each
// active, the contraction in chunks of BK, accumulating in registers; then
// writes its tile once.  Nothing carries across thread blocks, so no
// atomics and no second pass.  For dx the W tile is needed transposed: the
// (output-subtile x contraction-chunk) region of w[slot] is copied row-major
// into shared memory and read by WMMA as a col_major matrix_b, so no
// transpose is ever materialised.  At m <= 32 (one m-tile) it takes 32 x 32
// tiles and contraction steps of 256 (128 in f32): few, long steps, because
// at decode each thread block's serial chain of steps, not the loads,
// bounds it (PERF.md, section 6).  At m > 32 the tiles are 64 x 64 x 32
// (64 x 64 x 16 in f32).
//
// packed_dw_kernel.  One thread block per (active s, 64-row tile of bk,
// 64-column tile of bn): 13 x 64 = 832 blocks at the training shape (s =
// 0.8, K = N = 4096, block 512).  It walks m in chunks of 32 (16 in f32)
// through the ring: A = the x chunk, stored (m-chunk x bk-tile) row-major
// and read as a col_major matrix_a (xᵀ without a copy), B = the gy chunk,
// row_major.  The TPU's panel variant keeps a block-column's (m, bn) gy
// panel resident in VMEM across that column's actives; here the 50 MB L2
// plays that part (a 1 MB bf16 panel at m = 1024), since the thread blocks
// of neighbouring slots -- the same column's actives -- run together.
//
// Dense storage.  The same two kernels also read W in place as the (K, N)
// matrix of a dense-masked layer, only at its active blocks (`dense_mm_fwd`,
// `dense_mm_dx`, `dense_dw`): a block is found by its element offset
// woffs[e] and rows N apart, instead of by its packed slot and rows bn
// apart; dx reads those blocks transposed, as it reads packed ones, so no
// Wᵀ is built; dw writes each active block into a zeroed (K, N) output.
// These replace the TPU kernels of rigl_tpu/ops/pallas/: `_v4_kernel`
// (block_sparse_v4.py, B7: the flat column-major packing), `_v3_kernel`
// (block_sparse_v3.py, B8: per-column index lists) -- the same sums from
// two index forms, turned here into one list of entries per output
// block-column, [beg[g], end[g]) -- and `_dw_v2_kernel` (block_sparse_v3.py,
// B9), whose grid over all blocks with an active flag is the flags array.
// At ResNet-50's 1x1 shapes (m = 6272 .. 100352 rows, 128 .. 2048
// channels, block 128 x 128, ERK densities) chip_smoke.py computes each
// call's bound from its bytes and its FLOPs on the active blocks.
//
// Ragged m, and bn / bk smaller than a tile, are masked in the kernels (the
// copies zero-fill), so the TPU path's row padding and its dw ValueError on
// an m no bm divides have no counterpart; the wrappers guarantee 16-byte
// aligned rows.  The TPU kernels' x-feed variants, dummy entries and VMEM
// bm clamps are Mosaic machinery with no counterpart here.  Not yet here:
// wgmma / TMA, and split-m for dw.

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
  // bf16 path stages its fragments through the ring's shared memory.
  __device__ __forceinline__ void store(unsigned char* smem, T* out, int ld,
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
          out[static_cast<size_t>(r) * ld + c] = static_cast<T>(scalar[i]);
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

// dw of entry s: thread block (s, tile) computes the (BM x BN) tile at
// (r0, c0) of x[:, rows[s]*bk + r0 ..]ᵀ @ gy[:, cols[s]*bn + c0 ..] over
// all m; x is (m, K), gy is (m, N).  Packed storage (dense = 0): the block
// is dw[s] of (n_active, bk, bn).  Dense storage (dense = 1): it is block
// (rows[s], cols[s]) of a (K, N) dw, and an entry with flags[s] == 0
// (flags non-null) writes nothing.
template <typename T, int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(kThreads)
    packed_dw_kernel(const T* __restrict__ x, const T* __restrict__ gy,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const int* __restrict__ flags, T* __restrict__ dw, int m,
                     int K, int N, int bk, int bn, int dense) {
  using L = DwRing<T, BM, BN, BK, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  if (flags && flags[s] == 0) return;   // uniform: before any barrier
  const int tiles_n = (bn + BN - 1) / BN;
  const int r0 = (blockIdx.y / tiles_n) * BM;
  const int c0 = (blockIdx.y % tiles_n) * BN;
  const T* xa = x + static_cast<size_t>(rows[s]) * bk + r0;
  const T* ga = gy + static_cast<size_t>(cols[s]) * bn + c0;
  const int total = (m + BK - 1) / BK;

  auto a_tile = [&](int st) {
    return reinterpret_cast<T*>(smem + st * L::kStageBytes);
  };
  auto b_tile = [&](int st) {
    return reinterpret_cast<T*>(smem + st * L::kStageBytes + L::kABytes);
  };
  auto load = [&](int it, int st) {
    const int mm0 = it * BK;
    load_tile<T, BK, BM>(a_tile(st), L::kAld,
                         xa + static_cast<size_t>(mm0) * K, K, m - mm0,
                         bk - r0, x);
    load_tile<T, BK, BN>(b_tile(st), L::kBld,
                         ga + static_cast<size_t>(mm0) * N, N, m - mm0,
                         bn - c0, gy);
  };

  using A = Acc<T, BM, BN>;
  A acc;
  acc.zero();
  const int warp = tid / 32, wr = warp / 2, wc = warp % 2;

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
    const T* xs = a_tile(it % STAGES);
    const T* gs = b_tile(it % STAGES);
    if constexpr (A::kBf16) {
      using namespace nvcuda;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> af[A::FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf[A::FN];
#pragma unroll
        for (int i = 0; i < A::FM; ++i)
          wmma::load_matrix_sync(
              af[i], xs + kk * L::kAld + wr * (BM / 2) + i * 16, L::kAld);
#pragma unroll
        for (int j = 0; j < A::FN; ++j)
          wmma::load_matrix_sync(
              bf[j], gs + kk * L::kBld + wc * (BN / 2) + j * 16, L::kBld);
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
          acc.scalar[i] += static_cast<float>(xs[k * L::kAld + r]) *
                           static_cast<float>(gs[k * L::kBld + c]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const int out_ld = dense ? N : bn;
  T* out = dense ? dw + static_cast<size_t>(rows[s]) * bk * N +
                       static_cast<size_t>(cols[s]) * bn
                 : dw + static_cast<size_t>(s) * bk * bn;
  acc.store(smem, out + static_cast<size_t>(r0) * out_ld + c0, out_ld,
            bk - r0, bn - c0);
}

// Above 48 KB, dynamic shared memory must be allowed per kernel and device:
// once for each (instantiation, device), not on every launch.
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

template <typename T, int BM, int BN, int BK, int STAGES, bool kTransW>
cudaError_t launch_mm(const void* x, const void* w, const int* beg,
                      const int* end, const int* seg_idx, const int* slots,
                      const int* woffs, void* y, int m, int x_ld, int ngroups,
                      int out_w, int bk, int bn, int w_ld,
                      cudaStream_t stream) {
  constexpr int smem = MmRing<T, BM, BN, BK, STAGES, kTransW>::kSmemBytes;
  auto kernel = packed_mm_kernel<T, BM, BN, BK, STAGES, kTransW>;
  static std::atomic<uint64_t> allowed{0};   // bit d: done on device d
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((m + BM - 1) / BM, ngroups * ((out_w + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), beg, end, seg_idx,
      slots, woffs, static_cast<T*>(y), m, x_ld, ngroups * out_w, bk, bn,
      w_ld);
  return cudaGetLastError();
}

template <bool kTransW>
int dispatch_mm(const void* x, const void* w, const int* b, const int* e,
                const void* seg_idx, const void* slots, const void* woffs,
                void* y, int m, int x_ld, int ngroups, int bk, int bn,
                int w_ld, int dtype, void* stream) {
  if (m <= 0 || ngroups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* si = static_cast<const int*>(seg_idx);
  const int* sl = static_cast<const int*>(slots);
  const int* wo = static_cast<const int*>(woffs);
  const int out_w = kTransW ? bk : bn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = m <= 32;   // one m-tile: narrow tiles, long steps
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) {
    using B = __nv_bfloat16;
    err = small ? launch_mm<B, 32, 32, 256, 3, kTransW>(
                      x, w, b, e, si, sl, wo, y, m, x_ld, ngroups, out_w, bk,
                      bn, w_ld, st)
                : launch_mm<B, 64, 64, 32, 3, kTransW>(
                      x, w, b, e, si, sl, wo, y, m, x_ld, ngroups, out_w, bk,
                      bn, w_ld, st);
  } else if (dtype == 0) {
    err = small ? launch_mm<float, 32, 32, 128, 3, kTransW>(
                      x, w, b, e, si, sl, wo, y, m, x_ld, ngroups, out_w, bk,
                      bn, w_ld, st)
                : launch_mm<float, 64, 64, 16, 3, kTransW>(
                      x, w, b, e, si, sl, wo, y, m, x_ld, ngroups, out_w, bk,
                      bn, w_ld, st);
  }
  return static_cast<int>(err);
}

template <typename T, int BM, int BN, int BK, int STAGES>
cudaError_t launch_dw(const void* x, const void* gy, const int* rows,
                      const int* cols, const int* flags, void* dw, int m,
                      int K, int N, int n_act, int bk, int bn, int dense,
                      cudaStream_t stream) {
  constexpr int smem = DwRing<T, BM, BN, BK, STAGES>::kSmemBytes;
  auto kernel = packed_dw_kernel<T, BM, BN, BK, STAGES>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(n_act, ((bk + BM - 1) / BM) * ((bn + BN - 1) / BN));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gy), rows, cols, flags,
      static_cast<T*>(dw), m, K, N, bk, bn, dense);
  return cudaGetLastError();
}

int dispatch_dw(const void* x, const void* gy, const void* rows,
                const void* cols, const void* flags, void* dw, int m, int K,
                int N, int n_ent, int bk, int bn, int dense, int dtype,
                void* stream) {
  if (m <= 0 || n_ent <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const int* f = static_cast<const int*>(flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1)
    err = launch_dw<__nv_bfloat16, 64, 64, 32, 3>(x, gy, r, c, f, dw, m, K, N,
                                                  n_ent, bk, bn, dense, st);
  else if (dtype == 0)
    err = launch_dw<float, 64, 64, 16, 3>(x, gy, r, c, f, dw, m, K, N, n_ent,
                                          bk, bn, dense, st);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each entry point launches its kernel
// once and returns cudaGetLastError() after the launch (0 = launched).  All
// run on `stream` and allocate nothing.

// y (m, nn*bn) = x (m, nk*bk) @ W; column j's actives are packed slots
// col_ptr[j] .. col_ptr[j+1]-1, block-row rows[a] each.
extern "C" int packed_mm_fwd(const void* x, const void* w, const void* col_ptr,
                             const void* rows, void* y, int m, int K, int nn,
                             int bk, int bn, int dtype, void* stream) {
  const int* p = static_cast<const int*>(col_ptr);
  return dispatch_mm<false>(x, w, p, p + 1, rows, nullptr, nullptr, y, m, K,
                            nn, bk, bn, bn, dtype, stream);
}

// dx (m, nk*bk) = gy (m, nn*bn) @ Wᵀ; block-row k's actives are entries
// row_ptr[k] .. row_ptr[k+1]-1, block-column cols[e] and packed slot
// slots[e] each.
extern "C" int packed_mm_dx(const void* gy, const void* w,
                            const void* row_ptr, const void* cols,
                            const void* slots, void* dx, int m, int N, int nk,
                            int bk, int bn, int dtype, void* stream) {
  const int* p = static_cast<const int*>(row_ptr);
  return dispatch_mm<true>(gy, w, p, p + 1, cols, slots, nullptr, dx, m, N,
                           nk, bk, bn, bn, dtype, stream);
}

// dw (n_act, bk, bn): slot s is block (rows[s], cols[s]); x is (m, K), gy
// (m, N); f32 sums over m, one cast to the output type.
extern "C" int packed_dw(const void* x, const void* gy, const void* rows,
                         const void* cols, void* dw, int m, int K, int N,
                         int n_act, int bk, int bn, int dtype, void* stream) {
  return dispatch_dw(x, gy, rows, cols, nullptr, dw, m, K, N, n_act, bk, bn,
                     0, dtype, stream);
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
                            int bk, int bn, int N, int dtype, void* stream) {
  return dispatch_mm<false>(x, w, static_cast<const int*>(beg),
                            static_cast<const int*>(end), rows, nullptr,
                            woffs, y, m, K, nn, bk, bn, N, dtype, stream);
}

// dx (m, nk*bk) = gy (m, N) @ Wᵀ over the actives: output block-column k
// sums entries beg[k] .. end[k]-1, each reading gy's block-column cols[e]
// and the W block at element woffs[e] (rows N apart), transposed in the
// kernel (no Wᵀ is built).
extern "C" int dense_mm_dx(const void* gy, const void* w, const void* beg,
                           const void* end, const void* cols,
                           const void* woffs, void* dx, int m, int N, int nk,
                           int bk, int bn, int dtype, void* stream) {
  return dispatch_mm<true>(gy, w, static_cast<const int*>(beg),
                           static_cast<const int*>(end), cols, nullptr, woffs,
                           dx, m, N, nk, bk, bn, N, dtype, stream);
}

// dw (K, N) += the active blocks of xᵀ @ gy: entry s is block (rows[s],
// cols[s]) and writes it, unless flags is non-null and flags[s] == 0.  The
// caller zeroes dw; f32 sums over m, one cast to the output type.
extern "C" int dense_dw(const void* x, const void* gy, const void* rows,
                        const void* cols, const void* flags, void* dw, int m,
                        int K, int N, int n_ent, int bk, int bn, int dtype,
                        void* stream) {
  return dispatch_dw(x, gy, rows, cols, flags, dw, m, K, N, n_ent, bk, bn, 1,
                     dtype, stream);
}

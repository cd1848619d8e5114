// Causal flash attention, forward and backward, for q, k, v of (B, H, S, hd),
// contiguous, hd in {32, 64, 128}: three tiled tensor-core kernels for
// bf16, and f32 variants of the three on the CUDA cores (section "f32"
// below, behind the entry points with an `_f32` suffix).
//
//   flash_fwd_kernel      behind `flash_fwd`:
//       o = softmax(scale * q kᵀ + causal mask) v, and the f32 row statistic
//       lse = m + log(l) (row max m, row sum l of exp(logit - m)).
//   flash_bwd_dkv_kernel  behind `flash_bwd_dkv`:  dk, dv.
//   flash_bwd_dq_kernel   behind `flash_bwd_dq`:   dq.
//
// Replace the three pallas_calls of JAX's shipped TPU kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// rigl_tpu/models/packed_transformer.py:_flash_attention calls with
// causal=True: the forward `_flash_attention_impl` (kernel
// `_flash_attention_kernel`), `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq`, joined there by a custom_vjp and here by
// rigl_tpu_torch/ops/flash_attention.py's autograd Function.  Same maths:
// P = exp(scale * q kᵀ - lse) is recomputed from the saved statistic, D =
// rowsum(do * o) comes from the caller (JAX computes it outside its kernels
// too), dS = P * (do vᵀ - D) * scale is rounded to the input type before
// its two products, as JAX's kernels round it, and every product sums in f32.
//
// What bounds them on an H100: at the bench shape (B, H, S, hd) = (4, 16,
// 512, 128) each kernel moves 34-50 MB and does 4-9 GFLOP of causal work,
// so the bytes (10-15 us at 3.35 TB/s) bound it, not the tensor cores (4-9
// us at 989 TFLOP/s).  The design keeps the (S, S) logits out of device
// memory: a thread block owns one 64-row tile of q (forward, dq) or of k
// (dk/dv), keeps its operand tiles and its f32 sums on chip, and streams
// the other side's 64-row tiles through a 2-deep cp.async ring in shared
// memory, visiting only the tiles on or below the diagonal (causal skip).
// Nothing carries across thread blocks, so there are no atomics: dk/dv and
// dq are two kernels, as in JAX, and each output tile is written once.  In
// f32 the same work runs at 67 TFLOP/s on the CUDA cores and moves twice
// the bytes, so the operations bound it (64-128 us at that shape, against
// 20-30 us of bytes).
//
// bf16 products use WMMA (bf16 in, f32 accumulate).  WMMA's accumulator
// layout is opaque, so the logits go through shared memory in f32 for the
// masked softmax, and the forward's output accumulator lives in registers, one
// (row, half-row) per thread, where the online-softmax rescale is a scalar
// multiply.  A ragged S (not a multiple of 64) is zero-filled in the copies
// and masked by position, so JAX's 128-multiple requirement (MIN_BLOCK_SIZE)
// has no counterpart.  Not yet here: wgmma / TMA, and warp-level softmax on
// mma.sync fragments without the shared-memory round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                    float>;

constexpr int kTile = 64;             // rows of a q tile and of a k tile
constexpr float kMasked = -1e30f;     // finite: exp(kMasked - kMasked) = 1

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

// Rows r0 .. r0 + kRows - 1 of a (S x HD) row-major matrix into shared
// memory with row stride `ld`, as 16-byte cp.asyncs; rows >= S zero-filled.
template <int HD, int NT, int kRows = kTile, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int r0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kPerRow; c += NT) {
    const int r = c / kPerRow, cc = (c % kPerRow) * kVec;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + cc,
               ok ? src + static_cast<size_t>(r0 + r) * HD + cc : src, ok);
  }
}

__device__ __forceinline__ void zero(Frag& f) {
  nvcuda::wmma::fill_fragment(f, 0.f);
}

// acc (FM x FN 16x16 tiles) += A @ B over DEPTH, A row-major (or, with
// kATrans, Aᵀ read from a row-major matrix: `a` then points at its column
// offset), B row-major.  Pointers are at the warp's tile origin.
template <int FM, int FN, int DEPTH, bool kATrans>
__device__ __forceinline__ void mma_ab(Frag (&acc)[FM][FN], const bf16* a,
                                       int lda, const bf16* b, int ldb) {
  using namespace nvcuda;
  using ALayout = std::conditional_t<kATrans, wmma::col_major,
                                     wmma::row_major>;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      wmma::load_matrix_sync(
          fa[i], kATrans ? a + kk * lda + i * 16 : a + i * 16 * lda + kk,
          lda);
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::load_matrix_sync(fb[j], b + kk * ldb + j * 16, ldb);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
}

// C = A @ Bᵀ over DEPTH (A (rows x DEPTH), B (cols x DEPTH), both
// row-major), stored f32 into shared memory at `c` (row stride ldc).
template <int FM, int FN, int DEPTH>
__device__ __forceinline__ void mma_abt_store(const bf16* a, int lda,
                                              const bf16* b, int ldb,
                                              float* c, int ldc) {
  using namespace nvcuda;
  Frag acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) zero(acc[i][j]);
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      wmma::load_matrix_sync(fa[i], a + i * 16 * lda + kk, lda);
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::load_matrix_sync(fb[j], b + j * 16 * ldb + kk, ldb);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(c + i * 16 * ldc + j * 16, acc[i][j], ldc,
                              wmma::mem_row_major);
}

template <int FM, int FN>
__device__ __forceinline__ void store_acc(Frag (&acc)[FM][FN], float* c,
                                          int ldc, float mul) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
#pragma unroll
      for (int t = 0; t < acc[i][j].num_elements; ++t) acc[i][j].x[t] *= mul;
      nvcuda::wmma::store_matrix_sync(c + i * 16 * ldc + j * 16, acc[i][j],
                                      ldc, nvcuda::wmma::mem_row_major);
    }
}

// Writes the rows r0 .. of a (kTile x HD) f32 tile staged in shared memory
// (row stride ld) to a (S x HD) bf16 matrix, rows >= S dropped; coalesced.
template <int HD, int NT>
__device__ __forceinline__ void write_rows(bf16* dst, const float* stage,
                                           int ld, int r0, int S) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD;
    if (r0 + r < S)
      dst[static_cast<size_t>(r0 + r) * HD + c] =
          __float2bfloat16(stage[r * ld + c]);
  }
}

// Shared-memory plan, in bytes.  bf16 tiles (kTile x HD) have row stride
// HD + 8 and f32 tiles kTile (+4) or HD (+4): the pads keep fragment loads
// off a single bank and every row start 32-byte aligned, as WMMA needs.
template <int HD>
struct Plan {
  static constexpr int kLd = HD + 8;          // bf16 (kTile x HD) tiles
  static constexpr int kTileBytes = kTile * kLd * 2;
  static constexpr int kSld = kTile + 4;      // f32 (kTile x kTile)
  static constexpr int kSBytes = kTile * kSld * 4;
  static constexpr int kOld = HD + 4;         // f32 (kTile x HD)
  static constexpr int kOBytes = kTile * kOld * 4;
  static constexpr int kPld = kTile + 8;      // bf16 (kTile x kTile)
  static constexpr int kPBytes = kTile * kPld * 2;
  static_assert(HD % 32 == 0 && HD <= 128, "head dim");
};

// ------------------------------------------------------------ forward ----
// One thread block (4 warps) per (64-row q tile, b * h).  Thread t owns
// row t / 2 of the tile and half t % 2 of its columns for the softmax and
// the output accumulator.
template <int HD>
struct FwdPlan : Plan<HD> {
  using P = Plan<HD>;
  static constexpr int kThreads = 128;
  static constexpr int kQ = 0;
  static constexpr int kRing = P::kTileBytes;   // stage s: K, then V
  static constexpr int kScratch = kRing + 4 * P::kTileBytes;
  static constexpr int kScratchBytes =
      P::kSBytes > P::kOBytes ? P::kSBytes : P::kOBytes;
  static constexpr int kPs = kScratch + kScratchBytes;
  static constexpr int kBytes = kPs + P::kPBytes;
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

template <int HD>
__global__ void __launch_bounds__(128)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, float scale) {
  using L = FwdPlan<HD>;
  constexpr int NT = L::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  float* ss = reinterpret_cast<float*>(smem + L::kScratch);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::kPs);
  auto k_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes +
                                   L::kTileBytes);
  };

  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const bf16* qg = q + base;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const int tid = threadIdx.x, warp = tid / 32, wr = warp / 2, wc = warp % 2;
  const int r = tid >> 1, h = tid & 1;        // this thread's row and half
  const int qrow = q0 + r;
  const int n_kt = qt + 1;                    // k tiles on or below the diag

  load_rows<HD, NT>(qs, L::kLd, qg, q0, S);
  load_rows<HD, NT>(k_tile(0), L::kLd, kg, 0, S);
  load_rows<HD, NT>(v_tile(0), L::kLd, vg, 0, S);
  cp_async_commit();

  float m_run = kMasked, l_run = 0.f;
  float acc[HD / 2];
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) acc[c] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      load_rows<HD, NT>(k_tile(st ^ 1), L::kLd, kg, (j + 1) * kTile, S);
      load_rows<HD, NT>(v_tile(st ^ 1), L::kLd, vg, (j + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait<1>();     // tile j (and q) have landed for this thread
    __syncthreads();        // ... and for every thread

    // S = q kᵀ: warp (wr, wc) computes the 32 x 32 tile at (32 wr, 32 wc).
    mma_abt_store<2, 2, HD>(qs + wr * 32 * L::kLd, L::kLd,
                            k_tile(st) + wc * 32 * L::kLd, L::kLd,
                            ss + wr * 32 * L::kSld + wc * 32, L::kSld);
    __syncthreads();

    // Online softmax of row r, columns 32 h .. 32 h + 31 (two passes over
    // the staged logits: the row max, then the exponentials).
    const int k0 = j * kTile;
    const float* srow = ss + r * L::kSld + h * 32;
    float mx = kMasked;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + h * 32 + c;
      if (kpos <= qrow && kpos < S) mx = fmaxf(mx, srow[c] * scale);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    float sum = 0.f;
    bf16* prow = ps + r * L::kPld + h * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int kpos = k0 + h * 32 + c;
      const float p = (kpos <= qrow && kpos < S)
                          ? __expf(srow[c] * scale - m_new) : 0.f;
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = __expf(m_run - m_new);
    l_run = l_run * corr + sum;
    m_run = m_new;
    __syncthreads();        // P complete; the logits' scratch is free

    // PV = P v: warp (wr, wc) computes rows 32 wr.., columns HD/2 wc..,
    // staged in f32 over the logits' scratch.
    {
      Frag pv[2][HD / 32];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < HD / 32; ++jj) zero(pv[i][jj]);
      mma_ab<2, HD / 32, kTile, false>(pv, ps + wr * 32 * L::kPld, L::kPld,
                                       v_tile(st) + wc * (HD / 2), L::kLd);
      store_acc<2, HD / 32>(pv, ss + wr * 32 * L::kOld + wc * (HD / 2),
                            L::kOld, 1.f);
    }
    __syncthreads();
    const float* pvrow = ss + r * L::kOld + h * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) acc[c] = acc[c] * corr + pvrow[c];
    __syncthreads();        // stage st and the scratch are free again
  }

  // o = acc / l, staged in f32 and written coalesced; lse = m + log l.
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  float* orow = ss + r * L::kOld + h * (HD / 2);
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) orow[c] = acc[c] * inv;
  if (h == 0 && qrow < S)
    lse[static_cast<size_t>(blockIdx.y) * S + qrow] = m_run + logf(l_run);
  __syncthreads();
  write_rows<HD, NT>(o + base, ss, L::kOld, q0, S);
}

// ----------------------------------------------------------- backward ----
// Both backward kernels: 8 warps, laid out 4 x 2 over a 64 x 64 logit tile
// (16 x 32 each) and over a 64 x HD output tile (16 x HD/2 each).  The
// elementwise pass gives thread t row t / 4 and columns 16 (t % 4) .. + 15.
constexpr int kBwdThreads = 256;

// P and dS of one (q tile, k tile) pair, from the staged logits `ss` and
// dP = do vᵀ `dps`: P = exp(scale * s - lse) on or below the diagonal (0
// elsewhere and on rows >= S), dS = P * (dP - D) * scale.  Writes dS (and,
// with kWriteP, P) as bf16 with row stride pld.
template <bool kWriteP>
__device__ __forceinline__ void p_and_ds(const float* ss, const float* dps,
                                         int sld, bf16* ps, bf16* dss,
                                         int pld, int q0, int k0, int S,
                                         float lse_r, float d_r,
                                         float scale) {
  const int r = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  const int qpos = q0 + r;
#pragma unroll
  for (int c = c0; c < c0 + 16; ++c) {
    const int kpos = k0 + c;
    const bool ok = kpos <= qpos && qpos < S;
    const float p = ok ? __expf(ss[r * sld + c] * scale - lse_r) : 0.f;
    const float ds = p * (dps[r * sld + c] - d_r) * scale;
    if constexpr (kWriteP) ps[r * pld + c] = __float2bfloat16(p);
    dss[r * pld + c] = __float2bfloat16(ds);
  }
}

// dk/dv: one thread block per (64-row k tile, b * h), k and v resident; the
// q tiles at or below the diagonal stream through a 2-deep ring of (q, do).
template <int HD>
struct DkvPlan : Plan<HD> {
  using P = Plan<HD>;
  static constexpr int kK = 0;
  static constexpr int kV = P::kTileBytes;
  static constexpr int kRing = 2 * P::kTileBytes;   // stage s: q, then do
  static constexpr int kS = kRing + 4 * P::kTileBytes;
  static constexpr int kDp = kS + P::kSBytes;
  static constexpr int kPs = kDp + P::kSBytes;
  static constexpr int kDs = kPs + P::kPBytes;
  static constexpr int kBytes = kDs + P::kPBytes;
  static_assert(2 * P::kOBytes <= 4 * P::kTileBytes, "output staging");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         float scale) {
  using L = DkvPlan<HD>;
  constexpr int NT = kBwdThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::kV);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  float* dps = reinterpret_cast<float*>(smem + L::kDp);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::kPs);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::kDs);
  auto q_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes);
  };
  auto do_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes +
                                   L::kTileBytes);
  };

  const int kt = blockIdx.x;
  const int k0 = kt * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * HD;
  const bf16* qg = q + base;
  const bf16* dog = dout + base;
  const float* lse_g = lse + bh * S;
  const float* d_g = dsum + bh * S;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int r = threadIdx.x >> 2;             // elementwise row
  const int n_qt = (S + kTile - 1) / kTile;

  load_rows<HD, NT>(ks, L::kLd, k + base, k0, S);
  load_rows<HD, NT>(vs, L::kLd, v + base, k0, S);
  load_rows<HD, NT>(q_tile(0), L::kLd, qg, k0, S);   // first q tile = kt
  load_rows<HD, NT>(do_tile(0), L::kLd, dog, k0, S);
  cp_async_commit();

  Frag acc_dk[1][HD / 32], acc_dv[1][HD / 32];
#pragma unroll
  for (int jj = 0; jj < HD / 32; ++jj) {
    zero(acc_dk[0][jj]);
    zero(acc_dv[0][jj]);
  }

  for (int i = kt; i < n_qt; ++i) {
    const int st = (i - kt) & 1;
    const int q0 = i * kTile;
    if (i + 1 < n_qt) {
      load_rows<HD, NT>(q_tile(st ^ 1), L::kLd, qg, q0 + kTile, S);
      load_rows<HD, NT>(do_tile(st ^ 1), L::kLd, dog, q0 + kTile, S);
    }
    cp_async_commit();
    const float lse_r = q0 + r < S ? lse_g[q0 + r] : 0.f;
    const float d_r = q0 + r < S ? d_g[q0 + r] : 0.f;
    cp_async_wait<1>();
    __syncthreads();

    // s = q kᵀ and dP = do vᵀ (q rows x k columns), f32 in shared memory.
    mma_abt_store<1, 2, HD>(q_tile(st) + wr * 16 * L::kLd, L::kLd,
                            ks + wc * 32 * L::kLd, L::kLd,
                            ss + wr * 16 * L::kSld + wc * 32, L::kSld);
    mma_abt_store<1, 2, HD>(do_tile(st) + wr * 16 * L::kLd, L::kLd,
                            vs + wc * 32 * L::kLd, L::kLd,
                            dps + wr * 16 * L::kSld + wc * 32, L::kSld);
    __syncthreads();
    p_and_ds<true>(ss, dps, L::kSld, ps, dss, L::kPld, q0, k0, S, lse_r, d_r,
                   scale);
    __syncthreads();

    // dv += Pᵀ do and dk += dSᵀ q (k rows x HD): Pᵀ and dSᵀ are read as
    // col_major fragments of the row-major (q x k) tiles, not transposed.
    mma_ab<1, HD / 32, kTile, true>(acc_dv, ps + wr * 16, L::kPld,
                                    do_tile(st) + wc * (HD / 2), L::kLd);
    mma_ab<1, HD / 32, kTile, true>(acc_dk, dss + wr * 16, L::kPld,
                                    q_tile(st) + wc * (HD / 2), L::kLd);
    __syncthreads();        // stage st and the tiles are free again
  }
  cp_async_wait<0>();
  __syncthreads();

  // Stage both (k rows x HD) f32 tiles over the ring, then write them.
  float* dk_stage = reinterpret_cast<float*>(smem + L::kRing);
  float* dv_stage = dk_stage + kTile * L::kOld;
  store_acc<1, HD / 32>(acc_dk, dk_stage + wr * 16 * L::kOld + wc * (HD / 2),
                        L::kOld, 1.f);
  store_acc<1, HD / 32>(acc_dv, dv_stage + wr * 16 * L::kOld + wc * (HD / 2),
                        L::kOld, 1.f);
  __syncthreads();
  write_rows<HD, NT>(dk + base, dk_stage, L::kOld, k0, S);
  write_rows<HD, NT>(dv + base, dv_stage, L::kOld, k0, S);
}

// dq: one thread block per (64-row q tile, b * h), q and do resident; the k
// tiles at or below the diagonal stream through a 2-deep ring of (k, v).
template <int HD>
struct DqPlan : Plan<HD> {
  using P = Plan<HD>;
  static constexpr int kQ = 0;
  static constexpr int kDo = P::kTileBytes;
  static constexpr int kRing = 2 * P::kTileBytes;   // stage s: k, then v
  static constexpr int kS = kRing + 4 * P::kTileBytes;
  static constexpr int kDp = kS + P::kSBytes;
  static constexpr int kDs = kDp + P::kSBytes;
  static constexpr int kBytes = kDs + P::kPBytes;
  static_assert(P::kOBytes <= 4 * P::kTileBytes, "output staging");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        bf16* __restrict__ dq, int S, float scale) {
  using L = DqPlan<HD>;
  constexpr int NT = kBwdThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* dos = reinterpret_cast<bf16*>(smem + L::kDo);
  float* ss = reinterpret_cast<float*>(smem + L::kS);
  float* dps = reinterpret_cast<float*>(smem + L::kDp);
  bf16* dss = reinterpret_cast<bf16*>(smem + L::kDs);
  auto k_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<bf16*>(smem + L::kRing + st * 2 * L::kTileBytes +
                                   L::kTileBytes);
  };

  const int qt = blockIdx.x;
  const int q0 = qt * kTile;
  const size_t bh = blockIdx.y;
  const size_t base = bh * S * HD;
  const bf16* kg = k + base;
  const bf16* vg = v + base;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int r = threadIdx.x >> 2;
  const float lse_r = q0 + r < S ? lse[bh * S + q0 + r] : 0.f;
  const float d_r = q0 + r < S ? dsum[bh * S + q0 + r] : 0.f;
  const int n_kt = qt + 1;

  load_rows<HD, NT>(qs, L::kLd, q + base, q0, S);
  load_rows<HD, NT>(dos, L::kLd, dout + base, q0, S);
  load_rows<HD, NT>(k_tile(0), L::kLd, kg, 0, S);
  load_rows<HD, NT>(v_tile(0), L::kLd, vg, 0, S);
  cp_async_commit();

  Frag acc[1][HD / 32];
#pragma unroll
  for (int jj = 0; jj < HD / 32; ++jj) zero(acc[0][jj]);

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      load_rows<HD, NT>(k_tile(st ^ 1), L::kLd, kg, (j + 1) * kTile, S);
      load_rows<HD, NT>(v_tile(st ^ 1), L::kLd, vg, (j + 1) * kTile, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    mma_abt_store<1, 2, HD>(qs + wr * 16 * L::kLd, L::kLd,
                            k_tile(st) + wc * 32 * L::kLd, L::kLd,
                            ss + wr * 16 * L::kSld + wc * 32, L::kSld);
    mma_abt_store<1, 2, HD>(dos + wr * 16 * L::kLd, L::kLd,
                            v_tile(st) + wc * 32 * L::kLd, L::kLd,
                            dps + wr * 16 * L::kSld + wc * 32, L::kSld);
    __syncthreads();
    p_and_ds<false>(ss, dps, L::kSld, nullptr, dss, L::kPld, q0, j * kTile,
                    S, lse_r, d_r, scale);
    __syncthreads();

    // dq += dS k (q rows x HD).
    mma_ab<1, HD / 32, kTile, false>(acc, dss + wr * 16 * L::kPld, L::kPld,
                                     k_tile(st) + wc * (HD / 2), L::kLd);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* stage = reinterpret_cast<float*>(smem + L::kRing);
  store_acc<1, HD / 32>(acc, stage + wr * 16 * L::kOld + wc * (HD / 2),
                        L::kOld, 1.f);
  __syncthreads();
  write_rows<HD, NT>(dq + base, stage, L::kOld, q0, S);
}

// ---------------------------------------------------------------- f32 ----
// The three kernels for f32 q, k, v: the same maths with every product and
// P and dS in f32 (nothing rounds to bf16), on the CUDA cores (FFMA) rather
// than on tensor cores, so the sums are full f32 as torch's f32 matmuls
// are; single-pass TF32 keeps 10 mantissa bits and would miss 1e-4.  A
// thread block of 128 threads owns one 32-row tile (kF32Tile) and streams
// the other side's 32-row tiles through a 2-deep cp.async ring; at hd 128
// the f32 tiles are twice the bf16 bytes, and 32-row tiles keep the
// backward's resident pair, its ring and P / dS within 111 KB.  Thread t
// holds rows (t / 16) + 8 i, i < 4, and columns (t % 16) + 16 j of each
// (32 x 32) logit tile and (32 x HD) output tile in registers, so the
// logits never go through shared memory: a row's max and sum are
// shuffles across the 16 lanes that hold it.  P (forward, dK/dV) and dS
// are staged in shared memory for the products that contract over them.
constexpr int kF32Tile = 32;
constexpr int kF32Threads = 128;

template <int HD>
struct F32Plan {
  static constexpr int kLd = HD + 4;          // floats; 16-byte row starts
  static constexpr int kTileBytes = kF32Tile * kLd * 4;
  static constexpr int kPld = kF32Tile + 4;   // (32 x 32) P / dS tiles
  static constexpr int kPBytes = kF32Tile * kPld * 4;
  // Two resident tiles, a ring of two stages of two tiles, P and dS.
  static constexpr int kBytes = 6 * kTileBytes + 2 * kPBytes;
  static_assert(HD % 16 == 0 && HD <= 128, "head dim");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// c[i][j] = sum_d a[row_i][d] * b[col_j][d] over HD, rows (t / 16) + 8 i of
// `a` and rows (t % 16) + 16 j of `b`, both f32 row-major with stride ld:
// the (32 x 32) tile of a bᵀ this thread holds.
template <int HD>
__device__ __forceinline__ void f32_abt(const float* a, const float* b,
                                        int ld, float (&c)[4][2]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i][0] = c[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (tr + 8 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tc + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        c[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y +
                   av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_k p(row_i, k) * b[k][(t % 16) + 16 c] over the 32 rows
// of b (row stride ld), with p(r, k) = ps[r * pld + k] (kTrans: ps[k * pld
// + r], a transposed read of the staged tile), rows r = (t / 16) + 8 i.
template <int HD, bool kTrans>
__device__ __forceinline__ void f32_pb(const float* ps, int pld,
                                       const float* b, int ld,
                                       float (&acc)[4][HD / 16]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < kF32Tile; ++k) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = kTrans ? ps[k * pld + tr + 8 * i] : ps[(tr + 8 * i) * pld + k];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) {
      const float bv = b[k * ld + tc + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] += pv[i] * bv;
    }
  }
}

// Max and sum over the 16 lanes that hold one row.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Writes this thread's rows of a (32 x HD) f32 accumulator, times mul[i],
// to rows r0 .. of a (S x HD) matrix, rows >= S dropped.
template <int HD>
__device__ __forceinline__ void f32_write(float* dst,
                                          const float (&acc)[4][HD / 16],
                                          const float (&mul)[4], int r0,
                                          int S) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + 8 * i;
    if (r < S)
#pragma unroll
      for (int c = 0; c < HD / 16; ++c)
        dst[static_cast<size_t>(r) * HD + tc + 16 * c] = acc[i][c] * mul[i];
  }
}

// Forward: one block per (32-row q tile, b * h); q resident, (k, v) tiles
// on or below the diagonal through the ring; online softmax in registers.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, float scale) {
  using L = F32Plan<HD>;
  constexpr int NT = kF32Threads, T = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ps = reinterpret_cast<float*>(smem + 6 * L::kTileBytes);
  auto k_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (2 + 2 * st) * L::kTileBytes);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (3 + 2 * st) * L::kTileBytes);
  };
  const int qt = blockIdx.x, q0 = qt * T;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int n_kt = qt + 1;

  load_rows<HD, NT, T>(qs, L::kLd, q + base, q0, S);
  load_rows<HD, NT, T>(k_tile(0), L::kLd, k + base, 0, S);
  load_rows<HD, NT, T>(v_tile(0), L::kLd, v + base, 0, S);
  cp_async_commit();

  float m_run[4], l_run[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kMasked;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;
  }
  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      load_rows<HD, NT, T>(k_tile(st ^ 1), L::kLd, k + base, (j + 1) * T, S);
      load_rows<HD, NT, T>(v_tile(st ^ 1), L::kLd, v + base, (j + 1) * T, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[4][2];
    f32_abt<HD>(qs, k_tile(st), L::kLd, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 8 * i;
      bool ok[2];
      float mx = kMasked;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kpos = j * T + tc + 16 * jj;
        ok[jj] = kpos <= qpos && kpos < S;
        s[i][jj] *= scale;
        if (ok[jj]) mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m_run[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        sum += p;
        ps[(tr + 8 * i) * L::kPld + tc + 16 * jj] = p;
      }
      const float corr = expf(m_run[i] - m_new);
      l_run[i] = l_run[i] * corr + row_sum16(sum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();   // P complete
    f32_pb<HD, false>(ps, L::kPld, v_tile(st), L::kLd, acc);
    __syncthreads();   // stage st and P free again
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = l_run[i] > 0.f ? 1.f / l_run[i] : 0.f;
    const int qpos = q0 + tr + 8 * i;
    if (tc == 0 && qpos < S)
      lse[static_cast<size_t>(blockIdx.y) * S + qpos] =
          m_run[i] + logf(l_run[i]);
  }
  f32_write<HD>(o + base, acc, inv, q0, S);
}

// This thread's P and dS of one (q tile at q0, k tile at k0) pair from the
// logits s = q kᵀ and dp = do vᵀ it holds: P = exp(scale s - lse) on or
// below the diagonal and on rows < S (0 elsewhere), dS = P (dp - D) scale;
// both f32, staged at ps / dss (row stride pld) when non-null.
__device__ __forceinline__ void f32_p_and_ds(const float (&s)[4][2],
                                             const float (&dp)[4][2],
                                             const float (&lse_r)[4],
                                             const float (&d_r)[4], int q0,
                                             int k0, int S, float scale,
                                             float* ps, float* dss, int pld) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 8 * i;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int kpos = k0 + tc + 16 * jj;
      const bool ok = kpos <= qpos && qpos < S;
      const float p = ok ? expf(s[i][jj] * scale - lse_r[i]) : 0.f;
      const int at = (tr + 8 * i) * pld + tc + 16 * jj;
      if (ps) ps[at] = p;
      dss[at] = p * (dp[i][jj] - d_r[i]) * scale;
    }
  }
}

// This thread's rows of a row statistic (lse or D) of the tile at r0.
__device__ __forceinline__ void f32_rows(const float* stat, int r0, int S,
                                         float (&out)[4]) {
  const int tr = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr + 8 * i;
    out[i] = r < S ? stat[r] : 0.f;
  }
}

// dK/dV: one block per (32-row k tile, b * h); k and v resident, the (q,
// do) tiles at or below the diagonal through the ring.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, float scale) {
  using L = F32Plan<HD>;
  constexpr int NT = kF32Threads, T = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = reinterpret_cast<float*>(smem + L::kTileBytes);
  float* ps = reinterpret_cast<float*>(smem + 6 * L::kTileBytes);
  float* dss = ps + T * L::kPld;
  auto q_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (2 + 2 * st) * L::kTileBytes);
  };
  auto do_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (3 + 2 * st) * L::kTileBytes);
  };
  const int kt = blockIdx.x, k0 = kt * T;
  const size_t bh = blockIdx.y, base = bh * S * HD;
  const int n_qt = (S + T - 1) / T;

  load_rows<HD, NT, T>(ks, L::kLd, k + base, k0, S);
  load_rows<HD, NT, T>(vs, L::kLd, v + base, k0, S);
  load_rows<HD, NT, T>(q_tile(0), L::kLd, q + base, k0, S);
  load_rows<HD, NT, T>(do_tile(0), L::kLd, dout + base, k0, S);
  cp_async_commit();

  float acc_dk[4][HD / 16], acc_dv[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  for (int it = kt; it < n_qt; ++it) {
    const int st = (it - kt) & 1, q0 = it * T;
    if (it + 1 < n_qt) {
      load_rows<HD, NT, T>(q_tile(st ^ 1), L::kLd, q + base, q0 + T, S);
      load_rows<HD, NT, T>(do_tile(st ^ 1), L::kLd, dout + base, q0 + T, S);
    }
    cp_async_commit();
    float lse_r[4], d_r[4];
    f32_rows(lse + bh * S, q0, S, lse_r);
    f32_rows(dsum + bh * S, q0, S, d_r);
    cp_async_wait<1>();
    __syncthreads();

    float s[4][2], dp[4][2];   // (q rows x k columns)
    f32_abt<HD>(q_tile(st), ks, L::kLd, s);
    f32_abt<HD>(do_tile(st), vs, L::kLd, dp);
    f32_p_and_ds(s, dp, lse_r, d_r, q0, k0, S, scale, ps, dss, L::kPld);
    __syncthreads();
    // dv += Pᵀ do and dk += dSᵀ q (k rows x HD).
    f32_pb<HD, true>(ps, L::kPld, do_tile(st), L::kLd, acc_dv);
    f32_pb<HD, true>(dss, L::kPld, q_tile(st), L::kLd, acc_dk);
    __syncthreads();
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  f32_write<HD>(dk + base, acc_dk, one, k0, S);
  f32_write<HD>(dv + base, acc_dv, one, k0, S);
}

// dQ: one block per (32-row q tile, b * h); q and do resident, the (k, v)
// tiles at or below the diagonal through the ring.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dq, int S, float scale) {
  using L = F32Plan<HD>;
  constexpr int NT = kF32Threads, T = kF32Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = reinterpret_cast<float*>(smem + L::kTileBytes);
  float* dss = reinterpret_cast<float*>(smem + 6 * L::kTileBytes);
  auto k_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (2 + 2 * st) * L::kTileBytes);
  };
  auto v_tile = [&](int st) {
    return reinterpret_cast<float*>(smem + (3 + 2 * st) * L::kTileBytes);
  };
  const int qt = blockIdx.x, q0 = qt * T;
  const size_t bh = blockIdx.y, base = bh * S * HD;
  const int n_kt = qt + 1;
  float lse_r[4], d_r[4];
  f32_rows(lse + bh * S, q0, S, lse_r);
  f32_rows(dsum + bh * S, q0, S, d_r);

  load_rows<HD, NT, T>(qs, L::kLd, q + base, q0, S);
  load_rows<HD, NT, T>(dos, L::kLd, dout + base, q0, S);
  load_rows<HD, NT, T>(k_tile(0), L::kLd, k + base, 0, S);
  load_rows<HD, NT, T>(v_tile(0), L::kLd, v + base, 0, S);
  cp_async_commit();

  float acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) acc[i][c] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kt) {
      load_rows<HD, NT, T>(k_tile(st ^ 1), L::kLd, k + base, (j + 1) * T, S);
      load_rows<HD, NT, T>(v_tile(st ^ 1), L::kLd, v + base, (j + 1) * T, S);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[4][2], dp[4][2];
    f32_abt<HD>(qs, k_tile(st), L::kLd, s);
    f32_abt<HD>(dos, v_tile(st), L::kLd, dp);
    f32_p_and_ds(s, dp, lse_r, d_r, q0, j * T, S, scale, nullptr, dss,
                 L::kPld);
    __syncthreads();
    f32_pb<HD, false>(dss, L::kPld, k_tile(st), L::kLd, acc);   // dq += dS k
    __syncthreads();
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  f32_write<HD>(dq + base, acc, one, q0, S);
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

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int S, float scale,
                       cudaStream_t stream) {
  constexpr int smem = FwdPlan<HD>::kBytes;
  auto kernel = flash_fwd_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  kernel<<<grid, FwdPlan<HD>::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int bh, int S, float scale,
                       cudaStream_t stream) {
  constexpr int smem = DkvPlan<HD>::kBytes;
  auto kernel = flash_bwd_dkv_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int bh, int S, float scale,
                      cudaStream_t stream) {
  constexpr int smem = DqPlan<HD>::kBytes;
  auto kernel = flash_bwd_dq_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTile - 1) / kTile, bh);
  kernel<<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf16*>(dq), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int S, float scale,
                           cudaStream_t stream) {
  constexpr int smem = F32Plan<HD>::kBytes;
  auto kernel = flash_fwd_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kF32Tile - 1) / kF32Tile, bh);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* dsum, void* dk, void* dv, int bh,
                           int S, float scale, cudaStream_t stream) {
  constexpr int smem = F32Plan<HD>::kBytes;
  auto kernel = flash_bwd_dkv_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kF32Tile - 1) / kF32Tile, bh);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dk), static_cast<float*>(dv), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dsum, void* dq, int bh, int S,
                          float scale, cudaStream_t stream) {
  constexpr int smem = F32Plan<HD>::kBytes;
  auto kernel = flash_bwd_dq_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kF32Tile - 1) / kF32Tile, bh);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<float*>(dq), S, scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int S) {
  return bh <= 0 || bh > 65535 || S <= 0;
}

}  // namespace

// q, k, v, o, dk, dv, dq: (B*H, S, hd) bf16, contiguous, 16-byte aligned;
// lse and dsum (= rowsum(do * o)): (B*H, S) f32.  Each entry point launches
// its kernel once on `stream`, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = launched); an hd other than 32,
// 64 or 128 returns cudaErrorInvalidValue.

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int S, int hd,
                         float scale, void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32) err = launch_fwd<32>(q, k, v, o, lse, bh, S, scale, st);
  if (hd == 64) err = launch_fwd<64>(q, k, v, o, lse, bh, S, scale, st);
  if (hd == 128) err = launch_fwd<128>(q, k, v, o, lse, bh, S, scale, st);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dsum, void* dk, void* dv, int bh,
                             int S, int hd, float scale, void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32)
    err = launch_dkv<32>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale, st);
  if (hd == 64)
    err = launch_dkv<64>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale, st);
  if (hd == 128)
    err = launch_dkv<128>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale, st);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dsum, void* dq, int bh, int S,
                            int hd, float scale, void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32)
    err = launch_dq<32>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  if (hd == 64)
    err = launch_dq<64>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  if (hd == 128)
    err = launch_dq<128>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  return static_cast<int>(err);
}

// The same three entry points for f32 q, k, v, o, dk, dv, dq (the f32
// kernels); lse and dsum as above.

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int S, int hd,
                             float scale, void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32) err = launch_fwd_f32<32>(q, k, v, o, lse, bh, S, scale, st);
  if (hd == 64) err = launch_fwd_f32<64>(q, k, v, o, lse, bh, S, scale, st);
  if (hd == 128) err = launch_fwd_f32<128>(q, k, v, o, lse, bh, S, scale, st);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* dsum, void* dk, void* dv,
                                 int bh, int S, int hd, float scale,
                                 void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32)
    err = launch_dkv_f32<32>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale,
                             st);
  if (hd == 64)
    err = launch_dkv_f32<64>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale,
                             st);
  if (hd == 128)
    err = launch_dkv_f32<128>(q, k, v, dout, lse, dsum, dk, dv, bh, S, scale,
                              st);
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dsum, void* dq, int bh, int S,
                                int hd, float scale, void* stream) {
  if (bad_shape(bh, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (hd == 32)
    err = launch_dq_f32<32>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  if (hd == 64)
    err = launch_dq_f32<64>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  if (hd == 128)
    err = launch_dq_f32<128>(q, k, v, dout, lse, dsum, dq, bh, S, scale, st);
  return static_cast<int>(err);
}

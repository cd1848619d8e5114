// Causal flash attention, forward and backward, for q, k, v of (B, H, S, hd)
// bf16, contiguous, hd in {32, 64, 128}: three tiled tensor-core kernels.
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
// dq are two kernels, as in JAX, and each output tile is written once.
//
// Products use WMMA (bf16 in, f32 accumulate).  WMMA's accumulator layout
// is opaque, so the logits go through shared memory in f32 for the masked
// softmax, and the forward's output accumulator lives in registers, one
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

// Rows r0 .. r0 + kTile - 1 of a (S x HD) row-major matrix into shared
// memory with row stride `ld`, as 16-byte cp.asyncs; rows >= S zero-filled.
template <int HD, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int r0, int S) {
  constexpr int kPerRow = HD / 8;      // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kPerRow; c += NT) {
    const int r = c / kPerRow, cc = (c % kPerRow) * 8;
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

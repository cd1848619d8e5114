// Causal flash attention, forward and backward, for q, k, v of (B, H, S, hd),
// contiguous, hd in {32, 64, 128}: three tensor-core kernels for bf16, and
// f32 variants of the three (section "f32" below, behind the entry points
// with an `_f32` suffix): the forward on the CUDA cores, dK/dV and dQ on
// the tensor cores in error-compensated TF32.
//
//   flash_fwd_wgmma_kernel      behind `flash_fwd`:
//       o = softmax(scale * q kᵀ + causal mask) v, and the f32 row statistic
//       lse = m + log(l) (row max m, row sum l of exp(logit - m)).
//   flash_bwd_dkv_wgmma_kernel  behind `flash_bwd_dkv`:  dk, dv.
//   flash_bwd_dq_wgmma_kernel   behind `flash_bwd_dq`:   dq.
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
// too), P (for P v and Pᵀ do) and dS = P * (do vᵀ - D) * scale are rounded
// to the input type before their products, as JAX's kernels round them,
// and every product sums in f32.
//
// What bounds them on an H100: at the bench shape (B, H, S, hd) = (4, 16,
// 512, 128) each kernel moves 34-50 MB and does 4-9 GFLOP of causal work,
// so the bytes (10-15 us at 3.35 TB/s) bound it, not the tensor cores (4-9
// us at 989 TFLOP/s).  Every design keeps the (S, S) logits out of device
// memory: a thread block owns one tile of q (forward, dq) or of k (dk/dv),
// keeps its operand tiles and its f32 sums on chip, and streams the other
// side's tiles through a ring in shared memory, visiting only the tiles on
// or below the diagonal (causal skip).  Nothing carries across thread
// blocks, so there are no atomics: dk/dv and dq are two kernels, as in
// JAX, each output tile is written once, and a call's bits do not change
// from run to run.  In f32 the same work moves twice the bytes and runs at
// 67 TFLOP/s on the CUDA cores (the forward, 64 us at that shape) or 165
// TFLOP/s of f32-accurate tensor-core products (dK/dV and dQ, 39-52 us),
// so the operations bound it, against 20-30 us of bytes.
//
// The three bf16 kernels are Hopper designs (section "bf16 forward, dK/dV,
// dQ"): wgmma fed by a TMA ring with mbarriers in blocks of two
// warpgroups, and the logits never leave registers: the accumulator's
// fragments take the masked softmax (or P and dS) in place and, rounded to
// bf16, are the register A operand of the next wgmma.  A ragged S (not a
// multiple of the tile) is zero-filled in the copies and masked by
// position, so JAX's 128-multiple requirement (MIN_BLOCK_SIZE) has no
// counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = pred ? 16 : 0;   // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// 4 bytes by cp.async (zeros where !pred); the stage's statistics.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 4 : 0));
}

// An arrival on the mbarrier at `bar` once this thread's cp.asyncs so far
// have landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -------------------------------------------- bf16 forward, dK/dV, dQ ----
// wgmma kernels on a TMA ring.  A thread block is two warpgroups, 64 rows
// of the block's 128-row tile each; warp 0 also drives the ring: it fills
// the first stages at the start and refills a stage once both warpgroups
// have released it (an mbarrier per stage for arrival, one for release),
// lane 0 issuing the TMA copies.  No producer warpgroup: with a third, a
// block has 12 warps, three on each of the SM's four register partitions,
// which caps the entry budget at 168 registers a thread; setmaxnreg lets
// the consumers allocate 240, but ptxas budgets wgmma's pipelining by the
// entry count and serialises the products (warning C7512) where the
// consumers need more than 168, as the forward and dK/dV do at hd 128.
// Two warpgroups start with 255.  q, k, v and do are read through 3-D tensor
// maps (hd, S, b*h) in boxes of 64 columns (128 bytes, the swizzle's span)
// x R rows: a tile of R rows is kDp / 64 such boxes, each R rows of 128
// bytes.  TMA fills rows past S, and at hd 32 columns 32 .. 63, with
// zeros, so a tile is always 64-column-aligned and full; the position mask
// keeps those rows out of every sum, and the epilogue drops them.
constexpr int kWgThreads = 256;    // two warpgroups
constexpr int kBlockRows = 128;    // q rows (forward, dQ), k rows (dK/dV)
constexpr int kFwdKv = 128;        // k / v rows of a forward ring stage
constexpr int kDkvQ = 64;          // q / do rows of a dK/dV ring stage
constexpr int kDqKv = 64;          // k / v rows of a dQ ring stage
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kFwdKv == kBlockRows, "the forward masks its last tile only");

__device__ __forceinline__ float fast_exp2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += A @ B, A of the fragment registers a, B by descriptor (MN-major
// where kTransB), at N = 128 or 64.
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_m64n128k16_rs<kTransB>(d, a, db);
  else
    wgmma_m64n64k16_rs<kTransB>(d, a, db);
}

// d = A @ Bᵀ over DP columns: A (64 rows from shared-memory address a) and
// B (N rows from b), K-major, in 64-column boxes of RA and RB rows.
template <int N, int DP, int RA, int RB>
__device__ __forceinline__ void wgmma_abt(float (&d)[N / 2], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t at = (kk / 4) * RA * 128 + (kk % 4) * 32;
    const uint32_t bt = (kk / 4) * RB * 128 + (kk % 4) * 32;
    if constexpr (N == 128)
      wgmma_m64n128k16<0, 0>(d, wgmma_desc(a + at, 16),
                             wgmma_desc(b + bt, 16), kk > 0);
    else
      wgmma_m64n64k16<0, 0>(d, wgmma_desc(a + at, 16),
                            wgmma_desc(b + bt, 16), kk > 0);
  }
}

// Shared memory of the forward, in bytes from a 1024-aligned base: Q
// (128 rows), a ring of (K, V) stages (128 rows each), the barriers.
template <int HD>
struct FwdPlan {
  static constexpr int kDp = HD < 64 ? 64 : HD;      // columns on chip
  static constexpr int kQBytes = kBlockRows * kDp * 2;
  static constexpr int kKvBytes = kFwdKv * kDp * 2;    // one of K, V
  static constexpr int kStages = kDp == 128 ? 2 : 3;
  static constexpr int kRing = kQBytes;
  static constexpr int kBars = kRing + kStages * 2 * kKvBytes;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  // The epilogue's staging row: 16 bytes of pad put a warp's fragment
  // stores (8 rows x 4 pairs) on 32 distinct banks.
  static constexpr int kStageLd = kDp + 8;
  static_assert(2 * 64 * kStageLd * 2 <= kBars, "staging fits");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// The (K, V) tile j of head bh into ring stage j % kStages, completing the
// stage's full barrier (issued by one thread).
template <int HD>
__device__ __forceinline__ void fwd_load_kv(const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            uint32_t base, uint32_t full,
                                            int j, int bh) {
  using L = FwdPlan<HD>;
  const int st = j % L::kStages;
  const uint32_t bar = full + 8 * st;
  const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
  mbar_expect_tx(bar, 2 * L::kKvBytes);
#pragma unroll
  for (int b = 0; b < L::kDp / 64; ++b) {
    tma_load_3d(ks + b * kFwdKv * 128, tk, 64 * b, j * kFwdKv, bh, bar);
    tma_load_3d(ks + L::kKvBytes + b * kFwdKv * 128, tv, 64 * b,
                j * kFwdKv, bh, bar);
  }
}

// Thread block (b*h, tile): the 128 q rows at q0 of head bh, the q tiles
// in reverse order of blockIdx.y so that the longest rows of the causal
// triangle start first.  Consumer warpgroup wg owns rows q0 + 64 wg ..;
// per (K, V) stage it computes S = Q Kᵀ (m64n128, both operands K-major in
// shared memory), the online softmax on the accumulator fragments (a
// row's values lie in one quad: max by two shuffles, the sum l kept per
// thread and added across the quad once at the end), and O += P V with P
// rounded to bf16 in registers as wgmma's A operand and V MN-major.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int S, float scale_log2) {
  using L = FwdPlan<HD>;
  constexpr int DP = L::kDp;
  extern __shared__ unsigned char fwd_smem[];
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBlockRows;
  const int n_kv = qt + 1;    // the k tiles on or below the diagonal
  const int tid = threadIdx.x;

  // Q, then the ring's first stages; full[st] (TMA arrival), empty[st]
  // (released by every thread) and Q's barrier after the ring.
  const uint32_t base = (smem_u32(fwd_smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t qbar = empty + 8 * L::kStages;
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgThreads);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, L::kQBytes);
#pragma unroll
    for (int b = 0; b < DP / 64; ++b)
      tma_load_3d(base + b * kBlockRows * 128, &tq, 64 * b, q0, bh, qbar);
    for (int j = 0; j < n_kv && j < L::kStages; ++j)
      fwd_load_kv<HD>(&tk, &tv, base, full, j, bh);
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;   // and row + 8
  const int col = 2 * (lane % 4);   // of each 8-column group
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t qs = base + wg * 64 * 128;   // this warpgroup's Q rows
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % L::kStages;
    mbar_wait(full + 8 * st, (j / L::kStages) & 1);
    const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
    const uint32_t vs = ks + L::kKvBytes;

    float s[kFwdKv / 2];
    wgmma_fence();
    wgmma_abt<kFwdKv, DP, kBlockRows, kFwdKv>(s, qs, ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax in log2 units, row h of this thread's two.  Only the
    // diagonal tile (the last) holds k > q; every row has k = q0 there.
    const bool diag = j == n_kv - 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m_run[h];
#pragma unroll
      for (int c = 0; c < kFwdKv / 8; ++c)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float x = s[4 * c + 2 * h + v] * scale_log2;
          if (diag && j * kFwdKv + 8 * c + col + v > row + 8 * h)
            x = -INFINITY;
          s[4 * c + 2 * h + v] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = fast_exp2(m_run[h] - mx);
      m_run[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kFwdKv / 8; ++c)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float p = fast_exp2(s[4 * c + 2 * h + v] - mx);
          s[4 * c + 2 * h + v] = p;
          sum += p;
        }
      l_run[h] = l_run[h] * corr + sum;
#pragma unroll
      for (int c = 0; c < DP / 8; ++c) {
        acc[4 * c + 2 * h] *= corr;
        acc[4 * c + 2 * h + 1] *= corr;
      }
    }

    // O += P V: P (64 x 128) rounded to bf16 in registers, V (128 x DP)
    // MN-major in its 64-column boxes, 16 rows (2048 bytes) a k-step.
    uint32_t p[kFwdKv / 16][4];
#pragma unroll
    for (int kk = 0; kk < kFwdKv / 16; ++kk) bf16_a_fragment(s, kk, p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKv / 16; ++kk)
      wgmma_rs<DP, 1>(acc, p[kk], wgmma_desc(vs + kk * 2048, kFwdKv * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * st);
    if (tid < 32 && j + L::kStages < n_kv) {   // warp 0 refills the stage
      mbar_wait(empty + 8 * st, (j / L::kStages) & 1);
      if (tid == 0)
        fwd_load_kv<HD>(&tk, &tv, base, full, j + L::kStages, bh);
      __syncwarp();
    }
  }

  // o = acc / l (l summed across the quad), staged per warpgroup once both
  // are done with Q and the ring, then stored 16 bytes a thread, rows < S
  // and columns < HD; lse = (m + log2 l) ln 2.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    if (lane % 4 == 0 && row + 8 * h < S)
      lse[static_cast<size_t>(bh) * S + row + 8 * h] =
          (m_run[h] + log2f(l_run[h])) * (1.f / kLog2e);
  }
  const float inv[2] = {1.f / l_run[0], 1.f / l_run[1]};
  __syncthreads();
  bf16* stage = reinterpret_cast<bf16*>(fwd_smem +
                                        (base - smem_u32(fwd_smem))) +
                wg * 64 * L::kStageLd;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + (r + 8 * h) * L::kStageLd +
                                   8 * c + col) =
          pack_bf16(acc[4 * c + 2 * h] * inv[h],
                    acc[4 * c + 2 * h + 1] * inv[h]);
  bar_sync(2 + wg, 128);
  const int w0 = q0 + 64 * wg;
  bf16* out = o + (static_cast<size_t>(bh) * S + w0) * HD;
  for (int i = tid % 128; i < 64 * HD / 8; i += 128) {
    const int rr = i / (HD / 8), cc = 8 * (i % (HD / 8));
    if (w0 + rr < S)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(rr) * HD + cc) =
          *reinterpret_cast<const uint4*>(stage + rr * L::kStageLd + cc);
  }
}

// Shared memory of dK/dV, in bytes from a 1024-aligned base: K and V
// (128 rows each, resident), a ring of (Q, dO) stages (64 rows each), the
// stages' lse and D slices (64 f32 each), the barriers.  A stage is full
// once its TMA bytes have landed and each lane of warp 0 has written its
// share of the slices.
template <int HD>
struct DkvPlan {
  static constexpr int kDp = HD < 64 ? 64 : HD;
  static constexpr int kKBytes = kBlockRows * kDp * 2;   // one of K, V
  static constexpr int kQBytes = kDkvQ * kDp * 2;        // one of Q, dO
  static constexpr int kStages = 3;
  static constexpr int kRing = 2 * kKBytes;
  static constexpr int kStats = kRing + kStages * 2 * kQBytes;
  static constexpr int kStatBytes = kDkvQ * 4;
  static constexpr int kBars = kStats + kStages * 2 * kStatBytes;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  static constexpr int kStageLd = kDp + 8;
  static_assert(2 * 2 * 64 * kStageLd * 2 <= kStats, "staging fits");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// The (Q, dO) tile i of head bh into ring stage st with its rows' lse and
// D, by warp 0: lane 0 issues the TMA copies, every lane copies its share
// of the statistics by cp.async (zeros past S; TMA would need a
// 16-byte-aligned start, which b*h*S + q0 is not for every S), and the
// stage's full barrier counts each lane's arrival once its copies land, so
// that the warp does not wait for them.
template <int HD>
__device__ __forceinline__ void dkv_load_q(const CUtensorMap* tq,
                                           const CUtensorMap* tdo,
                                           const float* lse_g,
                                           const float* d_g,
                                           float* stat_base, uint32_t base,
                                           uint32_t full, int st, int i,
                                           int bh, int S, int lane) {
  using L = DkvPlan<HD>;
  const uint32_t bar = full + 8 * st;
  if (lane == 0) {
    const uint32_t qs = base + L::kRing + st * 2 * L::kQBytes;
    mbar_expect_tx(bar, 2 * L::kQBytes);
#pragma unroll
    for (int b = 0; b < L::kDp / 64; ++b) {
      tma_load_3d(qs + b * kDkvQ * 128, tq, 64 * b, i * kDkvQ, bh, bar);
      tma_load_3d(qs + L::kQBytes + b * kDkvQ * 128, tdo, 64 * b,
                  i * kDkvQ, bh, bar);
    }
  }
  float* lse_s = stat_base + st * 2 * kDkvQ;
  for (int r = lane; r < kDkvQ; r += 32) {
    const int q = i * kDkvQ + r;
    const bool ok = q < S;
    cp_async4(lse_s + r, ok ? lse_g + q : lse_g, ok);
    cp_async4(lse_s + kDkvQ + r, ok ? d_g + q : d_g, ok);
  }
  cp_async_mbar_arrive(bar);
}

// Thread block (b*h, k tile): dK and dV of the 128 k rows at k0 of head
// bh, heaviest (lowest) k tiles first.  Consumer warpgroup wg owns k rows
// k0 + 64 wg ..; per (Q, dO) stage, from the diagonal down, it computes
// Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (m64n64, K-major operands in shared memory),
// Pᵀ = 2^(scale log2e Sᵀ - log2e lse) and dSᵀ = Pᵀ (dPᵀ - D) scale on the
// fragments, then dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ and dSᵀ rounded to
// bf16 in registers as wgmma's A operand, dO and Q MN-major.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(
        const __grid_constant__ CUtensorMap tq,
        const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv,
        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
        const float* __restrict__ dsum, bf16* __restrict__ dk,
        bf16* __restrict__ dv, int S, float scale) {
  using L = DkvPlan<HD>;
  constexpr int DP = L::kDp;
  extern __shared__ unsigned char dkv_smem[];
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;
  const int first = k0 / kDkvQ;                 // the q tile at the diagonal
  const int n_q = (S + kDkvQ - 1) / kDkvQ;
  const int tid = threadIdx.x;
  const float* lse_g = lse + static_cast<size_t>(bh) * S;
  const float* d_g = dsum + static_cast<size_t>(bh) * S;

  // K and V, then the ring's first stages; full[st] (TMA arrival and warp
  // 0's statistics), empty[st] (released by every thread) and K and V's
  // barrier after the statistics.
  const uint32_t base = (smem_u32(dkv_smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t kvbar = empty + 8 * L::kStages;
  float* stat_base = reinterpret_cast<float*>(
      dkv_smem + (base - smem_u32(dkv_smem)) + L::kStats);
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1 + 32);
      mbar_init(empty + 8 * st, kWgThreads);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
    mbar_expect_tx(kvbar, 2 * L::kKBytes);
#pragma unroll
    for (int b = 0; b < DP / 64; ++b) {
      tma_load_3d(base + b * kBlockRows * 128, &tk, 64 * b, k0, bh, kvbar);
      tma_load_3d(base + L::kKBytes + b * kBlockRows * 128, &tv, 64 * b, k0,
                  bh, kvbar);
    }
  }
  __syncthreads();
  if (tid < 32)
    for (int i = first; i < n_q && i < first + L::kStages; ++i)
      dkv_load_q<HD>(&tq, &tdo, lse_g, d_g, stat_base, base, full,
                     i - first, i, bh, S, tid);

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int w0 = k0 + 64 * wg;                          // this warpgroup's
  const int row = w0 + 16 * warp + lane / 4;            // k rows: row, + 8
  const int col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  const uint32_t ks = base + wg * 64 * 128;
  const uint32_t vs = ks + L::kKBytes;
  mbar_wait(kvbar, 0);

  for (int i = first; i < n_q; ++i) {
    const int it = i - first, st = it % L::kStages;
    mbar_wait(full + 8 * st, (it / L::kStages) & 1);
    const uint32_t qs = base + L::kRing + st * 2 * L::kQBytes;
    const uint32_t dos = qs + L::kQBytes;

    float s[kDkvQ / 2], dp[kDkvQ / 2];   // Sᵀ, dPᵀ: k rows x q columns
    wgmma_fence();
    wgmma_abt<kDkvQ, DP, kBlockRows, kDkvQ>(s, ks, qs);
    wgmma_abt<kDkvQ, DP, kBlockRows, kDkvQ>(dp, vs, dos);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // Pᵀ and dSᵀ in place of Sᵀ and dPᵀ.  Only tiles that cross this
    // warpgroup's diagonal or S are masked: k > q, or q >= S.
    const float* lse_s = stat_base + st * 2 * kDkvQ;
    const float* d_s = lse_s + kDkvQ;
    const int q0 = i * kDkvQ;
    const bool masked = q0 < w0 + 64 || q0 + kDkvQ > S;
#pragma unroll
    for (int c = 0; c < kDkvQ / 8; ++c) {
      const float2 lse2 =
          *reinterpret_cast<const float2*>(lse_s + 8 * c + col);
      const float2 d2 = *reinterpret_cast<const float2*>(d_s + 8 * c + col);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float l2 = (v ? lse2.y : lse2.x) * kLog2e;
        const float dd = v ? d2.y : d2.x;
        const int qpos = q0 + 8 * c + col + v;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 4 * c + 2 * h + v;
          float p = fast_exp2(s[x] * scale_log2 - l2);
          if (masked && (row + 8 * h > qpos || qpos >= S)) p = 0.f;
          s[x] = p;
          dp[x] = p * (dp[x] - dd) * scale;
        }
      }
    }

    // dV += Pᵀ dO and dK += dSᵀ Q, contracting over the 64 q rows: dO and
    // Q MN-major in their 64-column boxes, 16 rows (2048 bytes) a k-step.
    uint32_t pa[kDkvQ / 16][4], da[kDkvQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk) {
      bf16_a_fragment(s, kk, pa[kk]);
      bf16_a_fragment(dp, kk, da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk)
      wgmma_rs<DP, 1>(acc_dv, pa[kk],
                      wgmma_desc(dos + kk * 2048, kDkvQ * 128));
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk)
      wgmma_rs<DP, 1>(acc_dk, da[kk],
                      wgmma_desc(qs + kk * 2048, kDkvQ * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    mbar_arrive(empty + 8 * st);
    if (tid < 32 && i + L::kStages < n_q) {   // warp 0 refills the stage
      mbar_wait(empty + 8 * st, (it / L::kStages) & 1);
      dkv_load_q<HD>(&tq, &tdo, lse_g, d_g, stat_base, base, full, st,
                     i + L::kStages, bh, S, tid);
    }
  }

  // dK and dV staged per warpgroup once both are done with K, V and the
  // ring, then stored 16 bytes a thread, rows < S and columns < HD.
  __syncthreads();
  bf16* dk_stage = reinterpret_cast<bf16*>(dkv_smem +
                                           (base - smem_u32(dkv_smem))) +
                   wg * 2 * 64 * L::kStageLd;
  bf16* dv_stage = dk_stage + 64 * L::kStageLd;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = (r + 8 * h) * L::kStageLd + 8 * c + col;
      *reinterpret_cast<uint32_t*>(dk_stage + at) =
          pack_bf16(acc_dk[4 * c + 2 * h], acc_dk[4 * c + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv_stage + at) =
          pack_bf16(acc_dv[4 * c + 2 * h], acc_dv[4 * c + 2 * h + 1]);
    }
  bar_sync(2 + wg, 128);
  const size_t out0 = (static_cast<size_t>(bh) * S + w0) * HD;
  for (int i = tid % 128; i < 64 * HD / 8; i += 128) {
    const int rr = i / (HD / 8), cc = 8 * (i % (HD / 8));
    if (w0 + rr < S) {
      const size_t at = out0 + static_cast<size_t>(rr) * HD + cc;
      *reinterpret_cast<uint4*>(dk + at) =
          *reinterpret_cast<const uint4*>(dk_stage + rr * L::kStageLd + cc);
      *reinterpret_cast<uint4*>(dv + at) =
          *reinterpret_cast<const uint4*>(dv_stage + rr * L::kStageLd + cc);
    }
  }
}

// Shared memory of dQ, in bytes from a 1024-aligned base: Q and dO (128
// rows each, resident), a ring of (K, V) stages (64 rows each), the
// barriers.
template <int HD>
struct DqPlan {
  static constexpr int kDp = HD < 64 ? 64 : HD;
  static constexpr int kQBytes = kBlockRows * kDp * 2;   // one of Q, dO
  static constexpr int kKvBytes = kDqKv * kDp * 2;       // one of K, V
  static constexpr int kStages = 4;
  static constexpr int kRing = 2 * kQBytes;
  static constexpr int kBars = kRing + kStages * 2 * kKvBytes;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  static constexpr int kStageLd = kDp + 8;
  static_assert(2 * 64 * kStageLd * 2 <= kRing, "staging fits");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// The (K, V) tile j of head bh into ring stage j % kStages, completing the
// stage's full barrier (issued by one thread).
template <int HD>
__device__ __forceinline__ void dq_load_kv(const CUtensorMap* tk,
                                           const CUtensorMap* tv,
                                           uint32_t base, uint32_t full,
                                           int j, int bh) {
  using L = DqPlan<HD>;
  const int st = j % L::kStages;
  const uint32_t bar = full + 8 * st;
  const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
  mbar_expect_tx(bar, 2 * L::kKvBytes);
#pragma unroll
  for (int b = 0; b < L::kDp / 64; ++b) {
    tma_load_3d(ks + b * kDqKv * 128, tk, 64 * b, j * kDqKv, bh, bar);
    tma_load_3d(ks + L::kKvBytes + b * kDqKv * 128, tv, 64 * b, j * kDqKv,
                bh, bar);
  }
}

// Thread block (b*h, tile): dQ of the 128 q rows at q0 of head bh,
// heaviest (highest) q tiles first.  Q and dO stay resident, and each
// thread keeps its two rows' lse (in log2 units) and D in registers.
// Consumer warpgroup wg owns q rows q0 + 64 wg ..; per (K, V) stage up to
// its diagonal it computes S = Q Kᵀ and dP = dO Vᵀ (m64n64, K-major
// operands in shared memory), P = 2^(scale log2e S - log2e lse) and dS =
// P (dP - D) scale on the fragments, then dQ += dS K with dS rounded to
// bf16 in registers as wgmma's A operand and the same K tile read
// MN-major.  Warpgroup 0 releases the block's last stage unread where it
// lies past its own diagonal.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              bf16* __restrict__ dq, int S, float scale) {
  using L = DqPlan<HD>;
  constexpr int DP = L::kDp;
  extern __shared__ unsigned char dq_smem[];
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kBlockRows;
  // The k tiles on or below the block's last diagonal, and below S.
  const int n_kv = min((q0 + kBlockRows) / kDqKv, (S + kDqKv - 1) / kDqKv);
  const int tid = threadIdx.x;

  // Q and dO, then the ring's first stages; full[st] (TMA arrival),
  // empty[st] (released by every thread) and Q and dO's barrier after the
  // ring.
  const uint32_t base = (smem_u32(dq_smem) + 1023) & ~1023u;
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t qbar = empty + 8 * L::kStages;
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kWgThreads);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, 2 * L::kQBytes);
#pragma unroll
    for (int b = 0; b < DP / 64; ++b) {
      tma_load_3d(base + b * kBlockRows * 128, &tq, 64 * b, q0, bh, qbar);
      tma_load_3d(base + L::kQBytes + b * kBlockRows * 128, &tdo, 64 * b, q0,
                  bh, qbar);
    }
    for (int j = 0; j < n_kv && j < L::kStages; ++j)
      dq_load_kv<HD>(&tk, &tv, base, full, j, bh);
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;   // and row + 8
  const int col = 2 * (lane % 4);   // of each 8-column group
  const float scale_log2 = scale * kLog2e;
  // Rows >= S take 0: their P is finite and their dq row is dropped.
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool ok = row + 8 * h < S;
    const size_t at = static_cast<size_t>(bh) * S + row + 8 * h;
    l2[h] = ok ? lse[at] * kLog2e : 0.f;
    dd[h] = ok ? dsum[at] : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint32_t qs = base + wg * 64 * 128;   // this warpgroup's Q rows
  const uint32_t dos = qs + L::kQBytes;       // and dO rows
  const int last = (q0 + 64 * wg) / kDqKv;    // its diagonal k tile
  mbar_wait(qbar, 0);

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % L::kStages;
    mbar_wait(full + 8 * st, (j / L::kStages) & 1);
    if (j <= last) {   // the same in every thread of the warpgroup
      const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
      const uint32_t vs = ks + L::kKvBytes;
      float s[kDqKv / 2], dp[kDqKv / 2];   // S, dP: q rows x k columns
      wgmma_fence();
      wgmma_abt<kDqKv, DP, kBlockRows, kDqKv>(s, qs, ks);
      wgmma_abt<kDqKv, DP, kBlockRows, kDqKv>(dp, dos, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // dS in place of S.  Only the diagonal tile holds k > q; k >= S lies
      // there too for every row < S, so the causal mask covers it.
      const bool diag = j == last;
#pragma unroll
      for (int c = 0; c < kDqKv / 8; ++c)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int kpos = j * kDqKv + 8 * c + col + v;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int x = 4 * c + 2 * h + v;
            float p = fast_exp2(s[x] * scale_log2 - l2[h]);
            if (diag && kpos > row + 8 * h) p = 0.f;
            s[x] = p * (dp[x] - dd[h]) * scale;
          }
        }

      // dQ += dS K, contracting over the 64 k rows: K MN-major in its
      // 64-column boxes, 16 rows (2048 bytes) a k-step.
      uint32_t da[kDqKv / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDqKv / 16; ++kk) bf16_a_fragment(s, kk, da[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKv / 16; ++kk)
        wgmma_rs<DP, 1>(acc, da[kk], wgmma_desc(ks + kk * 2048, kDqKv * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty + 8 * st);
    if (tid < 32 && j + L::kStages < n_kv) {   // warp 0 refills the stage
      mbar_wait(empty + 8 * st, (j / L::kStages) & 1);
      if (tid == 0)
        dq_load_kv<HD>(&tk, &tv, base, full, j + L::kStages, bh);
      __syncwarp();
    }
  }

  // dQ staged per warpgroup once both are done with Q, dO and the ring,
  // then stored 16 bytes a thread, rows < S and columns < HD.
  __syncthreads();
  bf16* stage = reinterpret_cast<bf16*>(dq_smem +
                                        (base - smem_u32(dq_smem))) +
                wg * 64 * L::kStageLd;
  const int r = 16 * warp + lane / 4;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(stage + (r + 8 * h) * L::kStageLd +
                                   8 * c + col) =
          pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  bar_sync(2 + wg, 128);
  const int w0 = q0 + 64 * wg;
  bf16* out = dq + (static_cast<size_t>(bh) * S + w0) * HD;
  for (int i = tid % 128; i < 64 * HD / 8; i += 128) {
    const int rr = i / (HD / 8), cc = 8 * (i % (HD / 8));
    if (w0 + rr < S)
      *reinterpret_cast<uint4*>(out + static_cast<size_t>(rr) * HD + cc) =
          *reinterpret_cast<const uint4*>(stage + rr * L::kStageLd + cc);
  }
}

// ---------------------------------------------------------------- f32 ----
// The three kernels for f32 q, k, v: the same maths with P and dS in f32,
// never rounded.  The forward is register-tiled FFMA (section "f32
// forward" below); dK/dV and dQ run on the tensor cores in
// error-compensated TF32 (3xTF32): each operand x is split into hi = x,
// which the tensor cores read truncated to tf32, and lo = x minus that
// truncation (hopper.cuh tf32_split), and a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi, three wgmma m64nNk8 tf32 products summed in f32, which keeps
// about 19 bits of each product where one TF32 pass keeps 10 and would
// miss 1e-4.
//
// What bounds them on an H100 (rates measured on the card): FFMA
// with its operands from shared memory runs at about 40-50% of the FFMA
// peak, which held the first f32 backward kernels near 20 TFLOP/s.  Three
// TF32 passes cap f32-accurate products at 495 / 3 = 165 TFLOP/s; at (4,
// 16, 512, 128) that is 52 us of dK/dV and 39 of dQ against 30 and 25 us
// of bytes, so the operations bound them.  The cap holds for products 64
// or more columns wide; shared memory leaves the hd-128 kernels products
// 32 wide, which the tensor cores run at about two thirds of it.
//
// tf32 wgmma reads a shared-memory operand K-major only (no transpose bit
// as bf16 has) and its register A operand's columns do not pair as an
// accumulator's.  So the streamed tiles (TMA, 128-byte swizzle, row-major
// as they lie in device memory) are only ever A operands, loaded by the
// threads into the register fragment and split there: row-wise for the
// products that contract over hd (Tf32RowFrag), column-wise for those
// that contract over the tile's rows (Tf32ColFrag), at addresses computed
// once a tile, and the three products of a k-step issue while the next
// k-step's fragment is split (hopper.cuh mma_3xtf32).  B operands are
// K-major tiles split once into hi and lo: the owned side (K, V for
// dK/dV; Q, dO for dQ), split in place when it lands, and P / dS, written
// by the threads from the accumulators.  The products over rows are computed
// transposed (dVᵀ = dOᵀ P, dKᵀ = Qᵀ dS, dQᵀ = Kᵀ dSᵀ), so that P and dS
// are B operands.  Within each k-step of 8 rows, position i holds row 2 (i
// % 4) + i / 4 (hopper.cuh kstep_row): the column-wise fragment loads of 4
// rows x 8 columns then fall on 32 distinct banks of the swizzled tile.
//
// Shared memory binds: an f32 tile is twice bf16's bytes and each B
// operand needs its lo part.  At hd 128 a block owns 32 rows (64 at hd 64
// and 32) and streams 64-row tiles through a 2-deep ring (3 at hd 64, 4 at
// hd 32), 216-225 KB.  Two consumer warpgroups split each stage's work:
// warpgroup 0 computes S and P, warpgroup 1 dP and, from P in f32 through
// shared memory (its hi part, P's own bits), dS; then dK/dV: warpgroup 0
// dVᵀ, warpgroup 1 dKᵀ; dQ: each an m-tile of dQᵀ at hd 128, half its
// columns below.  Warp 0 drives the ring as in the bf16 kernels.  No atomics, each output tile written
// once, sums in a fixed order: a second launch gives the same bits.
constexpr int kF32Threads = 256;   // two warpgroups
constexpr int kF32Stream = 64;     // rows of a streamed tile

// Where this thread's accumulator elements of a product (64 rows, columns
// 8 j + 2 (lane % 4) + v) go in a K-major B tile of `rows` rows of 64
// positions that holds the product transposed: element x = 4 j + 2 h + v
// (row r = 16 w + lane / 4 + 8 h) at row 8 j + 2 (lane % 4) + v, position
// kstep_pos(r % 8) of k-step r / 8.  It lies 1024 j bytes past at[x % 4]:
// the rows' swizzle does not depend on j.
__device__ __forceinline__ void transposed_at(int rows, uint32_t (&at)[4]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int r = 16 * ((threadIdx.x / 32) % 4) + lane / 4 + 8 * h;
      at[2 * h + v] = f32_sw128(2 * (lane % 4) + v,
                                8 * (r / 8) + kstep_pos(r % 8), rows);
    }
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// x split into hi at `addr` and lo `lo_off` bytes past it.
__device__ __forceinline__ void sts_split(uint32_t addr, uint32_t lo_off,
                                          float x) {
  uint32_t hi, lo;
  tf32_split(x, hi, lo);
  st_shared_u32(addr, hi);
  st_shared_u32(addr + lo_off, lo);
}

// Splits `bytes` bytes of f32 at `hi_t`: the tile stays as it is, its own
// hi part (tf32_split), and its lo part goes to `lo_t` (the same layout),
// every thread a share of 16-byte chunks.
__device__ __forceinline__ void split_tile(const unsigned char* hi_t,
                                           unsigned char* lo_t, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += kF32Threads) {
    const float4 x = *reinterpret_cast<const float4*>(hi_t + 16 * i);
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(lo_t + 16 * i) = l;
  }
}

// Shared memory of dK/dV, in bytes from a 1024-aligned base: K hi, K lo,
// V hi, V lo (kOwn rows each, resident), a ring of (Q, dO) stages (64 rows
// each), Pᵀ hi, Pᵀ lo, dSᵀ hi, dSᵀ lo (kOwn rows of 64 q positions), the
// barriers.  Pᵀ hi holds P's f32 bits (hopper.cuh tf32_split), which
// warpgroup 1 reads for dS.
template <int HD>
struct DkvF32Plan {
  static constexpr int kOwn = HD == 128 ? 32 : 64;
  static constexpr int kOwnBytes = kOwn * HD * 4;
  static constexpr int kQBytes = kF32Stream * HD * 4;   // one of Q, dO
  static constexpr int kStages = HD == 128 ? 2 : HD == 64 ? 3 : 4;
  static constexpr int kPBytes = kOwn * kF32Stream * 4;
  static constexpr int kRing = 4 * kOwnBytes;
  static constexpr int kP = kRing + kStages * 2 * kQBytes;
  static constexpr int kBars = kP + 4 * kPBytes;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  static constexpr int kStageLd = HD + 4;   // the epilogue's rows, floats
  static_assert(HD % 32 == 0 && HD <= 128, "head dim: 32-column boxes");
  static_assert(2 * kOwn * kStageLd * 4 <= kP - kRing, "staging fits");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// Thread block (b*h, k tile): dK and dV of the kOwn k rows at k0 of head
// bh, heaviest (lowest) k tiles first.  Per (Q, dO) stage from the
// diagonal down: warpgroup 0 computes S = Q Kᵀ and P = 2^(scale log2e S -
// log2e lse) (0 above the diagonal and on rows >= S) and writes Pᵀ;
// warpgroup 1 computes dP = dO Vᵀ and, once P is written, dS = P (dP - D)
// scale from Pᵀ hi (P in f32), and writes dSᵀ; then warpgroup 0 adds dOᵀ P to dVᵀ and
// warpgroup 1 Qᵀ dS to dKᵀ.  lse and D of a thread's two q rows come from
// device memory, loaded before the stage's products.
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int S, float scale) {
  using L = DkvF32Plan<HD>;
  constexpr int NK = L::kOwn, NQ = kF32Stream, MT = (HD + 63) / 64;
  extern __shared__ unsigned char dkv32_smem[];
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * NK;
  const int first = k0 / NQ;                 // the q tile at the diagonal
  const int n_q = (S + NQ - 1) / NQ;
  const int tid = threadIdx.x;
  const float* lse_g = lse + static_cast<size_t>(bh) * S;
  const float* d_g = dsum + static_cast<size_t>(bh) * S;

  const uint32_t base = (smem_u32(dkv32_smem) + 1023) & ~1023u;
  unsigned char* sm = dkv32_smem + (base - smem_u32(dkv32_smem));
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t kvbar = empty + 8 * L::kStages;
  auto load_q = [&](int i) {   // (Q, dO) tile i into its stage (one thread)
    const int st = (i - first) % L::kStages;
    const uint32_t bar = full + 8 * st;
    const uint32_t qs = base + L::kRing + st * 2 * L::kQBytes;
    mbar_expect_tx(bar, 2 * L::kQBytes);
#pragma unroll
    for (int b = 0; b < HD / 32; ++b) {
      tma_load_3d(qs + b * NQ * 128, &tq, 32 * b, i * NQ, bh, bar);
      tma_load_3d(qs + L::kQBytes + b * NQ * 128, &tdo, 32 * b, i * NQ, bh,
                  bar);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kF32Threads);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
    mbar_expect_tx(kvbar, 2 * L::kOwnBytes);
#pragma unroll
    for (int b = 0; b < HD / 32; ++b) {
      tma_load_3d(base + b * NK * 128, &tk, 32 * b, k0, bh, kvbar);
      tma_load_3d(base + 2 * L::kOwnBytes + b * NK * 128, &tv, 32 * b, k0,
                  bh, kvbar);
    }
    for (int i = first; i < n_q && i < first + L::kStages; ++i) load_q(i);
  }
  __syncthreads();
  mbar_wait(kvbar, 0);
  split_tile(sm, sm + L::kOwnBytes, L::kOwnBytes);                     // K
  split_tile(sm + 2 * L::kOwnBytes, sm + 3 * L::kOwnBytes, L::kOwnBytes);
  fence_proxy_async();
  __syncthreads();

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  // This warpgroup's dVᵀ (0) or dKᵀ (1): hd rows x k columns, MT m-tiles.
  float acc[MT][NK / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) acc[mt][i] = 0.f;
  // wg 0: K, Pᵀ; wg 1: V, dSᵀ.
  const uint32_t own_hi = base + 2 * wg * L::kOwnBytes;
  const uint32_t pt_hi = base + L::kP + 2 * wg * L::kPBytes;
  // Pᵀ hi, Pᵀ lo, dSᵀ hi, dSᵀ lo from base + kP: this thread's S / dP
  // elements' places in each (transposed_at).
  uint32_t pt_at[4];
  transposed_at(NK, pt_at);
#pragma unroll
  for (int i = 0; i < 4; ++i) pt_at[i] += base + L::kP;

  for (int i = first; i < n_q; ++i) {
    const int it = i - first, st = it % L::kStages;
    const int q0 = i * NQ;
    const int qr = 16 * warp + lane / 4;   // this thread's q rows: qr, + 8
    float l2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + qr + 8 * h;
      l2[h] = q < S ? lse_g[q] * kLog2e : 0.f;
      dd[h] = q < S ? d_g[q] : 0.f;
    }
    mbar_wait(full + 8 * st, (it / L::kStages) & 1);
    const uint32_t qs = base + L::kRing + st * 2 * L::kQBytes;
    const uint32_t dos = qs + L::kQBytes;

    // wg 0: S = Q Kᵀ; wg 1: dP = dO Vᵀ (over hd).
    float s[NK / 2];
#pragma unroll
    for (int x = 0; x < NK / 2; ++x) s[x] = 0.f;
    mma_3xtf32<NK, HD / 8>(s, Tf32RowFrag<kF32Stream>(wg ? dos : qs), own_hi,
                           own_hi + L::kOwnBytes, NK);

    // Only tiles that cross the block's diagonal or S are masked.  The
    // accumulators are only read in the warpgroups' own branches: a write
    // there would make ptxas serialise the products (C7520).
    const bool masked = q0 < k0 + NK || q0 + NQ > S;
    bar_sync(1, kF32Threads);   // warpgroup 1 has read the last stage's P
    if (wg == 0) {
#pragma unroll
      for (int x = 0; x < NK / 2; ++x) {
        const int h = (x / 2) % 2;
        const int q = q0 + qr + 8 * h, kpos = k0 + 8 * (x / 4) + col + x % 2;
        float p = fast_exp2(s[x] * scale_log2 - l2[h]);
        if (masked && (kpos > q || q >= S)) p = 0.f;
        sts_split(pt_at[x % 4] + 1024 * (x / 4), L::kPBytes, p);
      }
      fence_proxy_async();
    }
    bar_sync(2, kF32Threads);   // Pᵀ written
    if (wg == 1) {
#pragma unroll
      for (int x = 0; x < NK / 2; ++x) {
        const uint32_t at = pt_at[x % 4] + 1024 * (x / 4);
        const float p = ld_shared_f32(at);   // Pᵀ hi: P in f32
        const int h = (x / 2) % 2;
        sts_split(at + 2 * L::kPBytes, L::kPBytes,
                  p * (s[x] - dd[h]) * scale);
      }
      fence_proxy_async();
      bar_sync(3, 128);   // dSᵀ written
    }

    // wg 0: dVᵀ += dOᵀ P; wg 1: dKᵀ += Qᵀ dS (over the 64 q rows).
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      mma_3xtf32<NK, NQ / 8>(
          acc[mt], Tf32ColFrag<kF32Stream>(wg ? qs : dos, 64 * mt, HD),
          pt_hi, pt_hi + L::kPBytes, NK);
    mbar_arrive(empty + 8 * st);
    if (tid < 32 && i + L::kStages < n_q) {   // warp 0 refills the stage
      mbar_wait(empty + 8 * st, (it / L::kStages) & 1);
      if (tid == 0) load_q(i + L::kStages);
      __syncwarp();
    }
  }

  // dVᵀ (wg 0) and dKᵀ (wg 1) staged as rows of k once both are done with
  // the ring, then stored 16 bytes a thread, rows < S.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(sm + L::kRing);
  float* mine = stage + wg * NK * L::kStageLd;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int m = 64 * mt + 16 * warp + lane / 4 + 8 * h;
          if (m < HD)
            mine[(8 * j + col + v) * L::kStageLd + m] =
                acc[mt][4 * j + 2 * h + v];
        }
  __syncthreads();
  const size_t out0 = (static_cast<size_t>(bh) * S + k0) * HD;
  for (int i = tid; i < 2 * NK * HD / 4; i += kF32Threads) {
    const int t = i / (NK * HD / 4), rem = i % (NK * HD / 4);
    const int rr = rem / (HD / 4), cc = 4 * (rem % (HD / 4));
    if (k0 + rr < S)
      *reinterpret_cast<float4*>((t ? dk : dv) + out0 +
                                 static_cast<size_t>(rr) * HD + cc) =
          *reinterpret_cast<const float4*>(stage + t * NK * L::kStageLd +
                                           rr * L::kStageLd + cc);
  }
}

// Shared memory of dQ, in bytes from a 1024-aligned base: Q hi, Q lo, dO
// hi, dO lo (kOwn rows each, resident), a ring of (K, V) stages (64 rows
// each), dS hi and lo (kOwn q rows of 64 k positions), Pᵀ in f32 for
// warpgroup 1 (64 k rows of kPld), the barriers.
template <int HD>
struct DqF32Plan {
  static constexpr int kOwn = HD == 128 ? 32 : 64;
  static constexpr int kOwnBytes = kOwn * HD * 4;
  static constexpr int kKvBytes = kF32Stream * HD * 4;   // one of K, V
  static constexpr int kStages = HD == 128 ? 2 : HD == 64 ? 3 : 4;
  static constexpr int kDsBytes = kOwn * kF32Stream * 4;
  // Pᵀ's rows, floats: 8 more than a multiple of 32 puts a half-warp's
  // float2s (4 rows x 4 pairs) on 32 distinct banks.
  static constexpr int kPld = kOwn + 8;
  static constexpr int kRing = 4 * kOwnBytes;
  static constexpr int kDs = kRing + kStages * 2 * kKvBytes;
  static constexpr int kP = kDs + 2 * kDsBytes;
  static constexpr int kBars = kP + kF32Stream * kPld * 4;
  static constexpr int kBytes = 1024 + kBars + (2 * kStages + 1) * 8;
  static constexpr int kStageLd = HD + 4;
  static_assert(HD % 32 == 0 && HD <= 128, "head dim: 32-column boxes");
  static_assert(kOwn * kStageLd * 4 <= kDs - kRing, "staging fits");
  static_assert(kBytes <= 227 * 1024, "shared memory per block");
};

// Thread block (b*h, q tile): dQ of the kOwn q rows at q0 of head bh,
// heaviest (highest) q tiles first; Q and dO resident, each thread's q
// columns' lse (log2 units) and D in registers.  Per (K, V) stage up to
// the diagonal: warpgroup 0 computes Sᵀ = K Qᵀ and Pᵀ (0 above the
// diagonal) and writes it in f32; warpgroup 1 computes dPᵀ = V dOᵀ and,
// once Pᵀ is written, dSᵀ = Pᵀ (dPᵀ - D) scale, and writes dS; then each
// warpgroup adds Kᵀ dSᵀ to its part of dQᵀ: one of the two m-tiles of hd
// at hd 128 (N = 32), half the columns below (N = 32).
template <int HD>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ dsum,
                            float* __restrict__ dq, int S, float scale) {
  using L = DqF32Plan<HD>;
  constexpr int NQ = L::kOwn, NK = kF32Stream;
  // dQᵀ (hd x NQ) between the warpgroups: an m-tile of 64 hd rows each at
  // hd 128, else half the columns each.
  constexpr bool kSplitM = HD == 128;
  constexpr int NW = kSplitM ? NQ : NQ / 2;   // dQᵀ columns a warpgroup
  extern __shared__ unsigned char dq32_smem[];
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * NQ;
  // The k tiles on or below the block's last diagonal, and below S.
  const int n_kv = min((q0 + NQ - 1) / NK + 1, (S + NK - 1) / NK);
  const int tid = threadIdx.x;

  const uint32_t base = (smem_u32(dq32_smem) + 1023) & ~1023u;
  unsigned char* sm = dq32_smem + (base - smem_u32(dq32_smem));
  const uint32_t full = base + L::kBars;
  const uint32_t empty = full + 8 * L::kStages;
  const uint32_t qbar = empty + 8 * L::kStages;
  auto load_kv = [&](int j) {   // (K, V) tile j into its stage (one thread)
    const int st = j % L::kStages;
    const uint32_t bar = full + 8 * st;
    const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
    mbar_expect_tx(bar, 2 * L::kKvBytes);
#pragma unroll
    for (int b = 0; b < HD / 32; ++b) {
      tma_load_3d(ks + b * NK * 128, &tk, 32 * b, j * NK, bh, bar);
      tma_load_3d(ks + L::kKvBytes + b * NK * 128, &tv, 32 * b, j * NK, bh,
                  bar);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, kF32Threads);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
    mbar_expect_tx(qbar, 2 * L::kOwnBytes);
#pragma unroll
    for (int b = 0; b < HD / 32; ++b) {
      tma_load_3d(base + b * NQ * 128, &tq, 32 * b, q0, bh, qbar);
      tma_load_3d(base + 2 * L::kOwnBytes + b * NQ * 128, &tdo, 32 * b, q0,
                  bh, qbar);
    }
    for (int j = 0; j < n_kv && j < L::kStages; ++j) load_kv(j);
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  // This thread's q columns q0 + 8 j + col + v; rows >= S take 0, so
  // their P is finite (their dq rows are dropped).
  float l2[NQ / 8][2], dd[NQ / 8][2];
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const int q = q0 + 8 * j + col + v;
      const size_t at = static_cast<size_t>(bh) * S + q;
      l2[j][v] = q < S ? lse[at] * kLog2e : 0.f;
      dd[j][v] = q < S ? dsum[at] : 0.f;
    }
  __syncthreads();
  mbar_wait(qbar, 0);
  split_tile(sm, sm + L::kOwnBytes, L::kOwnBytes);                     // Q
  split_tile(sm + 2 * L::kOwnBytes, sm + 3 * L::kOwnBytes, L::kOwnBytes);
  fence_proxy_async();
  __syncthreads();

  // This warpgroup's part of dQᵀ: hd rows m0 .., q columns c0 ...
  const int m0 = kSplitM ? 64 * wg : 0, c0 = kSplitM ? 0 : NW * wg;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const uint32_t own_hi = base + 2 * wg * L::kOwnBytes;   // Q (0), dO (1)
  const uint32_t ds_hi = base + L::kDs;
  uint32_t ds_at[4];   // this thread's dSᵀ elements' places in dS
  transposed_at(NQ, ds_at);
#pragma unroll
  for (int i = 0; i < 4; ++i) ds_at[i] += ds_hi;
  float* pt = reinterpret_cast<float*>(sm + L::kP);
  const int kr = 16 * warp + lane / 4;   // this thread's k rows: kr, + 8

  for (int j = 0; j < n_kv; ++j) {
    const int st = j % L::kStages;
    mbar_wait(full + 8 * st, (j / L::kStages) & 1);
    const uint32_t ks = base + L::kRing + st * 2 * L::kKvBytes;
    const uint32_t vs = ks + L::kKvBytes;

    // wg 0: Sᵀ = K Qᵀ; wg 1: dPᵀ = V dOᵀ (over hd).
    float s[NQ / 2];
#pragma unroll
    for (int x = 0; x < NQ / 2; ++x) s[x] = 0.f;
    mma_3xtf32<NQ, HD / 8>(s, Tf32RowFrag<kF32Stream>(wg ? vs : ks), own_hi,
                           own_hi + L::kOwnBytes, NQ);

    // Only the tiles past q0 hold k > q; k >= S lies there too for every
    // q < S, so the causal mask covers it.
    const int kb = j * NK;
    const bool masked = kb + NK - 1 > q0;
    bar_sync(1, kF32Threads);   // warpgroup 1 has read the last stage's Pᵀ
    if (wg == 0) {   // Pᵀ, computed where it is stored (not into Sᵀ)
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            p[v] = fast_exp2(s[4 * jj + 2 * h + v] * scale_log2 - l2[jj][v]);
            if (masked && kb + kr + 8 * h > q0 + 8 * jj + col + v) p[v] = 0.f;
          }
          *reinterpret_cast<float2*>(pt + (kr + 8 * h) * L::kPld + 8 * jj +
                                     col) = make_float2(p[0], p[1]);
        }
    }
    bar_sync(2, kF32Threads);   // Pᵀ written
    if (wg == 1) {
#pragma unroll
      for (int jj = 0; jj < NQ / 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 p = *reinterpret_cast<const float2*>(
              pt + (kr + 8 * h) * L::kPld + 8 * jj + col);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int x = 4 * jj + 2 * h + v;
            sts_split(ds_at[x % 4] + 1024 * jj, L::kDsBytes,
                      (v ? p.y : p.x) * (s[x] - dd[jj][v]) * scale);
          }
        }
      fence_proxy_async();
    }
    bar_sync(3, kF32Threads);   // dS written

    // This warpgroup's part of dQᵀ += Kᵀ dSᵀ (over the 64 k rows).
    mma_3xtf32<NW, NK / 8>(acc, Tf32ColFrag<kF32Stream>(ks, m0, HD),
                           ds_hi + c0 * 128, ds_hi + L::kDsBytes + c0 * 128,
                           NQ);
    mbar_arrive(empty + 8 * st);
    if (tid < 32 && j + L::kStages < n_kv) {   // warp 0 refills the stage
      mbar_wait(empty + 8 * st, (j / L::kStages) & 1);
      if (tid == 0) load_kv(j + L::kStages);
      __syncwarp();
    }
  }

  // dQᵀ staged as rows of q once both warpgroups are done with the ring,
  // then stored 16 bytes a thread, rows < S.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(sm + L::kRing);
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int m = m0 + kr + 8 * h;
        if (m < HD)
          stage[(c0 + 8 * jj + col + v) * L::kStageLd + m] =
              acc[4 * jj + 2 * h + v];
      }
  __syncthreads();
  float* out = dq + (static_cast<size_t>(bh) * S + q0) * HD;
  for (int i = tid; i < NQ * HD / 4; i += kF32Threads) {
    const int rr = i / (HD / 4), cc = 4 * (i % (HD / 4));
    if (q0 + rr < S)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(rr) * HD + cc) =
          *reinterpret_cast<const float4*>(stage + rr * L::kStageLd + cc);
  }
}

// -------------------------------------------------------- f32 forward ----
// A thread block of 128 threads (kF32FwdThreads) owns a 64-row q tile and
// walks the 64-row (K, V) tiles on or below its diagonal, heaviest (highest)
// q tiles first.  Thread (ty, tx) = (t / 16, t % 16) holds the logits of
// q rows ty + 8 i (i < 8) and k columns tx + 16 j (j < 4) of each (64 x 64)
// tile, and the outputs of the same rows at columns 16 VW c + VW tx + e
// (c < NC, e < VW: HD / 16 of them): S = Q Kᵀ takes 12 float4 loads of
// Q and K from shared memory a depth step of 4 for 128 FMAs, and O += P V
// 4 loads (P, V) a k for 64 (at hd 128).  Q, K and V are row-major with no
// pad, the 16-byte chunks of a row XOR-swizzled by the row's low 3 bits
// (swz), so a quarter-warp's 8 K rows or V chunks land on 32 distinct
// banks; the rows of a thread share their low 3 bits, so one XOR serves
// all 8.  P goes through shared memory transposed ([k][row], the row index
// permuted to 8 ty + i), so a thread reads its 8 rows' P at one k as two
// float4s.  Shared memory: Q, K, V and P, 112 KB at hd 128 with one
// buffer each, so two thread blocks fit an SM and one's loads and barriers
// overlap the other's products: V_j is copied during S_j and its softmax,
// K_{j+1} during P V_j (cp.async, two barriers a tile).  The online
// softmax runs on each thread's 8 x 4 logits with full-precision expf: the
// row max by 4 shuffles over the 16 lanes of a row, the row sum kept per
// thread and added across the lanes once at the end.  On an H100 it runs
// at about a third of the FFMA peak, as packed_mm_ffma_kernel does; trial
// variants (128-row tiles with a double-buffered ring and one barrier a
// tile, 4 x 4 logits on 16 warps an SM, loads pipelined by hand between
// the FMAs) were each within 10% of it (PERF.md, PR 11).
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

constexpr int kF32FwdRows = 64;       // q rows of a block, k rows of a tile
constexpr int kF32FwdThreads = 128;

template <int HD>
struct F32FwdPlan {
  static constexpr int kTileBytes = kF32FwdRows * HD * 4;   // Q, K or V
  static constexpr int kQ = 0, kK = kTileBytes, kV = 2 * kTileBytes;
  static constexpr int kP = 3 * kTileBytes;                 // (64 x 64) Pᵀ
  static constexpr int kBytes = kP + kF32FwdRows * kF32FwdRows * 4;
  static_assert(HD % 32 == 0 && HD <= 128, "head dim: 8 chunks a row");
  static_assert(2 * (kBytes + 1024) <= 228 * 1024, "two blocks an SM");
};

// Offset in floats of element (r, c) of a row-major f32 tile W floats wide
// whose 16-byte chunks are swizzled: chunk c / 4 of row r lies at chunk
// (c / 4) ^ (r % 8).
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  return r * W + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// Rows r0 .. r0 + 63 of a (S x HD) f32 matrix into a swizzled tile, as
// 16-byte cp.asyncs; rows >= S zero-filled.
template <int HD>
__device__ __forceinline__ void f32_fwd_load(float* dst, const float* src,
                                             int r0, int S) {
  constexpr int kPerRow = HD / 4;
  for (int c = threadIdx.x; c < kF32FwdRows * kPerRow; c += kF32FwdThreads) {
    const int r = c / kPerRow, cc = (c % kPerRow) * 4;
    const bool ok = r0 + r < S;
    cp_async16(dst + swz<HD>(r, cc),
               ok ? src + static_cast<size_t>(r0 + r) * HD + cc : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32FwdThreads, 2)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, float scale) {
  using L = F32FwdPlan<HD>;
  constexpr int T = kF32FwdRows;
  constexpr int CW = HD / 16;            // output columns a thread
  constexpr int VW = CW < 4 ? CW : 4;    // read VW at a time
  constexpr int NC = CW / VW;
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* qs = reinterpret_cast<float*>(f32_smem + L::kQ);
  float* ks = reinterpret_cast<float*>(f32_smem + L::kK);
  float* vs = reinterpret_cast<float*>(f32_smem + L::kV);
  float* ps = reinterpret_cast<float*>(f32_smem + L::kP);
  const int qt = gridDim.x - 1 - blockIdx.x, q0 = qt * T;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * HD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  f32_fwd_load<HD>(qs, q + base, q0, S);
  f32_fwd_load<HD>(ks, k + base, 0, S);
  f32_fwd_load<HD>(vs, v + base, 0, S);
  cp_async_commit();

  float m_run[8], l_run[8], acc[8][CW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m_run[i] = -INFINITY;   // the first tile holds k = 0 for every row
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }
  for (int j = 0; j <= qt; ++j) {
    cp_async_wait<0>();   // K_j (and V_j at j = 0)
    __syncthreads();      // ... visible; P and V_{j-1} free
    if (j > 0) {
      f32_fwd_load<HD>(vs, v + base, j * T, S);
      cp_async_commit();
    }

    // S = Q Kᵀ: rows ty + 8 i, columns tx + 16 jj.
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 b[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(ks + swz<HD>(tx + 16 * jj, d));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(qs + swz<HD>(ty + 8 * i, d));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float x = s[i][jj];
          x = fmaf(a.x, b[jj].x, x);
          x = fmaf(a.y, b[jj].y, x);
          x = fmaf(a.z, b[jj].z, x);
          s[i][jj] = fmaf(a.w, b[jj].w, x);
        }
      }
    }

    // Online softmax; only the diagonal tile (the last) holds k > q, and
    // k >= S lies there too for every row < S.  P into shared memory as
    // Pᵀ[k][8 ty + i].
    const bool diag = j == qt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 8 * i;
      float mx = m_run[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * scale;
        if (diag && j * T + tx + 16 * jj > qpos) x = -INFINITY;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float corr = expf(m_run[i] - mx);
      m_run[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mx);
        s[i][jj] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int kr = tx + 16 * jj;
      *reinterpret_cast<float4*>(ps + swz<T>(kr, 8 * ty)) =
          make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
      *reinterpret_cast<float4*>(ps + swz<T>(kr, 8 * ty + 4)) =
          make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
    }
    cp_async_wait<0>();   // V_j
    __syncthreads();      // ... and P visible; K_j free
    if (j < qt) {
      f32_fwd_load<HD>(ks, k + base, (j + 1) * T, S);
      cp_async_commit();
    }

    // O += P V over the tile's 64 k rows.
#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(ps + swz<T>(kk, 8 * ty));
      const float4 p1 =
          *reinterpret_cast<const float4*>(ps + swz<T>(kk, 8 * ty + 4));
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float vv[CW];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float* src = vs + swz<HD>(kk, 16 * VW * c + VW * tx);
        if constexpr (VW == 4) {
          const float4 t = *reinterpret_cast<const float4*>(src);
          vv[4 * c] = t.x;
          vv[4 * c + 1] = t.y;
          vv[4 * c + 2] = t.z;
          vv[4 * c + 3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(src);
          vv[2 * c] = t.x;
          vv[2 * c + 1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // o = acc / l, l summed across the row's 16 lanes; lse = m + log(l).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty + 8 * i;
    const float l = row_sum16(l_run[i]);
    if (qpos >= S) continue;
    if (tx == 0)
      lse[static_cast<size_t>(blockIdx.y) * S + qpos] = m_run[i] + logf(l);
    const float inv = 1.f / l;
    float* dst = o + base + static_cast<size_t>(qpos) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float* at = dst + 16 * VW * c + VW * tx;
      if constexpr (VW == 4)
        *reinterpret_cast<float4*>(at) =
            make_float4(acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                        acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
      else
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[i][2 * c] * inv, acc[i][2 * c + 1] * inv);
    }
  }
}

// Above 48 KB, dynamic shared memory must be allowed per kernel and device:
// once for each (instantiation, device), not on every launch.  The largest
// carveout of shared memory from the SM's 256 KB lets as many blocks share
// an SM as their shared memory allows (two of the f32 forward's 112 KB).
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
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

// The 3-D tensor map of a (b*h, S, HD) bf16 tensor: boxes of 64 columns x
// `rows` rows of one head.
cudaError_t head_map(CUtensorMap* map, const void* base, int bh, int S,
                     int hd, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(S) * hd * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return bf16_map_nd(map, base, 3, dims, strides, box);
}

// The wgmma kernels' grid: (b*h, 128-row tiles), at most 65535 tiles.
bool wgmma_grid(int bh, int S, dim3* grid) {
  const int tiles = (S + kBlockRows - 1) / kBlockRows;
  *grid = dim3(bh, tiles);
  return tiles <= 65535;
}

template <int HD>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int S, float scale,
                       cudaStream_t stream) {
  dim3 grid;
  if (!wgmma_grid(bh, S, &grid)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t err = head_map(&tq, q, bh, S, HD, kBlockRows);
  if (err == cudaSuccess) err = head_map(&tk, k, bh, S, HD, kFwdKv);
  if (err == cudaSuccess) err = head_map(&tv, v, bh, S, HD, kFwdKv);
  if (err != cudaSuccess) return err;
  constexpr int smem = FwdPlan<HD>::kBytes;
  auto kernel = flash_fwd_wgmma_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), S,
      scale * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* dsum,
                       void* dk, void* dv, int bh, int S, float scale,
                       cudaStream_t stream) {
  dim3 grid;
  if (!wgmma_grid(bh, S, &grid)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, bh, S, HD, kDkvQ);
  if (err == cudaSuccess) err = head_map(&tdo, dout, bh, S, HD, kDkvQ);
  if (err == cudaSuccess) err = head_map(&tk, k, bh, S, HD, kBlockRows);
  if (err == cudaSuccess) err = head_map(&tv, v, bh, S, HD, kBlockRows);
  if (err != cudaSuccess) return err;
  constexpr int smem = DkvPlan<HD>::kBytes;
  auto kernel = flash_bwd_dkv_wgmma_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dsum,
                      void* dq, int bh, int S, float scale,
                      cudaStream_t stream) {
  dim3 grid;
  if (!wgmma_grid(bh, S, &grid)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, bh, S, HD, kBlockRows);
  if (err == cudaSuccess) err = head_map(&tdo, dout, bh, S, HD, kBlockRows);
  if (err == cudaSuccess) err = head_map(&tk, k, bh, S, HD, kDqKv);
  if (err == cudaSuccess) err = head_map(&tv, v, bh, S, HD, kDqKv);
  if (err != cudaSuccess) return err;
  constexpr int smem = DqPlan<HD>::kBytes;
  auto kernel = flash_bwd_dq_wgmma_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dq), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, void* lse, int bh, int S, float scale,
                           cudaStream_t stream) {
  constexpr int smem = F32FwdPlan<HD>::kBytes;
  auto kernel = flash_fwd_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kF32FwdRows - 1) / kF32FwdRows, bh);
  kernel<<<grid, kF32FwdThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), S, scale);
  return cudaGetLastError();
}

// The 3-D tensor map of a (b*h, S, HD) f32 tensor: boxes of 32 columns x
// `rows` rows of one head.
cudaError_t head_map_f32(CUtensorMap* map, const void* base, int bh, int S,
                         int hd, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 4,
                                 static_cast<cuuint64_t>(S) * hd * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  return f32_map_nd(map, base, 3, dims, strides, box);
}

// The f32 backward kernels' launch: grid (b*h, tiles of `own` rows), the
// owned tensors' maps in boxes of `own` rows, the streamed ones' in 64.
template <typename Kernel>
cudaError_t launch_bwd_f32(Kernel kernel, int smem, int own,
                           std::atomic<uint64_t>& allowed,
                           const void* owned0, const void* owned1,
                           const void* streamed0, const void* streamed1,
                           int bh, int S, int hd, dim3* grid,
                           CUtensorMap (&maps)[4]) {
  const int tiles = (S + own - 1) / own;
  if (tiles > 65535) return cudaErrorInvalidValue;
  *grid = dim3(bh, tiles);
  cudaError_t err = head_map_f32(&maps[0], owned0, bh, S, hd, own);
  if (err == cudaSuccess) err = head_map_f32(&maps[1], owned1, bh, S, hd, own);
  if (err == cudaSuccess)
    err = head_map_f32(&maps[2], streamed0, bh, S, hd, kF32Stream);
  if (err == cudaSuccess)
    err = head_map_f32(&maps[3], streamed1, bh, S, hd, kF32Stream);
  if (err == cudaSuccess) err = allow_smem(kernel, smem, allowed);
  return err;
}

template <int HD>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* dsum, void* dk, void* dv, int bh,
                           int S, float scale, cudaStream_t stream) {
  using L = DkvF32Plan<HD>;
  auto kernel = flash_bwd_dkv_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  dim3 grid;
  CUtensorMap m[4];   // k, v (owned); q, do (streamed)
  cudaError_t err = launch_bwd_f32(kernel, L::kBytes, L::kOwn, allowed, k, v,
                                   q, dout, bh, S, HD, &grid, m);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(
      m[2], m[0], m[1], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<float*>(dk),
      static_cast<float*>(dv), S, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* dsum, void* dq, int bh, int S,
                          float scale, cudaStream_t stream) {
  using L = DqF32Plan<HD>;
  auto kernel = flash_bwd_dq_f32_kernel<HD>;
  static std::atomic<uint64_t> allowed{0};
  dim3 grid;
  CUtensorMap m[4];   // q, do (owned); k, v (streamed)
  cudaError_t err = launch_bwd_f32(kernel, L::kBytes, L::kOwn, allowed, q,
                                   dout, k, v, bh, S, HD, &grid, m);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kF32Threads, L::kBytes, stream>>>(
      m[0], m[2], m[3], m[1], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<float*>(dq), S, scale);
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
// kernels: flash_fwd_f32_kernel, flash_bwd_dkv_f32_kernel,
// flash_bwd_dq_f32_kernel); lse and dsum as above.

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

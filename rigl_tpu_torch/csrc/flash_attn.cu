// Causal flash attention, forward and backward, for q, k, v of (B, H, S, hd),
// contiguous, hd in {32, 64, 128}: three tensor-core kernels for bf16, and
// f32 variants of the three on the CUDA cores (section "f32" below, behind
// the entry points with an `_f32` suffix).
//
//   flash_fwd_wgmma_kernel      behind `flash_fwd`:
//       o = softmax(scale * q kᵀ + causal mask) v, and the f32 row statistic
//       lse = m + log(l) (row max m, row sum l of exp(logit - m)).
//   flash_bwd_dkv_wgmma_kernel  behind `flash_bwd_dkv`:  dk, dv.
//   flash_bwd_dq_kernel         behind `flash_bwd_dq`:   dq.
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
// from run to run.  In f32 the same work runs at 67 TFLOP/s on the CUDA
// cores and moves twice the bytes, so the operations bound it (64-128 us
// at that shape, against 20-30 us of bytes).
//
// The bf16 forward and dK/dV are Hopper designs (section "bf16 forward,
// dK/dV"): wgmma fed by a TMA ring with mbarriers in blocks of two
// warpgroups, and the logits never leave registers: the
// accumulator's fragments take the masked softmax in place and, rounded to
// bf16, are the register A operand of the next wgmma.  The bf16 dQ is the
// first design: WMMA (bf16 in, f32 accumulate) on a 2-deep cp.async ring,
// 64-row tiles, the logits staged in shared memory in f32 for the masked
// softmax, since WMMA's accumulator layout is opaque.  A ragged S (not a
// multiple of the tile) is zero-filled in the copies and masked by
// position, so JAX's 128-multiple requirement (MIN_BLOCK_SIZE) has no
// counterpart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>
#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;
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

// acc (FM x FN 16x16 tiles) += A @ B over DEPTH, A and B row-major.
// Pointers are at the warp's tile origin.
template <int FM, int FN, int DEPTH>
__device__ __forceinline__ void mma_ab(Frag (&acc)[FM][FN], const bf16* a,
                                       int lda, const bf16* b, int ldb) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < DEPTH; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
      wmma::load_matrix_sync(fa[i], a + i * 16 * lda + kk, lda);
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
                                          int ldc) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      nvcuda::wmma::store_matrix_sync(c + i * 16 * ldc + j * 16, acc[i][j],
                                      ldc, nvcuda::wmma::mem_row_major);
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

// ------------------------------------------------- bf16 forward, dK/dV ----
// wgmma kernels on a TMA ring.  A thread block is two warpgroups, 64 rows
// of the block's 128-row tile each; warp 0 also drives the ring: it fills
// the first stages at the start and refills a stage once both warpgroups
// have released it (an mbarrier per stage for arrival, one for release),
// lane 0 issuing the TMA copies.  No producer warpgroup: with a third, a
// block has 12 warps, three on each of the SM's four register partitions,
// which caps the entry budget at 168 registers a thread; setmaxnreg lets
// the consumers allocate 240, but ptxas budgets wgmma's pipelining by the
// entry count and serialises the products (warning C7512) where the
// consumers need more than 168, as both kernels do at hd 128.  Two
// warpgroups start with 255.  q, k, v and do are read through 3-D tensor
// maps (hd, S, b*h) in boxes of 64 columns (128 bytes, the swizzle's span)
// x R rows: a tile of R rows is kDp / 64 such boxes, each R rows of 128
// bytes.  TMA fills rows past S, and at hd 32 columns 32 .. 63, with
// zeros, so a tile is always 64-column-aligned and full; the position mask
// keeps those rows out of every sum, and the epilogue drops them.
constexpr int kWgThreads = 256;    // two warpgroups
constexpr int kBlockRows = 128;    // q rows (forward) or k rows (dK/dV)
constexpr int kFwdKv = 128;        // k / v rows of a forward ring stage
constexpr int kDkvQ = 64;          // q / do rows of a dK/dV ring stage
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

// ------------------------------------------------------------ bf16 dq ----
// 8 warps, laid out 4 x 2 over a 64 x 64 logit tile (16 x 32 each) and
// over a 64 x HD output tile (16 x HD/2 each).  The elementwise pass gives
// thread t row t / 4 and columns 16 (t % 4) .. + 15.
constexpr int kBwdThreads = 256;

// dS of one (q tile, k tile) pair, from the staged logits `ss` and dP = do
// vᵀ `dps`: P = exp(scale * s - lse) on or below the diagonal (0 elsewhere
// and on rows >= S), dS = P * (dP - D) * scale, written as bf16 with row
// stride pld.
__device__ __forceinline__ void ds_tile(const float* ss, const float* dps,
                                        int sld, bf16* dss, int pld, int q0,
                                        int k0, int S, float lse_r,
                                        float d_r, float scale) {
  const int r = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  const int qpos = q0 + r;
#pragma unroll
  for (int c = c0; c < c0 + 16; ++c) {
    const int kpos = k0 + c;
    const bool ok = kpos <= qpos && qpos < S;
    const float p = ok ? __expf(ss[r * sld + c] * scale - lse_r) : 0.f;
    dss[r * pld + c] = __float2bfloat16(p * (dps[r * sld + c] - d_r) * scale);
  }
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
    ds_tile(ss, dps, L::kSld, dss, L::kPld, q0, j * kTile, S, lse_r, d_r,
            scale);
    __syncthreads();

    // dq += dS k (q rows x HD).
    mma_ab<1, HD / 32, kTile>(acc, dss + wr * 16 * L::kPld, L::kPld,
                              k_tile(st) + wc * (HD / 2), L::kLd);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  float* stage = reinterpret_cast<float*>(smem + L::kRing);
  store_acc<1, HD / 32>(acc, stage + wr * 16 * L::kOld + wc * (HD / 2),
                        L::kOld);
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

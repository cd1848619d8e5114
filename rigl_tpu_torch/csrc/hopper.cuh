// Hopper (sm_90a) building blocks that the port's kernels share: shared
// memory addresses, mbarriers, TMA copies and the tensor maps they read,
// wgmma operand descriptors, fences and the products themselves, named
// barriers, and the cluster barrier and stores into distributed shared
// memory.  Included by packed_mm.cu, flash_attn.cu and tap_conv.cu; each
// of those is built into a library of its own, and everything here is
// inline.
//
// wgmma's fragment layout, used by every kernel that reads an accumulator:
// in an m64nNk16 product the warpgroup's 128 threads hold D (64 x N, f32)
// as d[4j + 2h + v] = D[16 w + lane / 4 + 8 h][8 j + 2 (lane % 4) + v],
// w the thread's warp in the warpgroup; a row's N values lie in the 4
// lanes of a quad.  The bf16 A operand from registers (the RS form) takes
// the same layout for its 16 columns (bf16_a_fragment).  The tf32 A
// operand of an m64nNk8 product (wgmma_tf32_rs) holds a[0..3] = A[16 w +
// lane / 4 + 8 i][lane % 4 + 4 j] for (i, j) = (0, 0), (1, 0), (0, 1),
// (1, 1): its columns do not pair as an accumulator's do.

#pragma once

#include <cuda.h>   // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After a thread has initialised the barriers, before anyone uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a fault in the pipeline) traps, which the next
// synchronisation reports, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: the box of the 2-D `map` at (column c, row r) into shared memory at
// `dst`, completing `bar`'s transaction bytes.  Rows and columns outside
// the tensor are filled with zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c, int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// The same for a 3-D map, coordinates (c0, c1, c2) innermost first.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// The same for a 4-D map, coordinates innermost first; each coordinate is
// bounded by its own dimension, so a box never reads into a neighbour.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of an operand tile with 128-byte swizzle,
// stored as rows of 64 elements (128 bytes), 1024 bytes between groups of 8
// rows.  MN-major (rows consecutive in the contraction): `lbo` the bytes
// between 64-element column blocks.  K-major (rows consecutive in M or N,
// the contraction along the row): `lbo` unused (16), and a step of 16 in the
// contraction is 32 bytes added to `addr` inside the swizzle atom.  The
// tile starts 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The same for a K-major tile with 64-byte swizzle: rows of 64 bytes (16
// tf32 of the contraction: two k-steps of 8, the second 32 bytes into the
// row), chunk c of row r at c ^ ((r / 2) % 4) as TMA's 64-byte swizzle
// writes it, 512 bytes between groups of 8 rows.  The tile starts 512-byte
// aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) |
         (static_cast<uint64_t>(2) << 62);
}

// The same for a tile with 32-byte swizzle, MN-major: 8-row groups of 32
// bytes (16 bf16 of M or N a row, chunk c of row r at c ^ ((r / 4) % 2)),
// 256 bytes apart; `lbo` the bytes between 16-element column blocks.  The
// tile starts 256-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t wgmma_desc_sw32(uint32_t addr,
                                                    uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) |
         (static_cast<uint64_t>(3) << 62);
}

// Orders this thread's completed writes to shared memory by ordinary
// instructions or cp.async (the generic proxy) before later reads by the
// async proxy (wgmma, TMA stores), its own and, after a barrier, other
// threads'.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Before the first wgmma that reads registers or shared memory written by
// ordinary instructions; commit closes a group of issued products; wait
// returns once at most N groups are in flight.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins an accumulator's registers at this point of the program, so that
// the compiler moves no use of them across a wgmma_wait or a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The same for registers holding operands (a tf32 A fragment): computed
// here, before the wgmma_fence that follows, not sunk past it.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two f32 values as a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The bf16 A operand of k-step kk (columns 16 kk .. 16 kk + 15) from an
// accumulator of the fragment layout above, rounded: the RS form's
// registers for the product that contracts over the accumulator's columns.
template <int N>
__device__ __forceinline__ void bf16_a_fragment(const float (&d)[N], int kk,
                                                uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The cluster barrier, split: every thread of every block of the cluster
// arrives, then waits.  cluster_arrive releases this thread's writes to
// shared memory (an mbarrier's initialisation among them), which
// cluster_wait makes visible to the cluster's blocks.  A grid launched
// without clusters is made of clusters of one block.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The shared::cluster address, in block `rank` of this cluster, of the
// shared memory that has address `addr` in this block.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Four f32 values to a shared::cluster address (16-byte aligned) of
// another block, completing 16 transaction bytes of the mbarrier at the
// shared::cluster address `bar` in that block.
__device__ __forceinline__ void st_async_f4(uint32_t addr, uint32_t bar,
                                            float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Brings a tensor map (a kernel parameter) into the TMA unit's cache
// before its first copy.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma products --------------------------------------------------------
// d (64 x 128, f32, the warpgroup's registers) += A (64 x 16) @ B (16 x
// 128), bf16, both from shared memory: kTransA / kTransB = 1 reads the
// operand MN-major (transposed), 0 K-major.  scale_d = 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, f32, the warpgroup's registers) += A (64 x 16) @ B (16 x
// 64), bf16, both from shared memory: kTransA / kTransB = 1 reads the
// operand MN-major (transposed), 0 K-major.  scale_d = 0 overwrites d.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// d (64 x N, f32) += A (64 x 16) @ B (16 x N), bf16, both from shared
// memory, for the narrow N of small blocks (48, 32, 16); kTransA / kTransB
// as above.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n48k16(float (&d)[24], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

// d (64 x N) += A @ B with both operands in shared memory, for N = 8, 16,
// 32, 48, 64 or 128: the SS product of that width.
template <int N, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 48 || N == 64 ||
                    N == 128,
                "no SS product of this width");
  if constexpr (N == 128)
    wgmma_m64n128k16<kTransA, kTransB>(d, da, db);
  else if constexpr (N == 64)
    wgmma_m64n64k16<kTransA, kTransB>(d, da, db);
  else if constexpr (N == 48)
    wgmma_m64n48k16<kTransA, kTransB>(d, da, db);
  else if constexpr (N == 32)
    wgmma_m64n32k16<kTransA, kTransB>(d, da, db);
  else if constexpr (N == 16)
    wgmma_m64n16k16<kTransA, kTransB>(d, da, db);
  else
    wgmma_m64n8k16<kTransA, kTransB>(d, da, db);
}

// d (64 x 128, f32) += A (64 x 16) @ B (16 x 128), bf16: A from registers
// (a[0..3], the fragment layout of an m64nNk16 accumulator's 16 columns:
// see bf16_a_fragment), B from shared memory, kTransB as above.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransB));
}

// d (64 x 64, f32) += A (64 x 16) @ B (16 x 64), bf16: A from registers
// (a[0..3], the fragment layout of an m64nNk16 accumulator's 16 columns:
// see bf16_a_fragment), B from shared memory, kTransB as above.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransB));
}

// d (64 x 16, f32) += A (64 x 16) @ B (16 x 16), bf16, A from registers
// as above, issued only where `on` is nonzero (the same value in every
// thread of the warpgroup): a guard predicate, not a branch.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n16k16_rs_if(float (&d)[8],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     unsigned on) {
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %13, 0;\n"
      "setp.ne.b32 q, %15, 0;\n"
      "@q wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(kTransB), "r"(on));
}

// ---- tf32 products, for error-compensated f32 (3xTF32) -----------------
// The tensor cores read a tf32 operand, from a register or from shared
// memory, as the top 19 bits of its f32 pattern: the 13 low mantissa bits
// are ignored, so the value read is x truncated toward zero to 10 mantissa
// bits.  tf32_split therefore passes x itself as hi, and lo = x minus
// that truncation (exact in f32), read truncated in turn: hi + lo as read
// is x to 2^-20 |x|, and a b = a_hi b_hi + a_hi b_lo + a_lo b_hi to about
// 2^-19 |a b| (a_lo b_lo left out).  One LOP and one FADD, no rounding
// instruction; hi keeps x's bits, so a NaN stays a NaN (the card's
// 0x7FFFFFFF reads as 0x7FFFE000; one that reads as infinity gives a NaN
// lo), and a P or dS stored as hi is P or dS in f32.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// Byte offset of element (r, c) of an f32 tile of `rows` rows stored as
// TMA writes it with 128-byte swizzle (boxes of 32 columns, one after
// another, each `rows` rows of 128 bytes; 16-byte chunk j of row r at j ^
// (r % 8)), which is also the K-major layout wgmma_desc reads.
__device__ __forceinline__ uint32_t f32_sw128(int r, int c, int rows) {
  return static_cast<uint32_t>((c >> 5) * rows * 128 + r * 128 +
                               ((((c >> 2) & 7) ^ (r & 7)) << 4) +
                               ((c & 3) << 2));
}

// d (64 x N, f32) += A (64 x 8) @ B (8 x N), tf32, for N = 16, 32, 64 or
// 128: A from registers (the tf32 fragment layout above), B from shared
// memory K-major (tf32 products read no operand transposed); scale_d = 0
// overwrites d.  K-major B in 128-byte-swizzled rows of 32 floats takes
// wgmma_desc as bf16 does: a k-step of 8 is 32 bytes added inside the
// swizzle atom.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d = 1) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "no tf32 RS product of this width");
  if constexpr (N == 16) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 32) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 64) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else
  if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

// The same, issued only where `on` is nonzero (the same value in every
// thread of the warpgroup): a guard predicate, not a branch, for N = 16
// or 32.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs_if(float (&d)[N / 2],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, unsigned on) {
  static_assert(N == 16 || N == 32, "no predicated tf32 product this wide");
  if constexpr (N == 16) {
    asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %14, 0;\nsetp.ne.b32 q, %13, 0;\n"
      "@q wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(on),
        "r"(1));
  } else {
    asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.b32 p, %22, 0;\nsetp.ne.b32 q, %21, 0;\n"
      "@q wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(on),
        "r"(1));
  }
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The 4 f32 at `addr` (16-byte aligned) where `on` is nonzero, else 0: a
// predicated load, not a branch (a fragment register written on a
// divergent path makes ptxas serialise the products that read it, C7520).
__device__ __forceinline__ void ld_shared_v4_if(uint32_t addr, unsigned on,
                                                float (&v)[4]) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
      "@p ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
      : "r"(addr), "r"(on));
}

// The shared addresses of this thread's tf32 A fragments over a kRows-row
// f32 tile at `tile` (f32_sw128) contracting over its columns: A[m][k] =
// tile[m][8 kk + k], rows 0-63 as M.  Computed once a tile: at[h][a] is
// row r + 8 h of the warp's 16, 16-byte chunk a (before the swizzle) of
// the first 32-column box; k-step kk reads chunk 2 (kk % 4) + i / 2 of box
// kk / 4, so its four loads take no address arithmetic.
template <int kRows>
struct Tf32RowFrag {
  uint32_t at[2][8];
  __device__ __forceinline__ explicit Tf32RowFrag(uint32_t tile) {
    const int lane = threadIdx.x % 32;
    const int r = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int a = 0; a < 8; ++a)
        at[h][a] = tile + (r + 8 * h) * 128 + ((a ^ (lane / 4)) << 4) +
                   (lane % 4) * 4;
  }
  __device__ __forceinline__ void load(int kk, float (&x)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = ld_shared_f32(at[i & 1][2 * (kk % 4) + (i >> 1)] +
                           (kk / 4) * kRows * 128);
  }
};

// A k-step of 8 rows of a tile contracted over its rows, in the order the
// column-wise fragment loads read them: position i holds row 2 (i % 4) +
// i / 4 (kstep_row), so that a warp's loads of 4 rows x 8 columns of a
// swizzled tile fall on 32 distinct banks; kstep_pos is its inverse.  A B
// operand written for such an A puts row r of its k-step at position
// kstep_pos(r).
__device__ __forceinline__ int kstep_row(int i) {
  return 2 * (i & 3) + (i >> 2);
}

__device__ __forceinline__ int kstep_pos(int row) {
  return (row >> 1) + 4 * (row & 1);
}

// The shared addresses of this thread's tf32 A fragments over a kRows-row
// f32 tile at `tile` (f32_sw128) contracting over its rows: A[m][k] =
// tile[8 kk + kstep_row(k)][m0 + m], the 64 columns at m0 as M, columns
// m0 + m >= `limit` read as 0.  k-step kk adds kk * 1024 bytes to k-step
// 0's address, the rows' swizzle being the same.  Tf32RowFrag is its
// counterpart over the columns.
template <int kRows>
struct Tf32ColFrag {
  uint32_t at[4];
  bool on;
  __device__ __forceinline__ Tf32ColFrag(uint32_t tile, int m0, int limit) {
    const int lane = threadIdx.x % 32;
    const int m = m0 + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
    on = m < limit;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      at[i] = tile + f32_sw128(kstep_row(lane % 4 + 4 * (i >> 1)),
                               m + 8 * (i & 1), kRows);
  }
  // The same fragments over the tile `off` bytes further on.
  __device__ __forceinline__ Tf32ColFrag moved(uint32_t off) const {
    Tf32ColFrag f = *this;
#pragma unroll
    for (int i = 0; i < 4; ++i) f.at[i] += off;
    return f;
  }
  // A predicated load, not a branch: fragment registers written on a
  // divergent path make ptxas serialise the products (C7520).
  __device__ __forceinline__ void load(int kk, float (&x)[4]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\nmov.b32 %0, 0;\n"
          "@p ld.shared.f32 %0, [%1];\n}\n"
          : "=f"(x[i])
          : "r"(at[i] + kk * 1024), "r"(static_cast<int>(on)));
  }
};

// d (64 x N) += A B over kSteps k-steps in 3xTF32 (d = A B where
// scale_first is 0: the first product overwrites d): A's raw fragment of
// k-step kk from frag.load(kk, x) (Tf32RowFrag or the like), split in
// registers; B's hi and lo tiles (K-major, rowsB rows of 32-column boxes)
// at b_hi, b_lo.
// Pipelined so that no wait falls on a load: while k-step kk's three
// products run, k-step kk + 1's fragment (loaded an iteration earlier) is
// split into the buffer that kk - 1's products have released, and kk + 2's
// is loaded.
template <int N, int kSteps, typename Frag>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N / 2],
                                           const Frag& frag, uint32_t b_hi,
                                           uint32_t b_lo, int rowsB,
                                           int scale_first = 1) {
  float raw[4];
  uint32_t hi[2][4], lo[2][4];
  auto split = [&](int b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(raw[i], hi[b][i], lo[b][i]);
  };
  frag.load(0, raw);
  split(0);
  if (kSteps > 1) frag.load(1, raw);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    const int b = kk & 1;
    const uint32_t off = (kk / 4) * rowsB * 128 + (kk % 4) * 32;
    wgmma_fence();
    wgmma_tf32_rs<N>(d, hi[b], wgmma_desc(b_hi + off, 16),
                     kk == 0 ? scale_first : 1);
    wgmma_tf32_rs<N>(d, hi[b], wgmma_desc(b_lo + off, 16));
    wgmma_tf32_rs<N>(d, lo[b], wgmma_desc(b_hi + off, 16));
    wgmma_commit();
    if (kk + 1 < kSteps) {
      wgmma_wait<1>();   // k-step kk - 1 is done with the other buffer
      split(b ^ 1);
      if (kk + 2 < kSteps) frag.load(kk + 2, raw);
    }
  }
  wgmma_wait<0>();
  fence_regs(d);
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime (no
// link against libcuda); null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dims of `type` (innermost first; strides in bytes
// of dims 1..), boxes of 128 bytes innermost (64 bf16, 32 f32) as
// wgmma_desc reads them, 128-byte swizzle (or `swizzle`, for boxes of its
// width or none), zeros outside the tensor.  TMA takes a 16-byte-aligned
// base and strides: anything else is refused here.
inline cudaError_t tensor_map_nd(
    CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  for (int i = 0; i < rank - 1; ++i)
    if (strides[i] % 16) return cudaErrorInvalidValue;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The same in f32: boxes of 32 columns (128-byte swizzle) unless another
// swizzle is named.
inline cudaError_t f32_map_nd(
    CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
    const cuuint64_t* strides, const cuuint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, rank,
                       dims, strides, box, swizzle);
}

// The same in bf16.
inline cudaError_t bf16_map_nd(CUtensorMap* map, const void* base, int rank,
                               const cuuint64_t* dims,
                               const cuuint64_t* strides,
                               const cuuint32_t* box) {
  return tensor_map_nd(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank,
                       dims, strides, box);
}

}  // namespace hopper

// Hopper (sm_90a) building blocks for the port's warp-specialised kernels:
// mbarriers, TMA tile loads and 1-D bulk copies, thread block cluster
// barriers and distributed shared memory, wgmma shared-memory descriptors
// and the bf16 wgmma products with f32 accumulators.
//
// Shared-memory tiles. A tile of R rows x D bf16 columns (D = 64 or 128)
// is stored as D / 64 column halves, each R rows of 128 bytes, in the
// 128-byte swizzle that a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes (16-byte chunk c of row r lands at chunk c ^ (r % 8)). Half c
// starts at c * R * 128 bytes; every tile starts 1024-byte aligned, so
// the swizzle phase is that of the address and the descriptors' base
// offset is 0. One such tile is read by wgmma in two ways:
//
//   * K-major (the reduction runs along D, e.g. Q and K in S = Q K^T):
//     8-row groups 1024 bytes apart (SBO); the k-step of 16 columns at
//     column 16 kk is half kk / 4 plus 32 bytes per step inside the
//     128-byte row, which the hardware swizzles like the TMA did.
//   * MN-major (the reduction runs along the rows, e.g. V in O = P V,
//     B = V [kv][D] with D contiguous; wgmma's transpose bit): the
//     k-step of 16 rows starts 16 * 128 bytes further; 8-row groups along
//     the reduction are 1024 bytes apart (SBO) and the two 64-column
//     halves of N = 128 are R * 128 bytes apart (LBO).
//
// wgmma accumulators (m64nN, f32): thread t of warp w in the warpgroup
// holds rows 16 w + t / 4 and that + 8; d[4 j + e] is column 8 j +
// 2 (t % 4) + (e & 1) of the first row (e < 2) or the second (e >= 2),
// the mma.sync m16n8 C layout repeated over N / 8 column blocks. A
// register A operand (m64k16) is the mma.sync m16n8k16 A fragment of the
// warp's 16 rows, so a row block of an accumulator packed to bf16 pairs
// is directly the A operand of the next product.
#pragma once

#include <cuda.h>
#include <stdint.h>

namespace rtt {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA

// Box (c0, c1, c2) of a 3-D tensor map into shared memory at `dst`,
// completing `bytes` of the transaction count on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory at `src` into
// shared memory at `dst`, both 16-byte aligned, completing `bytes` of the
// transaction count on `bar`: a 1-D bulk copy, no tensor map.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------ clusters

// Every thread of every CTA of the cluster: the arrive releases this
// thread's earlier shared-memory writes to the cluster, the wait acquires
// the other CTAs'. The `.aligned` forms want the warp converged: the
// __syncwarp makes it so after a branch taken by some lanes only.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared-memory address `addr` of this CTA, as the address of the
// same variable in the CTA of cluster rank `rank` (distributed shared
// memory).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// ------------------------------------------------------ wgmma plumbing

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Operand of k-step kk of a K-major R-row tile at `tile`, from row r0.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return desc(tile + (kk >> 2) * R * 128 + r0 * 128 + (kk & 3) * 32, 16,
              1024);
}

// Operand of k-step kk (rows 16 kk ..) of an MN-major R-row tile.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc(tile + kk * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// All but the most recently committed group have completed.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Pin registers that an in-flight wgmma reads or writes: no access to
// them moves across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// --------------------------------------------------------- the products
//
// d (m64 x N, f32) += A (m64 x k16) * B (k16 x N), bf16 inputs; the sum
// starts from 0 where scale_d == 0. wgmma_ss: A and B from shared memory,
// both K-major. wgmma_rs: A from registers, B MN-major (transpose bit).

#define RTT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RTT_D16(d, i) \
  RTT_F4(d, i), RTT_F4(d, i + 4), RTT_F4(d, i + 8), RTT_F4(d, i + 12)
#define RTT_D32(d) RTT_D16(d, 0), RTT_D16(d, 16)
#define RTT_D64(d) RTT_D16(d, 0), RTT_D16(d, 16), RTT_D16(d, 32), RTT_D16(d, 48)

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : RTT_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RTT_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : RTT_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RTT_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef RTT_D64
#undef RTT_D32
#undef RTT_D16
#undef RTT_F4

}  // namespace sm90
}  // namespace rtt

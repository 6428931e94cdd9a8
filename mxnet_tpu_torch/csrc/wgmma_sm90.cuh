// Hopper-only building blocks (sm_90a): mbarriers, TMA tile loads and
// warpgroup MMA (wgmma) on 8-bit operands from shared memory, as inline
// PTX. Used by int8_gemm.cu's int8_gemm_wgmma_kernel.
//
// Shared-memory operands are K-major tiles of 128-byte rows written by TMA
// with CU_TENSOR_MAP_SWIZZLE_128B: row r of a tile at byte 128 r, its 16-byte
// chunk c at chunk c ^ (r % 8). A wgmma descriptor names such a tile by its
// start address (1024-byte aligned), the 1024 bytes between groups of eight
// rows (SBO) and the 128-byte swizzle mode; the k-th 32-byte step along K is
// the same descriptor with its address advanced by 32 k bytes (the hardware
// applies the XOR to the address it forms).
#pragma once

#include <stdint.h>

#include "mma_sm90.cuh"  // smem_u32

// -- mbarriers ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` of transactions (a TMA load's).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Wait until the phase of parity `parity` has completed. A wait that lasts
// 2^35 clocks (over 15 s) cannot end: it traps, which fails the launch with
// an error, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// -- TMA ------------------------------------------------------------------------
// The box of a 3-d tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at `dst`; completion is counted in bytes on `bar`. Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------------
// Descriptor of a K-major, 128-byte-swizzled tile at shared address `saddr`.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}
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
// Keep the compiler from moving accesses of the accumulators across the
// asynchronous MMA.
template <int R>
__device__ __forceinline__ void wgmma_fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define MX_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define MX_R16(i) MX_R4(i), MX_R4(i + 4), MX_R4(i + 8), MX_R4(i + 12)

// d (64 x N s32, the accumulator fragments of one warpgroup) = A B + (scale_d
// ? d : 0) over one 64 x N x 32 step: A (64 x 32 bytes) and B (N x 32 bytes)
// K-major s8 tiles in shared memory. Fragment layout (t = thread of the
// warpgroup, w = t / 32, g = t % 32 / 4, q = t % 4): d[4 j + 2 h + e] is
// row 16 w + g + 8 h, column 8 j + 2 q + e.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : MX_R16(0), MX_R16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : MX_R16(0), MX_R16(16), MX_R16(32), MX_R16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef MX_R16
#undef MX_R4

// Named barrier over `threads` threads (a multiple of 32), id 1..15.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

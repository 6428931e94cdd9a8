// Warp-level tensor-core helpers for the port's bf16 and f32 kernels:
// 16-byte cp.async copies into shared memory, ldmatrix fragment loads, the
// m16n8k16 bf16 mma and the m16n8k8 TF32 mma with f32 accumulation, the
// m16n8k32 s8 mma with s32 accumulation, and the
// split of an f32 value into two TF32 values for 3xTF32 products (inline
// PTX, sm_80 and later; built here for sm_90a).
//
// Fragment layouts of mma.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//     a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9];
//   B (16 x 8, k x n), 2 registers: b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g];
//   C (16 x 8, f32), 4 registers: c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// So the C fragments of two neighbouring 8-column tiles, packed to bf16, are
// the A fragment of the 16-wide k-slice they cover (frag_from_acc).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; src_bytes < 16 fills the
// rest with zeros (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// 4 bytes, the same way (through L1: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8m..8m+7 give the row addresses of
// matrix m, which lands in r[m].
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b over one 16 x 8 x 16 step.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b over one 16 x 8 x 32 step, s8 operands, s32 accumulation. The
// fragments hold four int8 a register where the bf16 ones hold two, at the
// same byte positions: A (16 x 32 bytes) and B (32 x 8, stored [n][k]) load
// with ldsm_x4, a_off and bn_off as 16 x 16 bf16 tiles, and C (s32) has the
// f32 layout above.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest-even bf16; lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-slice [16j, 16j + 16) from the f32 C fragments of
// 8-column tiles 2j and 2j + 1, rounded to bf16.
__device__ __forceinline__ void frag_from_acc(uint32_t (&a)[4], const float (&lo)[4],
                                              const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Lane offsets (in elements) into a row-major bf16 tile of row stride ld,
// relative to the top-left corner of the 16 x 16 block they load:
//   a_off: the A fragment (rows r..r+15, columns c..c+15), with ldsm_x4;
//   bn_off: the B fragments of two 8-wide n tiles from a tile stored [n][k]
//           (rows n..n+15, columns k..k+15), with ldsm_x4: r[0], r[1] for
//           tile n, r[2], r[3] for tile n + 8;
//   bk_off: the same from a tile stored [k][n] (rows k..k+15, columns
//           n..n+15), with ldsm_x4_t.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + ((lane >> 4) << 3);
}
__device__ __forceinline__ int bn_off(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
}
__device__ __forceinline__ int bk_off(int lane, int ld) { return a_off(lane, ld); }

// ---------------------------------------------------------------------------
// TF32 and 3xTF32.
//
// Fragment layouts of mma.m16n8k8.row.col.f32.tf32.tf32.f32 (g = lane / 4,
// t = lane % 4), one value a register:
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
//   B (8 x 8, k x n): b0 = B[t][g], b1 = B[t+4][g];
//   C (16 x 8, f32): c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// A thread's C fragment holds columns 2t and 2t+1, its A fragment needs
// columns t and t+4. A product sums over k, so any permutation of k that A
// and B share leaves it unchanged: taking k-slot t as column 2t and k-slot
// t+4 as column 2t+1, the C fragment (c0, c2, c1, c3) is the A fragment of
// the 8-wide k-slice it covers, if B's rows are read in the same order
// (b0 from k-row 2t, b1 from 2t+1). No shuffle, no shared memory.
//
// 3xTF32: x = hi + lo with hi = x rounded to TF32 (to nearest, ties away
// from zero: cvt.rna.tf32.f32) and lo = x - hi, exact in f32 and at most
// half a TF32 ulp of x; the tensor core reads lo's leading 11 bits. Then
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first, misses the
// a_lo b_lo term (2^-22 of a b at most) and the bits of lo past its 11th
// (2^-21): f32-accurate to a few ulps per sum, where one TF32 pass (a_hi
// b_hi alone) keeps 11 bits (2^-12).

// x = hi + lo (bit patterns of f32 registers). hi is cvt.rna.tf32.f32 of x
// for every finite x, in two integer operations: on sm_90a the cvt is a
// sequence of instructions (NaN and infinity tests and selects in the
// SASS), which made it the 3xTF32 kernels' bottleneck
// (tools/torch_flash_ab.py --variant cvt_split times them with it;
// PERF.md has the H100 numbers).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  // add half an ulp, truncate
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b over one 16 x 8 x 8 step, TF32 operands.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 A fragment (a0..a3 in mma order) split into TF32 hi and lo parts.
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4], float a0, float a1,
                                        float a2, float a3) {
  split_tf32(a0, hi[0], lo[0]);
  split_tf32(a1, hi[1], lo[1]);
  split_tf32(a2, hi[2], lo[2]);
  split_tf32(a3, hi[3], lo[3]);
}

// c[j] += a b[j] in 3xTF32 over JC n-tiles that share the A fragment: the
// three passes (lo hi, hi lo, hi hi) each run over all JC tiles, so that
// consecutive mma's write different accumulators instead of waiting on one.
template <int JC>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[JC][2],
                                           const uint32_t (&b_lo)[JC][2]) {
#pragma unroll
  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);
#pragma unroll
  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);
#pragma unroll
  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_hi[j][0], b_hi[j][1]);
}

// Warp-level tensor-core helpers for the port's bf16 kernels: 16-byte
// cp.async copies into shared memory, ldmatrix fragment loads and the
// m16n8k16 bf16 mma with f32 accumulation (inline PTX, sm_80 and later;
// built here for sm_90a).
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

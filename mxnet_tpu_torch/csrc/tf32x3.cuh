// 3xTF32 tile helpers of the f32 attention kernels on the tensor cores: the
// f32 flash kernels (flash_attention.cu, namespace tf32x3) and the paged
// prefill read (paged_attention.cu). One block of NW warps owns BR rows of
// the resident operand, 16 a warp; tiles sit in shared memory as
// [row][channel] with a row stride of the width plus 16 bytes.
//
// Bank conflicts. At a row stride of LD = D + 4 floats (LD = 4 mod 32
// banks for every D here), each fragment load of a warp hits 32 distinct
// banks: the A loads (rows g and g + 8, columns t and t + 4: bank 4g + t),
// the score products' B loads (row g, column t: 4g + t) and the
// accumulating products' k-permuted B loads (rows 2t and 2t + 1, column g:
// 8t + g and 8t + 4 + g). A bf16 tile at D + 8 elements (the paged read's
// bf16 pools) puts those loads on distinct 32-bit words, two lanes a word.
//
// Products (mma_sm90.cuh): each f32 operand is split in registers into TF32
// hi + lo and each product is a_lo b_hi + a_hi b_lo + a_hi b_hi with f32
// accumulators. A bf16 or f16 value widened to f32 splits exactly (lo = 0).
// The C fragments of a weight tile are the A fragments of the accumulating
// product under the k-permutation of mma_sm90.cuh, so weights never touch
// shared memory.
#pragma once

#include "common.cuh"
#include "mma_sm90.cuh"

namespace tf32x3 {

constexpr int NW = 4;          // warps a block
constexpr int NTH = 32 * NW;   // threads a block
constexpr int BR = 16 * NW;    // rows of the resident tile, 16 a warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// n-tiles that share one split A fragment in a 3xTF32 pass (mma_3xtf32)
template <int TILES>
__host__ __device__ constexpr int chunk() { return TILES < 8 ? TILES : 8; }

// Rows [r0, r0 + ROWS) of an (n, D) row-major f32 slice into a [ROWS][LD]
// tile by 16-byte cp.async; rows at or past n are zeros.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* sm, const float* __restrict__ src, int r0,
                                          int n) {
  constexpr int CH = D / 4;
  static_assert(ROWS * CH % NTH == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    const int r = i / CH, c = (i % CH) * 4, row = r0 + r;
    const bool ok = row < n;
    cp_async16(sm + r * LD + c, src + static_cast<size_t>(ok ? row : 0) * D + c, ok ? 16 : 0);
  }
}

// acc (16 x N) += a warp's 16 rows `res` of an f32 tile of row stride LDA
// times the transpose of an (N, D) tile of row stride LDB stored
// [row][channel] (f32, or bf16 widened on load): the score products.
template <int D, int N, int LDA, int LDB, typename TB>
__device__ __forceinline__ void scores(float (&acc)[N / 8][4], const float* res, const TB* tile,
                                       int lane) {
  constexpr int JC = chunk<N / 8>();
  const int g = lane >> 2, t = lane & 3;
  const float* a = res + g * LDA + t;
  const TB* b = tile + g * LDB + t;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    split_a(a_hi, a_lo, a[8 * kk], a[8 * LDA + 8 * kk], a[8 * kk + 4], a[8 * LDA + 8 * kk + 4]);
#pragma unroll
    for (int j0 = 0; j0 < N / 8; j0 += JC) {
      uint32_t b_hi[JC][2], b_lo[JC][2];
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const TB* bj = b + 8 * (j0 + j) * LDB + 8 * kk;
        split_tf32(to_f32(bj[0]), b_hi[j][0], b_lo[j][0]);
        split_tf32(to_f32(bj[4]), b_hi[j][1], b_lo[j][1]);
      }
      mma_3xtf32<JC>(acc + j0, a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// acc (16 x D) += w (16 x N, f32 C fragments) times an (N, D) tile of row
// stride LDB stored [row][channel]: the accumulating products, over the
// k-permutation of mma_sm90.cuh (k-slot t is row 2t, k-slot t + 4 row
// 2t + 1).
template <int D, int N, int LDB, typename TB>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&w)[N / 8][4],
                                           const TB* tile, int lane) {
  constexpr int JC = chunk<D / 8>();
  const int g = lane >> 2, t = lane & 3;
  const TB* b_row0 = tile + 2 * t * LDB + g;  // b0: k-slot t, row 2t
  const TB* b_row1 = b_row0 + LDB;            // b1: k-slot t + 4, row 2t + 1
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    split_a(a_hi, a_lo, w[kk][0], w[kk][2], w[kk][1], w[kk][3]);
#pragma unroll
    for (int j0 = 0; j0 < D / 8; j0 += JC) {
      uint32_t b_hi[JC][2], b_lo[JC][2];
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        const int at = 8 * kk * LDB + 8 * (j0 + j);
        split_tf32(to_f32(b_row0[at]), b_hi[j][0], b_lo[j][0]);
        split_tf32(to_f32(b_row1[at]), b_hi[j][1], b_lo[j][1]);
      }
      mma_3xtf32<JC>(acc + j0, a_hi, a_lo, b_hi, b_lo);
    }
  }
}

// One key tile of the online softmax on a warp's C fragments (the rows of
// this lane: g, h = 0, and g + 8, h = 1). s holds the scores in units of
// log2 (masked: -inf); m is each row's running max in those units, l this
// lane's share of each row's sum. s becomes the numerators p = 2^(s - m),
// l is rescaled by corr = 2^(m_old - m_new) before p is added, and corr is
// returned for the O accumulator (add_tile). A row with no live key yet
// keeps m = -inf and p = 0.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 8][4], float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
  }
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // a row's four owner lanes are lane ^ 1 and lane ^ 2
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    base[h] = m_new == -INFINITY ? 0.f : m_new;  // guard exp against nan
    corr[h] = exp2f(m[h] - base[h]);             // 0 while m was -inf
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - base[e >> 1]);  // 0 for masked keys
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
}

// acc = acc * corr + pv, row by row: the O accumulator rescaled to the new
// running max and this key tile's P V (summed apart, from zero) added by an
// f32 fma. The tensor cores' f32 sums lose accuracy with the number of
// k-steps summed into one accumulator: measured on the H100, the f32
// forward's error against an f64 plain version was 2.4x the f32 plain
// version's with P V summed into O across all key tiles, and 1.1x with
// each tile's P V summed apart and added here.
template <int D>
__device__ __forceinline__ void add_tile(float (&acc)[D / 8][4], const float (&corr)[2],
                                         const float (&pv)[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);
  }
}

// The end of the online softmax: each row's sum l over its four owner
// lanes, and inv = 1 / l (0 for a row that saw no key: its output is 0).
__device__ __forceinline__ void finish_rows(float (&l)[2], float (&inv)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
}

// Two neighbouring values of a row, converted to T, stored together.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// A warp's 16 x D f32 accumulator, row g times mul[0] and row g + 8 times
// mul[1], into rows [row0, row0 + 16) of an (n, D) slice of T; rows at or
// past n are not written.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int row0, int n,
                                           int lane, const float (&mul)[2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + static_cast<size_t>(row) * D + 8 * j + 2 * t, acc[j][2 * h] * mul[h],
             acc[j][2 * h + 1] * mul[h]);
  }
}
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int row0, int n,
                                           int lane, float mul) {
  const float both[2] = {mul, mul};
  store_rows<D>(dst, acc, row0, n, lane, both);
}

}  // namespace tf32x3

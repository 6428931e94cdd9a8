// Flash attention, forward and FlashAttention-2 backward, for Hopper (sm_90a).
//
// Replaces: _fwd_kernel, _bwd_dkv_kernel and _bwd_dq_kernel in
// mxnet_tpu/ops/flash_attention.py (the Pallas TPU kernels behind the
// custom VJP of flash_attention; _bwd_recompute is shared there and here).
//
// Computes, for each of the B*H (Tq, D) x (Tk, D) slices, with the scale
// 1/sqrt(D) and the causal mask aligned bottom-right (query r sees keys
// c <= r + Tk - Tq):
//   forward:  o = softmax(q k^T * scale) v, lse = logsumexp of the scores
//             (f32, one value per query row, only when asked for);
//   dK/dV:    p = exp(q k^T * scale - lse), ds = p * (do v^T - di),
//             dv = p^T do, dk = ds^T (q * scale);
//   dQ:       dq = ds k * scale;
// where di = rowsum(do * o) comes from the wrapper. A query row that sees
// no key outputs 0 and stores lse = 0, so the backward gives it p = 0.
// Scores, softmax and every sum are f32; outputs are cast to q's dtype.
//
// Three designs share the file, all on the tensor cores:
//   the bf16 backward and forward (namespace bf16tc, mma.sync m16n8k16);
//   the f32 forward and backward in 3xTF32 (namespace tf32x3, mma.sync
//   m16n8k8 TF32, with the tile helpers of tf32x3.cuh).
// Every block owns one output tile and walks the other operand's tiles in
// a loop of its own (the TPU kernels walk a sequential grid axis and carry
// the accumulators in VMEM scratch; blocks on the card run in no order):
//   forward and dQ: one block per (b*h, tile of 64 queries), looping over
//   the key tiles its rows can see;
//   dK/dV: one block per (b*h, tile of 64 keys), looping over the query
//   tiles that can see it.
// No block writes another's output, so there are no atomics and results
// are the same from run to run. Tiles that the causal mask hides entirely
// are skipped, as _causal_gated does on the TPU. Ragged lengths are masked
// in the kernels: rows past Tq load zeros and are not stored, keys past Tk
// are masked out of the softmax. Every kernel reads its operands by 16-byte
// cp.async, so every pointer must be 16-byte aligned (the launchers return
// cudaErrorMisalignedAddress otherwise).
#include <type_traits>

#include "common.cuh"
#include "mma_sm90.cuh"
#include "tf32x3.cuh"

// End (exclusive) of the keys that query rows [q0, q0 + 64) can see.
__device__ __forceinline__ int key_end(int q0, int Tq, int Tk, int causal) {
  if (!causal) return Tk;
  const int last = min(q0 + tf32x3::BR, Tq) - 1 + (Tk - Tq);  // frontier of the last row
  return max(0, min(Tk, last + 1));
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores.
//
// Replaces, for bf16 q/k/v/do: _bwd_dkv_kernel and _bwd_dq_kernel in
// mxnet_tpu/ops/flash_attention.py (:256 and :285). The f32 instantiations
// are the 3xTF32 kernels of namespace tf32x3 below.
//
// Bound on the H100: operations. At B=4 H=16 T=1024 D=64 causal, dK/dV does
// 4 block products of 2*D flops per live (query, key) pair, 17.2 GFLOP, and
// dQ 3, 12.9 GFLOP; against 989 TFLOP/s of dense bf16 (H100 SXM data sheet,
// 700 W) that is 17.4 and 13.0 us, while their bytes (q, k, v, do, lse, di
// in, the gradients out; about 50 MB) take about 15 us at 3.35 TB/s.
//
// Design. One block of 4 warps owns 64 rows of the output: dK/dV one tile of
// 64 keys, dQ one tile of 64 queries; warp w owns rows 16w..16w+15. Every
// product is mma.sync m16n8k16 (bf16 operands, f32 accumulators) with
// operands loaded by ldmatrix from bf16 tiles whose rows are padded to D + 8
// elements (8 rows of 16 bytes fall in 32 distinct banks). Per looped tile:
//   dK/dV: s^T = K Q^T and dp^T = V dO^T (f32), p^T = exp(s^T scale - lse)
//          under the mask, ds^T = p^T (dp^T - di); dV += p^T dO, dK += ds^T Q;
//   dQ:    s = Q K^T, dp = dO V^T, p and ds as above; dQ += ds K.
// The f32 C fragments of p and ds are packed to bf16 and reused as the A
// fragments of the accumulating products (mma_sm90.cuh), so p and ds never
// touch shared memory. The resident operand (K and V; Q and dO) is loaded
// once: at D = 64 its A fragments stay in registers for the whole loop; at
// D = 128 they are read from its shared-memory tile at each use and the looped
// tile is 32 rows, because 64 x 128 f32 accumulators for each of dK and dV
// already take 128 registers a thread (ptxas -v on sm_90a: dK/dV 242
// registers at both head dims, dQ 169 and 163, no spills). The looped operand
// (Q, dO, lse, di; K, V) is double-buffered with cp.async: tile i + 1 is in
// flight while tile i is multiplied. Tiles that the causal mask hides
// entirely are skipped, and the element mask is applied only on tiles that
// cross the causal frontier or the ragged end. No atomics: results are the
// same from run to run.
//
// Rounding. Exactly two things are rounded to bf16: p and ds before the
// accumulating products, and the outputs. Scores, exp, lse, di and every
// accumulator are f32, and the scale is applied in f32 (to s, and to dK and
// dQ at the end; 1/sqrt(128) is not a power of two, so folding it into a
// bf16 q would round again). The TPU kernel computes these products as f32
// dot_generals, which its matrix unit at JAX's default precision multiplies
// as bf16 operands: the same rounding of p and ds, made there by the chip.
namespace bf16tc {

using bf16 = __nv_bfloat16;
// 4 warps a block, 64 rows of the resident tile (16 a warp), as tf32x3
using tf32x3::BR;
using tf32x3::FULL;
using tf32x3::LOG2E;
using tf32x3::NTH;

template <int D>
struct Tile {
  static constexpr int LD = D + 8;              // shared-memory row stride (elements)
  static constexpr int BN = D == 64 ? 64 : 32;  // rows of the looped tile
  static constexpr bool REGS = D == 64;         // resident A fragments in registers
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // two resident tiles, two double-buffered looped tiles, two f32 vectors
  return (2 * BR + 4 * Tile<D>::BN) * Tile<D>::LD * sizeof(bf16) +
         4 * Tile<D>::BN * sizeof(float);
}

// Rows [r0, r0 + ROWS) of a (n, D) row-major slice into a [ROWS][D + 8]
// tile by 16-byte cp.async; rows at or past n are zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* __restrict__ src, int r0, int n) {
  constexpr int CH = D / 8;
  static_assert(ROWS * CH % NTH == 0, "whole copies per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    const int r = i / CH, c = (i % CH) * 8, row = r0 + r;
    const bool ok = row < n;
    cp_async16(sm + r * Tile<D>::LD + c, src + static_cast<size_t>(ok ? row : 0) * D + c,
               ok ? 16 : 0);
  }
}

// Entries [r0, r0 + ROWS) of an (n,) f32 vector, zeros past n, copied by
// threads [t0, t0 + ROWS).
template <int ROWS>
__device__ __forceinline__ void load_vec(float* sm, const float* __restrict__ src, int r0,
                                         int n, int t0) {
  const int i = static_cast<int>(threadIdx.x) - t0;
  if (i >= 0 && i < ROWS) {
    const int row = r0 + i;
    const bool ok = row < n;
    cp_async4(sm + i, src + (ok ? row : 0), ok ? 4 : 0);
  }
}

// A warp's 16 rows of a resident [BR][D + 8] tile as mma A operands.
template <int D>
struct Resident {
  uint32_t f[Tile<D>::REGS ? D / 16 : 1][4];
  const bf16* at;

  __device__ __forceinline__ void init(const bf16* tile, int warp, int lane) {
    at = tile + warp * 16 * Tile<D>::LD + a_off(lane, Tile<D>::LD);
    if constexpr (Tile<D>::REGS) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(f[kk], at + 16 * kk);
    }
  }
  // the A fragment of channels [16 kk, 16 kk + 16)
  __device__ __forceinline__ void get(uint32_t (&a)[4], int kk) const {
    if constexpr (Tile<D>::REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
    } else {
      ldsm_x4(a, at + 16 * kk);
    }
  }
};

// acc (16 x N) += the warp's resident rows times the transpose of an
// (N, D) tile stored [row][channel]: the score products.
template <int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 8][4], const Resident<D>& res,
                                       const bf16* tile, int lane) {
  constexpr int LD = Tile<D>::LD;
  const bf16* b = tile + bn_off(lane, LD);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    res.get(a, kk);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      uint32_t r[4];
      ldsm_x4(r, b + 16 * j * LD + 16 * kk);
      mma_bf16(acc[2 * j], a, r[0], r[1]);
      mma_bf16(acc[2 * j + 1], a, r[2], r[3]);
    }
  }
}

// acc (16 x D) += w (16 x N, f32 C fragments, rounded to bf16 here) times
// an (N, D) tile stored [row][channel]: the accumulating products.
template <int D, int N>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&w)[N / 8][4],
                                           const bf16* tile, int lane) {
  constexpr int LD = Tile<D>::LD;
  const bf16* b = tile + bk_off(lane, LD);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    uint32_t a[4];
    frag_from_acc(a, w[2 * kk], w[2 * kk + 1]);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      uint32_t r[4];
      ldsm_x4_t(r, b + 16 * kk * LD + 16 * j);
      mma_bf16(acc[2 * j], a, r[0], r[1]);
      mma_bf16(acc[2 * j + 1], a, r[2], r[3]);
    }
  }
}

// A warp's 16 x D f32 accumulator, row g times mul[0] and row g + 8 times
// mul[1] (g = lane / 4), rounded to bf16, into rows [row0, row0 + 16) of a
// (n, D) slice; rows at or past n are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, int lane, const float (&mul)[2]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row) * D + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * h] * mul[h], acc[j][2 * h + 1] * mul[h]);
  }
}
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, int lane, float mul) {
  const float both[2] = {mul, mul};
  store_rows<D>(dst, acc, row0, n, lane, both);
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int causal,
                        float scale) {
  constexpr int LD = Tile<D>::LD, BQ = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BR * LD;
  bf16* qs = vs + BR * LD;        // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;   // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                // [2][BQ]
  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float* lse_b = lse + static_cast<size_t>(bh) * Tq;
  const float* di_b = di + static_cast<size_t>(bh) * Tq;
  const float sl2 = scale * LOG2E;

  // the first query tile with a row that sees key k0; the tiles before it
  // are masked out entirely
  const int q_begin = causal ? (max(0, k0 - off) / BQ) * BQ : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + BQ - 1) / BQ : 0;
  auto load_q_tile = [&](int q0, int st) {
    load_rows<BQ, D>(qs + st * BQ * LD, q + qoff, q0, Tq);
    load_rows<BQ, D>(dos + st * BQ * LD, dout + qoff, q0, Tq);
    load_vec<BQ>(lse_s + st * BQ, lse_b, q0, Tq, 0);
    load_vec<BQ>(di_s + st * BQ, di_b, q0, Tq, BQ);
  };
  load_rows<BR, D>(ks, k + koff, k0, Tk);
  load_rows<BR, D>(vs, v + koff, k0, Tk);
  cp_async_commit();
  if (n_tiles > 0) load_q_tile(q_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  Resident<D> kr, vr;
  kr.init(ks, warp, lane);
  vr.init(vs, warp, lane);

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ, st = it & 1;
    cp_async_wait<0>();  // tile it has landed ...
    __syncthreads();     // ... for every thread, and tile it - 1 is no longer read
    if (it + 1 < n_tiles) load_q_tile(q0 + BQ, st ^ 1);
    cp_async_commit();
    const bf16* qt = qs + st * BQ * LD;
    const bf16* dot = dos + st * BQ * LD;
    const float* ls = lse_s + st * BQ;
    const float* dis = di_s + st * BQ;
    // transposed: rows are this warp's keys, columns the tile's queries
    float s[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
    scores<D, BQ>(s, kr, qt, lane);
    scores<D, BQ>(dp, vr, dot, lane);
    // key rows past Tk are never stored, so only the queries' end and the
    // causal frontier need the element mask
    const bool edge = q0 + BQ > Tq || (causal && k0 + BR - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float p = exp2f(s[j][e] * sl2 - ls[c] * LOG2E);
        if (edge) {
          const int row = q0 + c, key = k0 + warp * 16 + g + 8 * (e >> 1);
          if (row >= Tq || (causal && key > row + off)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dis[c]);
      }
    }
    accumulate<D, BQ>(dv_acc, s, dot, lane);  // dv += p^T do
    accumulate<D, BQ>(dk_acc, dp, qt, lane);  // dk += ds^T q
  }
  cp_async_wait<0>();
  store_rows<D>(dk + koff, dk_acc, k0 + warp * 16, Tk, lane, scale);
  store_rows<D>(dv + koff, dv_acc, k0 + warp * 16, Tk, lane, 1.f);
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       bf16* __restrict__ dq, int Tq, int Tk, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, BK = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BR * LD;
  bf16* kts = dos + BR * LD;       // [2][BK][LD]
  bf16* vts = kts + 2 * BK * LD;   // [2][BK][LD]
  // the last query tiles see the most keys: start them first
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float sl2 = scale * LOG2E;

  const int n_tiles = (key_end(q0, Tq, Tk, causal) + BK - 1) / BK;
  auto load_kv_tile = [&](int k0, int st) {
    load_rows<BK, D>(kts + st * BK * LD, k + koff, k0, Tk);
    load_rows<BK, D>(vts + st * BK * LD, v + koff, k0, Tk);
  };
  load_rows<BR, D>(qs, q + qoff, q0, Tq);
  load_rows<BR, D>(dos, dout + qoff, q0, Tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv_tile(0, 0);
  cp_async_commit();
  // this thread's rows: q0 + 16 warp + g and + 8
  float lse2[2], di_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    lse2[h] = row < Tq ? lse[at] * LOG2E : 0.f;
    di_r[h] = row < Tq ? di[at] : 0.f;
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  Resident<D> qr, dor;
  qr.init(qs, warp, lane);
  dor.init(dos, warp, lane);

  float dq_acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv_tile(k0 + BK, st ^ 1);
    cp_async_commit();
    const bf16* kt = kts + st * BK * LD;
    const bf16* vt = vts + st * BK * LD;
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    scores<D, BK>(s, qr, kt, lane);
    scores<D, BK>(dp, dor, vt, lane);
    // query rows past Tq are never stored, so only the keys' end and the
    // causal frontier need the element mask
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(s[j][e] * sl2 - lse2[h]);
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = q0 + warp * 16 + g + 8 * h;
          if (col >= Tk || (causal && col > row + off)) p = 0.f;
        }
        dp[j][e] = p * (dp[j][e] - di_r[h]);
      }
    }
    accumulate<D, BK>(dq_acc, dp, kt, lane);  // dq += ds k
  }
  cp_async_wait<0>();
  store_rows<D>(dq + qoff, dq_acc, q0 + warp * 16, Tq, lane, scale);
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores.
//
// Replaces, for bf16 q/k/v: _fwd_kernel in mxnet_tpu/ops/flash_attention.py
// (:100). The f32 instantiation is tf32x3::flash_fwd_tc_kernel below.
//
// Bound on the H100: operations, barely. At B=4 H=16 T=1024 D=64 causal it
// does 2 block products of 2*D flops per live (query, key) pair, 8.6 GFLOP,
// 8.7 us at 989 TFLOP/s (H100 SXM data sheet, 700 W), against ~10 us for
// its 34 MB (q, k, v in, o and lse out) at 3.35 TB/s.
//
// Design: FlashAttention-2 on mma.sync m16n8k16 with the helpers above. One
// block of 4 warps owns 64 query rows, 16 a warp; Q is the resident
// operand (its A fragments in registers at D = 64, re-read from shared
// memory at D = 128). The block walks the K/V tiles of Tile<D>::BN keys that
// its rows can see, double-buffered with cp.async. Per tile: s = Q K^T
// (f32 C fragments), the online softmax on those fragments in registers (a
// row's four owner lanes, lane ^ 1 and lane ^ 2, reduce its max), the O
// accumulator rescaled by corr = exp(m_old - m_new) when the max moves, and
// O += P V with the f32 p packed to bf16 A fragments (frag_from_acc): p never
// touches shared memory, and V's [key][channel] tile is the (N, D) operand
// of accumulate. Exponentials are exp2f of s * scale * log2(e). Each lane
// keeps the partial row sums l of its own columns; the four are added at the
// end. Epilogue: o = acc * (1 / l) rounded to bf16, lse = m + log(l) in f32
// for rows with l > 0, else 0 (out 0). Tiles that the
// causal mask hides entirely are skipped, the element mask runs only on the
// tiles on the causal frontier or the ragged end, and blocks start from the
// last query tiles, which see the most keys.
//
// Rounding. Exactly two things are rounded to bf16: the softmax numerators
// p before P V, and the output. Scores, exp, m, l (summed from the f32 p),
// lse and the O accumulator are f32; the scale is applied to s in f32, not
// folded into a bf16 q (1/sqrt(128) is not a power of two). The TPU kernel's
// f32 dot_general of p and v runs on its matrix unit with bf16 operands at
// JAX's default precision: the same rounding. p is rounded against the
// running max, not the final one, so it may sit one bf16 ulp away from
// exp(s - m_final) rounded; chip_smoke.py's rounded check allows for that.
template <int D>
__host__ __device__ constexpr size_t fwd_tc_smem_bytes() {
  // the resident Q tile and double-buffered K and V tiles
  return (BR + 4 * Tile<D>::BN) * Tile<D>::LD * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int Tq, int Tk, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, BK = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kts = qs + BR * LD;        // [2][BK][LD]
  bf16* vts = kts + 2 * BK * LD;   // [2][BK][LD]
  // the last query tiles see the most keys: start them first
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float sl2 = scale * LOG2E;

  const int n_tiles = (key_end(q0, Tq, Tk, causal) + BK - 1) / BK;
  auto load_kv_tile = [&](int k0, int st) {
    load_rows<BK, D>(kts + st * BK * LD, k + koff, k0, Tk);
    load_rows<BK, D>(vts + st * BK * LD, v + koff, k0, Tk);
  };
  load_rows<BR, D>(qs, q + qoff, q0, Tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  Resident<D> qr;
  qr.init(qs, warp, lane);

  // this thread's rows q0 + 16 warp + g (h = 0) and + 8 (h = 1); m in
  // units of s * scale * log2(e), l this lane's share of the row sum
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv_tile(k0 + BK, st ^ 1);
    cp_async_commit();
    const bf16* kt = kts + st * BK * LD;
    const bf16* vt = vts + st * BK * LD;
    float s[BK / 8][4] = {};
    scores<D, BK>(s, qr, kt, lane);
    // query rows past Tq are never stored, so only the keys' end and the
    // causal frontier need the element mask
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + off);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float x = s[j][e] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = q0 + warp * 16 + g + 8 * h;
          if (col >= Tk || (causal && col > row + off)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    }
    float base[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with no live key yet keeps m = -inf: guard exp against nan
      base[h] = m_new == -INFINITY ? 0.f : m_new;
      corr[h] = exp2f(m[h] - base[h]);  // 0 while m was -inf
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);  // 0 for masked keys
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
    }
    accumulate<D, BK>(acc, s, vt, lane);  // o += p v
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
  store_rows<D>(o + qoff, acc, q0 + warp * 16, Tq, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + 8 * h;
      if (row < Tq)
        lse[static_cast<size_t>(bh) * Tq + row] =
            l[h] > 0.f ? m[h] * (1.f / LOG2E) + logf(l[h]) : 0.f;
    }
  }
}

}  // namespace bf16tc

// ---------------------------------------------------------------------------
// The f32 forward and backward on the tensor cores, in 3xTF32.
//
// Replace, for f32 q/k/v/do: _fwd_kernel, _bwd_dkv_kernel and _bwd_dq_kernel
// in mxnet_tpu/ops/flash_attention.py (:100, :256 and :285).
//
// Bound on the H100: operations. At B=4 H=16 T=1024 D=64 causal the forward
// does 2 block products of 2*D flops per live (query, key) pair, 8.6 GFLOP,
// dK/dV 4, 17.2 GFLOP, and dQ 3, 12.9 GFLOP. An f32-accurate product on the
// tensor cores takes three TF32 products, so the least time of this work on
// this card is 3 x flops over 494.7 TFLOP/s of dense TF32 (H100 SXM data
// sheet, 700 W): 52, 104 and 78 us, against 128, 257 and 193 us for the
// flops over the 67 TFLOP/s of the f32 CUDA cores. The bytes (34 MB for the
// forward, about 100 MB for the backward) take 10 and 30 us at 3.35 TB/s.
//
// Design: the structure of the bf16 kernels above (4 warps per block, 64
// output rows a block and 16 a warp, the looped operand double-buffered
// with cp.async, masked tiles skipped, the element mask only on the
// frontier and ragged tiles, the forward and dQ starting from the last
// query tiles, which see the most keys, no atomics) with every product on
// mma.sync m16n8k8 TF32 in 3xTF32 (tf32x3.cuh): each f32 operand is split in
// registers into tf32 hi + lo, and each product is a_lo b_hi + a_hi b_lo
// + a_hi b_hi with f32 accumulators, f32-accurate where one TF32 pass is
// not. Per looped tile:
//   forward: s = Q K^T, the online softmax on the C fragments in registers
//            (softmax_tile: exp2 of s scale log2(e), O rescaled when a row's
//            max moves), O += P V with the f32 p as A fragments;
//   dK/dV:   s^T = K Q^T and dp^T = V dO^T, p^T = exp(s^T scale - lse) under
//            the mask, ds^T = p^T (dp^T - di); dV += p^T dO, dK += ds^T Q;
//   dQ:      s = Q K^T, dp = dO V^T, p and ds as above; dQ += ds K.
// Shared memory: tiles as f32 [row][channel] with a row stride of D + 4
// floats, conflict-free for the three fragment loads (tf32x3.cuh). The C
// fragments of p and ds are the A fragments of the accumulating products
// under the k-permutation of mma_sm90.cuh, so p and ds never touch shared
// memory. Every operand is read from shared memory at each use and split
// there, the resident tile's A fragments too: split, one resident operand's
// fragments take 64 registers a thread at D = 64, and in the backward two
// of them do not fit beside the 128 of the accumulators. The looped tile is
// 64 rows at D = 64 and 32 rows at D = 128, double-buffered at both. Shared
// memory, forward: 87,040 bytes (D = 64) and 101,376 (D = 128), two blocks
// an SM at both; backward: 105,472 (two blocks an SM) and 135,680 (one).
//
// Numerics: scores, exp, lse, di, p, ds and every accumulator are f32, as
// in the plain versions; each product misses only the lo x lo term (about
// 2^-22 of it) and the sums run in another order, so the kernels are close
// to, but not bit-identical with, the plain forward and FA-2 backward.
// chip_smoke.py holds each at the f32 tolerance and at a tight limit that a
// single TF32 pass fails.
namespace tf32x3 {

using bf16tc::load_vec;

template <int D>
struct Tile {
  static constexpr int LD = D + 4;              // shared-memory row stride (floats)
  static constexpr int BN = D == 64 ? 64 : 32;  // rows of the looped tile
};

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  // two resident tiles, two double-buffered looped tiles, two f32 vectors
  return ((2 * BR + 4 * Tile<D>::BN) * Tile<D>::LD + 4 * Tile<D>::BN) * sizeof(float);
}

template <int D>
__host__ __device__ constexpr size_t fwd_smem_bytes() {
  // the resident Q tile and double-buffered K and V tiles
  return (BR + 4 * Tile<D>::BN) * Tile<D>::LD * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_fwd_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    int Tq, int Tk, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, BK = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* kts = qs + BR * LD;       // [2][BK][LD]
  float* vts = kts + 2 * BK * LD;  // [2][BK][LD]
  // the last query tiles see the most keys: start them first
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float sl2 = scale * LOG2E;

  const int n_tiles = (key_end(q0, Tq, Tk, causal) + BK - 1) / BK;
  auto load_kv_tile = [&](int k0, int st) {
    load_rows<BK, D, LD>(kts + st * BK * LD, k + koff, k0, Tk);
    load_rows<BK, D, LD>(vts + st * BK * LD, v + koff, k0, Tk);
  };
  load_rows<BR, D, LD>(qs, q + qoff, q0, Tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv_tile(0, 0);
  cp_async_commit();
  const float* qw = qs + warp * 16 * LD;  // this warp's 16 queries

  // this thread's rows q0 + 16 warp + g (h = 0) and + 8 (h = 1); m in
  // units of s * scale * log2(e), l this lane's share of the row sum
  float acc[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, st = it & 1;
    cp_async_wait<0>();  // tile it (and Q) has landed ...
    __syncthreads();     // ... for every thread, and tile it - 1 is no longer read
    if (it + 1 < n_tiles) load_kv_tile(k0 + BK, st ^ 1);
    cp_async_commit();
    const float* kt = kts + st * BK * LD;
    const float* vt = vts + st * BK * LD;
    float s[BK / 8][4] = {};
    scores<D, BK, LD, LD>(s, qw, kt, lane);
    // query rows past Tq are never stored, so only the keys' end and the
    // causal frontier need the element mask
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = q0 + warp * 16 + g + 8 * (e >> 1);
          if (col >= Tk || (causal && col - row > off)) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }
    float corr[2], pv[D / 8][4] = {};
    softmax_tile<BK>(s, m, l, corr);
    accumulate<D, BK, LD>(pv, s, vt, lane);  // this tile's p v
    add_tile<D>(acc, corr, pv);               // o = o corr + p v
  }
  cp_async_wait<0>();

  float inv[2];
  finish_rows(l, inv);
  store_rows<D>(o + qoff, acc, q0 + warp * 16, Tq, lane, inv);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + g + 8 * h;
      if (row < Tq)
        lse[static_cast<size_t>(bh) * Tq + row] =
            l[h] > 0.f ? m[h] * (1.f / LOG2E) + logf(l[h]) : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_bwd_dkv_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        float* __restrict__ dk, float* __restrict__ dv, int Tq, int Tk,
                        int causal, float scale) {
  constexpr int LD = Tile<D>::LD, BQ = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BR * LD;
  float* qs = vs + BR * LD;          // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;     // [2][BQ][LD]
  float* lse_s = dos + 2 * BQ * LD;  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;      // [2][BQ]
  const int bh = blockIdx.y, k0 = blockIdx.x * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float* lse_b = lse + static_cast<size_t>(bh) * Tq;
  const float* di_b = di + static_cast<size_t>(bh) * Tq;
  const float sl2 = scale * LOG2E;

  // the first query tile with a row that sees key k0; the tiles before it
  // are masked out entirely
  const int q_begin = causal ? (max(0, k0 - off) / BQ) * BQ : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + BQ - 1) / BQ : 0;
  auto load_q_tile = [&](int q0, int st) {
    load_rows<BQ, D, LD>(qs + st * BQ * LD, q + qoff, q0, Tq);
    load_rows<BQ, D, LD>(dos + st * BQ * LD, dout + qoff, q0, Tq);
    load_vec<BQ>(lse_s + st * BQ, lse_b, q0, Tq, 0);
    load_vec<BQ>(di_s + st * BQ, di_b, q0, Tq, BQ);
  };
  load_rows<BR, D, LD>(ks, k + koff, k0, Tk);
  load_rows<BR, D, LD>(vs, v + koff, k0, Tk);
  cp_async_commit();
  if (n_tiles > 0) load_q_tile(q_begin, 0);
  cp_async_commit();
  const float* kw = ks + warp * 16 * LD;  // this warp's 16 keys
  const float* vw = vs + warp * 16 * LD;

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = q_begin + it * BQ, st = it & 1;
    cp_async_wait<0>();  // tile it (and K, V) has landed ...
    __syncthreads();     // ... for every thread, and tile it - 1 is no longer read
    if (it + 1 < n_tiles) load_q_tile(q0 + BQ, st ^ 1);
    cp_async_commit();
    const float* qt = qs + st * BQ * LD;
    const float* dot = dos + st * BQ * LD;
    const float* lse_t = lse_s + st * BQ;
    const float* di_t = di_s + st * BQ;
    // transposed: rows are this warp's keys, columns the tile's queries
    float pt[BQ / 8][4] = {}, dst[BQ / 8][4] = {};
    scores<D, BQ, LD, LD>(pt, kw, qt, lane);
    scores<D, BQ, LD, LD>(dst, vw, dot, lane);
    // key rows past Tk are never stored, so only the queries' end and the
    // causal frontier need the element mask
    const bool edge = q0 + BQ > Tq || (causal && k0 + BR - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float p = exp2f(pt[j][e] * sl2 - lse_t[c] * LOG2E);
        if (edge) {
          const int row = q0 + c, key = k0 + warp * 16 + g + 8 * (e >> 1);
          if (row >= Tq || (causal && key - row > off)) p = 0.f;
        }
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - di_t[c]);
      }
    }
    accumulate<D, BQ, LD>(dv_acc, pt, dot, lane);   // dv += p^T do
    accumulate<D, BQ, LD>(dk_acc, dst, qt, lane);   // dk += ds^T q
  }
  cp_async_wait<0>();
  store_rows<D>(dk + koff, dk_acc, k0 + warp * 16, Tk, lane, scale);
  store_rows<D>(dv + koff, dv_acc, k0 + warp * 16, Tk, lane, 1.f);
}

template <int D>
__global__ void __launch_bounds__(NTH)
flash_bwd_dq_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       float* __restrict__ dq, int Tq, int Tk, int causal, float scale) {
  constexpr int LD = Tile<D>::LD, BK = Tile<D>::BN;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + BR * LD;
  float* kts = dos + BR * LD;      // [2][BK][LD]
  float* vts = kts + 2 * BK * LD;  // [2][BK][LD]
  // the last query tiles see the most keys: start them first
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;
  const float sl2 = scale * LOG2E;

  const int n_tiles = (key_end(q0, Tq, Tk, causal) + BK - 1) / BK;
  auto load_kv_tile = [&](int k0, int st) {
    load_rows<BK, D, LD>(kts + st * BK * LD, k + koff, k0, Tk);
    load_rows<BK, D, LD>(vts + st * BK * LD, v + koff, k0, Tk);
  };
  load_rows<BR, D, LD>(qs, q + qoff, q0, Tq);
  load_rows<BR, D, LD>(dos, dout + qoff, q0, Tq);
  cp_async_commit();
  if (n_tiles > 0) load_kv_tile(0, 0);
  cp_async_commit();
  // this thread's rows: q0 + 16 warp + g and + 8
  float lse2[2], di_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * Tq + row;
    lse2[h] = row < Tq ? lse[at] * LOG2E : 0.f;
    di_q[h] = row < Tq ? di[at] : 0.f;
  }
  const float* qw = qs + warp * 16 * LD;  // this warp's 16 queries
  const float* dow = dos + warp * 16 * LD;

  float dq_acc[D / 8][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK, st = it & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_tiles) load_kv_tile(k0 + BK, st ^ 1);
    cp_async_commit();
    const float* kt = kts + st * BK * LD;
    const float* vt = vts + st * BK * LD;
    float s[BK / 8][4] = {}, ds[BK / 8][4] = {};
    scores<D, BK, LD, LD>(s, qw, kt, lane);
    scores<D, BK, LD, LD>(ds, dow, vt, lane);
    // query rows past Tq are never stored, so only the keys' end and the
    // causal frontier need the element mask
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float p = exp2f(s[j][e] * sl2 - lse2[h]);
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = q0 + warp * 16 + g + 8 * h;
          if (col >= Tk || (causal && col - row > off)) p = 0.f;
        }
        ds[j][e] = p * (ds[j][e] - di_q[h]);
      }
    }
    accumulate<D, BK, LD>(dq_acc, ds, kt, lane);  // dq += ds k
  }
  cp_async_wait<0>();
  store_rows<D>(dq + qoff, dq_acc, q0 + warp * 16, Tq, lane, scale);
}

}  // namespace tf32x3

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Opt a kernel in to its dynamic shared memory (above the 48 KB default)
// once per instantiation.
template <typename K>
static cudaError_t allow_smem(K kern, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) done = true;
  return e;
}

template <int D, typename T>
static int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int BH,
               int Tq, int Tk, int causal, cudaStream_t s) {
  static bool attr = false;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((Tq + tf32x3::BR - 1) / tf32x3::BR, BH);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using bf16tc::bf16;
    const size_t smem = bf16tc::fwd_tc_smem_bytes<D>();
    auto kern = bf16tc::flash_fwd_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, tf32x3::NTH, smem, s>>>(static_cast<const bf16*>(q),
                                         static_cast<const bf16*>(k),
                                         static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
                                         Tq, Tk, causal, scale);
  } else {  // f32: 3xTF32 on the tensor cores
    const size_t smem = tf32x3::fwd_smem_bytes<D>();
    auto kern = tf32x3::flash_fwd_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, tf32x3::NTH, smem, s>>>(static_cast<const float*>(q),
                                         static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o),
                                         lse, Tq, Tk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
static int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dk, void* dv, int BH, int Tq,
                   int Tk, int causal, cudaStream_t s) {
  static bool attr = false;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dk) ||
      !aligned16(dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using bf16tc::bf16;
    const size_t smem = bf16tc::smem_bytes<D>();
    auto kern = bf16tc::flash_bwd_dkv_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((Tk + tf32x3::BR - 1) / tf32x3::BR, BH);
    kern<<<grid, tf32x3::NTH, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Tq, Tk, causal, scale);
  } else {  // f32: 3xTF32 on the tensor cores
    const size_t smem = tf32x3::smem_bytes<D>();
    auto kern = tf32x3::flash_bwd_dkv_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((Tk + tf32x3::BR - 1) / tf32x3::BR, BH);
    kern<<<grid, tf32x3::NTH, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dk),
        static_cast<float*>(dv), Tq, Tk, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
static int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* di, void* dq, int BH, int Tq, int Tk,
                  int causal, cudaStream_t s) {
  static bool attr = false;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dout) || !aligned16(dq))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using bf16tc::bf16;
    const size_t smem = bf16tc::smem_bytes<D>();
    auto kern = bf16tc::flash_bwd_dq_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((Tq + tf32x3::BR - 1) / tf32x3::BR, BH);
    kern<<<grid, tf32x3::NTH, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, di, static_cast<bf16*>(dq), Tq, Tk, causal,
        scale);
  } else {  // f32: 3xTF32 on the tensor cores
    const size_t smem = tf32x3::smem_bytes<D>();
    auto kern = tf32x3::flash_bwd_dq_tc_kernel<D>;
    const cudaError_t e = allow_smem(kern, smem, attr);
    if (e != cudaSuccess) return static_cast<int>(e);
    dim3 grid((Tq + tf32x3::BR - 1) / tf32x3::BR, BH);
    kern<<<grid, tf32x3::NTH, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, di, static_cast<float*>(dq), Tq, Tk, causal,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (head dim, dtype): the instantiations the wrapper admits.
#define MX_FLASH_DISPATCH(FN, ...)                                              \
  do {                                                                          \
    if (dtype == MX_F32 && D == 64) return FN<64, float>(__VA_ARGS__);          \
    if (dtype == MX_F32 && D == 128) return FN<128, float>(__VA_ARGS__);        \
    if (dtype == MX_BF16 && D == 64) return FN<64, __nv_bfloat16>(__VA_ARGS__); \
    if (dtype == MX_BF16 && D == 128) return FN<128, __nv_bfloat16>(__VA_ARGS__); \
    return static_cast<int>(cudaErrorInvalidValue);                             \
  } while (0)

// q, o: (BH, Tq, D); k, v: (BH, Tk, D); lse: (BH, Tq) f32 or NULL; all
// contiguous, q/k/v/o in one dtype. Returns cudaGetLastError().
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int BH, int Tq, int Tk, int D, int causal, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_FLASH_DISPATCH(fwd, q, k, v, o, static_cast<float*>(lse), BH, Tq, Tk, causal, s);
}

// dout like q; lse, di: (BH, Tq) f32; dk, dv like k. Returns cudaGetLastError().
extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* di, void* dk, void* dv, int BH,
                                int Tq, int Tk, int D, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(di), dk, dv, BH, Tq, Tk, causal, s);
}

// dq like q. Returns cudaGetLastError().
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* di, void* dq, int BH, int Tq,
                               int Tk, int D, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MX_FLASH_DISPATCH(bwd_dq, q, k, v, dout, static_cast<const float*>(lse),
                    static_cast<const float*>(di), dq, BH, Tq, Tk, causal, s);
}

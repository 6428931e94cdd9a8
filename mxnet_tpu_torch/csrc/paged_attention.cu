// Paged (and dense) cached attention read for Hopper (sm_90a).
//
// Replaces: _paged_kernel in mxnet_tpu/ops/pallas_paged_attention.py (the
// Pallas TPU kernel that gathers each row's pages into VMEM and runs the
// frontier-masked softmax). The token scatter stays outside, in PyTorch.
//
// Computes, for row b, head h and query i of a chunk of Tq new positions:
//   out[b,h,i] = softmax_k(q[b,h,i] . K[b,h,k] / sqrt(Ch)) V[b,h,k]
// over the keys k <= position[b] + i (and k < n_pages*ps), where key k of
// row b lives at pool[table[b, k / ps], h, k % ps]. Scores, softmax and the
// weighted sum are f32; the output is cast to q's dtype. Page ids outside
// the pool read the trash page 0. q and the pools are f32 or bf16 in any
// pair, or f16 q over f32 pools. Low-precision q over an f32 pool is what
// an f32 model's cached read gives under amp.init("bfloat16") or
// amp.init("float16"): there the softmax weights are rounded to q's dtype
// before the weighted sum, as the TPU kernel (and, for f16, the JAX gather
// path) rounds att to q's dtype before its f32 product with v (the weights
// against the running max, the row sum l from the f32 weights); the other
// pairs keep f32 weights.
//
// Bound on the H100: bytes. Decode (Tq = 1) does 4*Ch flops per key and
// moves 2*Ch*itemsize bytes of K and V per key, 0.5 flop per byte in f32,
// so the least time is the bytes of the live keys over 3.35 TB/s. Prefill
// chunks reuse each key Tq times and are still far below the tensor-core
// ridge at these sizes.
//
// Design (flash-decoding). One block of 4 warps per (row, head, tile of QT
// queries, split of the key range); QT is 1 for decode and 8 for prefill
// chunks. Keys are walked in fixed tiles of 32 *logical* key indices. The
// key range is cut into splits of `split_keys` logical keys (a multiple of
// 128: 4 tiles, one a warp, for a decode batch too small to fill the card
// alone; 2^30, one split, when the (row, head, query tile) blocks already
// number a few per SM, as a prefill chunk's do); see _split_plan in
// ops/paged_attention.py. A split holds tiles t_begin.. of its range, tile t
// taken by warp t % 4. Each lane looks up the page of one key of the tile,
// and the warp copies the tile's K and V rows into shared memory by 16-byte
// cp.async, all of them in flight together; so the walk reads only the
// pages the row's table names, each byte once per query tile, and never a
// pool-wide gather. Each warp keeps an online softmax; the four warps merge
// in warp order. A split past the queries' frontier does nothing. With one
// live split the block writes `out`; otherwise each split writes its
// partial (m, l, o[Ch]) to the workspace `part`, and the last of the live
// splits to arrive (an int32 counter per (row, head, query tile), bumped
// after __threadfence, set back to 0 by that block) merges the partials in
// split order and writes `out`. One launch per read; the kernel allocates
// nothing.
//
// Dense == paged, bit for bit. The split boundaries, the tile of each warp,
// the number of live splits and every sum follow logical key indices and
// `split_keys` only, never ps, n_pages or the pool, and stop at the queries'
// furthest frontier; so the dense cache, viewed as a pool of B pages of
// Tmax with an identity table, gives bit-identical results to a paged
// pool. Keys past a query's frontier are skipped, so they contribute
// exactly 0 whatever the pool holds there. No tensor cores or TMA.
#include <type_traits>

#include "common.cuh"
#include "mma_sm90.cuh"

constexpr int KT = 32;    // keys per tile: one per lane
constexpr int NWARP = 4;  // warps per block, splitting the key tiles
constexpr unsigned FULL = 0xffffffffu;

// Elements of TKV in one 16-byte copy.
template <typename TKV>
__host__ __device__ constexpr int e16() { return 16 / static_cast<int>(sizeof(TKV)); }

template <int QT, int CH, typename TKV>
__host__ __device__ constexpr size_t smem_bytes() {
  // query tile (f32) + per warp a K tile (rows padded by 16 bytes, so that
  // lanes reading their own row 16 bytes at a time hit distinct banks) and
  // a V tile, in the pool's dtype; the warps' merge records reuse the K/V
  // tiles
  constexpr size_t kv = NWARP * KT * ((CH + e16<TKV>()) + CH) * sizeof(TKV);
  constexpr size_t merge = NWARP * QT * (CH + 2) * sizeof(float);
  return QT * CH * sizeof(float) + (kv > merge ? kv : merge);
}

// 16 bytes of shared memory as f32.
__device__ __forceinline__ void load16(float (&f)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load16(float (&f)[8], const __nv_bfloat16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The weight p as it enters the weighted sum: rounded to q's dtype for
// low-precision q over an f32 pool (see above), else unchanged.
template <typename TQ, typename TKV>
__device__ __forceinline__ float sum_weight(float p) {
  if constexpr (!std::is_same<TQ, float>::value && std::is_same<TKV, float>::value)
    return to_f32(from_f32<TQ>(p));
  return p;
}

template <int QT, int CH, typename TQ, typename TKV>
__global__ void __launch_bounds__(NWARP * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ position, TQ* __restrict__ out,
                       float* __restrict__ part, int* __restrict__ arrivals, int H, int Tq,
                       int ps, int n_pages, int n_pool, int split_keys, float scale) {
  constexpr int CPL = (CH + 31) / 32;  // channels per lane in the output
  constexpr int E = e16<TKV>();
  constexpr int KS = CH + E;           // padded K row stride
  constexpr int RC = CH / E;           // 16-byte copies per row
  constexpr int MS = CH + 2;           // a merge record: m, l, o[CH]
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * QT, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = position[b];
  const int cap = n_pages * ps;
  const int nq = min(QT, Tq - q0);
  const int last_key = min(pos + q0 + nq - 1, cap - 1);
  const int n_live = last_key / split_keys + 1;
  if (split >= n_live) return;  // the whole split is past every frontier
  const int t_begin = split * (split_keys / KT);
  const int t_end = min(t_begin + split_keys / KT, last_key / KT + 1);

  float* q_s = reinterpret_cast<float*>(smem);
  TKV* k_s = reinterpret_cast<TKV*>(q_s + QT * CH) + warp * KT * (KS + CH);
  TKV* v_s = k_s + KT * KS;

  const size_t q_base = (static_cast<size_t>(bh) * Tq + q0) * CH;
  for (int i = threadIdx.x; i < QT * CH; i += NWARP * 32)
    q_s[i] = i < nq * CH ? to_f32(q[q_base + i]) : 0.f;
  __syncthreads();

  // each query's frontier (last key it attends), -1 for padding queries
  int fr[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi)
    fr[qi] = qi < nq ? min(pos + q0 + qi, cap - 1) : -1;

  float m[QT], l[QT], o[QT][CPL];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    m[qi] = -INFINITY;
    l[qi] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[qi][c] = 0.f;
  }

  for (int t = t_begin + warp; t < t_end; t += NWARP) {
    const int k0 = t * KT;
    // this lane's key: its page (ids outside the pool read the trash page)
    const int key = k0 + lane;
    long long base = -1;
    if (key <= last_key) {
      int pid = table[static_cast<size_t>(b) * n_pages + key / ps];
      if (pid < 0 || pid >= n_pool) pid = 0;
      base = ((static_cast<long long>(pid) * H + h) * ps + key % ps) * CH;
    }
    // K and V rows of the tile into shared memory by 16-byte copies, all in
    // flight together; keys past the last one read as zeros
#pragma unroll 8
    for (int i = lane; i < KT * RC; i += 32) {
      const int j = i / RC, c = (i % RC) * E;
      const long long bj = __shfl_sync(FULL, base, j);
      const long long at = (bj >= 0 ? bj : 0) + c;
      const int n = bj >= 0 ? 16 : 0;
      cp_async16(k_s + j * KS + c, k_pool + at, n);
      cp_async16(v_s + j * CH + c, v_pool + at, n);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // scores: lane <-> key, f32 dot in channel order
    float s[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) s[qi] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; c += E) {
      float kv[E];
      load16(kv, k_s + lane * KS + c);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&q_s[qi * CH + c + e]);
          s[qi] = fmaf(qv.x, kv[e], s[qi]);
          s[qi] = fmaf(qv.y, kv[e + 1], s[qi]);
          s[qi] = fmaf(qv.z, kv[e + 2], s[qi]);
          s[qi] = fmaf(qv.w, kv[e + 3], s[qi]);
        }
      }
    }
    // online softmax over the tile; s becomes the unnormalized weight
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const bool valid = key <= fr[qi];
      const float sv = valid ? s[qi] * scale : -INFINITY;
      const float mnew = fmaxf(m[qi], warp_max(sv));
      const float p = valid ? expf(sv - mnew) : 0.f;
      const float alpha = m[qi] == -INFINITY ? 0.f : expf(m[qi] - mnew);
      l[qi] = l[qi] * alpha + warp_sum(p);
      m[qi] = mnew;
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[qi][c] *= alpha;
      s[qi] = sum_weight<TQ, TKV>(p);
    }
    // weighted V: keys in order; a key past a query's frontier is skipped
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      const int kj = k0 + j;
      if (kj > last_key) break;
      float vv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        vv[c] = ch < CH ? to_f32(v_s[j * CH + ch]) : 0.f;
      }
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float pj = __shfl_sync(FULL, s[qi], j);
        if (kj <= fr[qi]) {
#pragma unroll
          for (int c = 0; c < CPL; ++c) o[qi][c] = fmaf(pj, vv[c], o[qi][c]);
        }
      }
    }
    __syncwarp();  // the next tile overwrites k_s / v_s
  }

  // merge the four warps' partial softmax states in warp order
  __syncthreads();
  float* mrg = q_s + QT * CH;  // reuses the K/V tiles
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    float* rec = mrg + (warp * QT + qi) * MS;
    if (lane == 0) {
      rec[0] = m[qi];
      rec[1] = l[qi];
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + 32 * c;
      if (ch < CH) rec[2 + ch] = o[qi][c];
    }
  }
  __syncthreads();
  const int n_splits = gridDim.z;
  for (int qi = warp; qi < nq; qi += NWARP) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) mx = fmaxf(mx, mrg[(w * QT + qi) * MS]);
    float den = 0.f, acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float* rec = mrg + (w * QT + qi) * MS;
      const float f = rec[0] == -INFINITY ? 0.f : expf(rec[0] - mx);
      den = fmaf(rec[1], f, den);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < CH) acc[c] = fmaf(rec[2 + ch], f, acc[c]);
      }
    }
    if (n_live == 1) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < CH)
          out[q_base + qi * CH + ch] = from_f32<TQ>(den > 0.f ? acc[c] / den : 0.f);
      }
    } else {  // this split's partial for query qi
      float* rec = part + ((static_cast<size_t>(bh) * Tq + q0 + qi) * n_splits + split) * MS;
      if (lane == 0) {
        rec[0] = mx;
        rec[1] = den;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < CH) rec[2 + ch] = acc[c];
      }
    }
  }
  if (n_live == 1) return;

  // the last live split to arrive merges the partials
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* slot = arrivals + static_cast<size_t>(bh) * gridDim.y + blockIdx.y;
    is_last = atomicAdd(slot, 1) == n_live - 1;
    if (is_last) *slot = 0;  // every live split has arrived: ready for the next read
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int qi = warp; qi < nq; qi += NWARP) {
    const float* recs = part + (static_cast<size_t>(bh) * Tq + q0 + qi) * n_splits * MS;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_live; ++sp) mx = fmaxf(mx, __ldcg(recs + sp * MS));
    float den = 0.f, acc[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float* rec = recs + sp * MS;
      const float ms = __ldcg(rec);
      const float f = ms == -INFINITY ? 0.f : expf(ms - mx);
      den = fmaf(__ldcg(rec + 1), f, den);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < CH) acc[c] = fmaf(__ldcg(rec + 2 + ch), f, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + 32 * c;
      if (ch < CH) out[q_base + qi * CH + ch] = from_f32<TQ>(den > 0.f ? acc[c] / den : 0.f);
    }
  }
}

struct Args {
  const void *q, *kp, *vp, *table, *position;
  void *out, *part, *arrivals;
  int B, H, Tq, ps, n_pages, n_pool, split_keys, n_splits;
};

template <int QT, int CH, typename TQ, typename TKV>
static int launch(const Args& a, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, CH, TQ, TKV>;
  constexpr size_t smem = smem_bytes<QT, CH, TKV>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(CH));
  dim3 grid(a.B * a.H, (a.Tq + QT - 1) / QT, a.n_splits);
  kern<<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), static_cast<const int*>(a.table),
      static_cast<const int*>(a.position), static_cast<TQ*>(a.out),
      static_cast<float*>(a.part), static_cast<int*>(a.arrivals), a.H, a.Tq, a.ps,
      a.n_pages, a.n_pool, a.split_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, typename TQ, typename TKV>
static int by_channels(int Ch, const Args& a, cudaStream_t s) {
  switch (Ch) {
    case 16: return launch<QT, 16, TQ, TKV>(a, s);
    case 32: return launch<QT, 32, TQ, TKV>(a, s);
    case 64: return launch<QT, 64, TQ, TKV>(a, s);
    case 128: return launch<QT, 128, TQ, TKV>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TKV>
static int by_tile(int Ch, const Args& a, cudaStream_t s) {
  if (a.Tq == 1) return by_channels<1, TQ, TKV>(Ch, a, s);
  return by_channels<8, TQ, TKV>(Ch, a, s);
}

// q, out: (B, H, Tq, Ch); pools: (n_pool, H, ps, Ch), 16-byte aligned;
// table: (B, n_pages) int32; position: (B,) int32; all contiguous.
// split_keys: logical keys of a split, a multiple of 128; n_splits: the
// grid's splits, ceil(n_pages * ps / split_keys). With n_splits > 1, part is
// (B * H * Tq, n_splits, Ch + 2) f32 and arrivals B * H * ceil(Tq / QT)
// int32 zeros (QT = 1 for Tq = 1, else 8), left zero by the kernel; else
// both may be NULL. Returns cudaGetLastError().
extern "C" int mx_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* position, void* out,
                                  void* part, void* arrivals, int B, int H, int Tq, int Ch,
                                  int ps, int n_pages, int n_pool, int split_keys,
                                  int n_splits, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((reinterpret_cast<uintptr_t>(k_pool) & 15) || (reinterpret_cast<uintptr_t>(v_pool) & 15))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (split_keys <= 0 || split_keys % (KT * NWARP) || n_splits < 1 ||
      (n_splits > 1 && (part == nullptr || arrivals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, table, position, out, part, arrivals,
               B, H, Tq, ps, n_pages, n_pool, split_keys, n_splits};
  if (q_dtype == MX_F32 && kv_dtype == MX_F32) return by_tile<float, float>(Ch, a, s);
  if (q_dtype == MX_F32 && kv_dtype == MX_BF16) return by_tile<float, __nv_bfloat16>(Ch, a, s);
  if (q_dtype == MX_BF16 && kv_dtype == MX_F32) return by_tile<__nv_bfloat16, float>(Ch, a, s);
  if (q_dtype == MX_F16 && kv_dtype == MX_F32) return by_tile<__half, float>(Ch, a, s);
  if (q_dtype == MX_BF16 && kv_dtype == MX_BF16)
    return by_tile<__nv_bfloat16, __nv_bfloat16>(Ch, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

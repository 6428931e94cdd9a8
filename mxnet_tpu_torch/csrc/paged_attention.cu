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
// weighted sum are f32; the output is cast to q's dtype.
//
// Bound on the H100: bytes. Decode (Tq = 1) does 4*Ch flops per key and
// moves 2*Ch*itemsize bytes of K and V per key, 0.5 flop per byte in f32,
// so the least time is the bytes of the live keys over 3.35 TB/s. Prefill
// chunks reuse each key Tq times and are still far below the tensor-core
// ridge at these sizes.
//
// Design: one block of 4 warps per (row, head, tile of QT queries); QT is 1
// for decode and 8 for prefill chunks. Keys are walked in fixed tiles of 32
// *logical* key indices, tile t taken by warp t % 4, with an online softmax
// per warp and a merge of the four warps in a fixed order at the end. Each
// lane looks up the page of one key of the tile, and the warp copies the
// tile's K and V rows into shared memory with the loads of the whole tile
// in flight together, so the walk reads only the pages the row's table
// names, each byte once per query tile, and never a pool-wide gather.
// Because the tiling and every sum follow logical key order and stop at
// the tile's furthest frontier, the page size never changes the
// arithmetic: the dense cache, viewed as a pool of B pages of Tmax with an
// identity table, gives bit-identical results to a paged pool. Keys past a
// query's frontier are skipped, so they contribute exactly 0 whatever the
// pool holds there. No tensor cores or TMA yet.
#include "common.cuh"

constexpr int KT = 32;    // keys per tile: one per lane
constexpr int NWARP = 4;  // warps per block, splitting the key tiles
constexpr unsigned FULL = 0xffffffffu;

template <int QT, int CH>
__host__ __device__ constexpr int smem_floats() {
  // query tile + per warp a K tile (rows padded by 4 floats so that lanes
  // reading their own row as float4 hit distinct banks) and a V tile
  return QT * CH + NWARP * KT * ((CH + 4) + CH);
}

template <int QT, int CH, typename TQ, typename TKV>
__global__ void __launch_bounds__(NWARP * 32)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                       const TKV* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ position, TQ* __restrict__ out,
                       int H, int Tq, int ps, int n_pages, int n_pool, float scale) {
  constexpr int CPL = (CH + 31) / 32;  // channels per lane in the output
  constexpr int KS = CH + 4;           // padded K row stride
  extern __shared__ __align__(16) float smem[];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = position[b];
  const int cap = n_pages * ps;
  const int nq = min(QT, Tq - q0);

  float* q_s = smem;
  float* k_s = smem + QT * CH + warp * KT * (KS + CH);
  float* v_s = k_s + KT * KS;

  const size_t q_base = ((static_cast<size_t>(b) * H + h) * Tq + q0) * CH;
  for (int i = threadIdx.x; i < QT * CH; i += NWARP * 32)
    q_s[i] = i < nq * CH ? to_f32(q[q_base + i]) : 0.f;
  __syncthreads();

  // each query's frontier (last key it attends), -1 for padding queries
  int fr[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi)
    fr[qi] = qi < nq ? min(pos + q0 + qi, cap - 1) : -1;
  const int last_key = min(pos + q0 + nq - 1, cap - 1);
  const int n_tiles = last_key >= 0 ? last_key / KT + 1 : 0;

  float m[QT], l[QT], o[QT][CPL];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    m[qi] = -INFINITY;
    l[qi] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[qi][c] = 0.f;
  }

  for (int t = warp; t < n_tiles; t += NWARP) {
    const int k0 = t * KT;
    // this lane's key: its page (ids outside the pool read the trash page)
    const int key = k0 + lane;
    long long base = -1;
    if (key <= last_key) {
      int pid = table[static_cast<size_t>(b) * n_pages + key / ps];
      if (pid < 0 || pid >= n_pool) pid = 0;
      base = ((static_cast<long long>(pid) * H + h) * ps + key % ps) * CH;
    }
    // K and V rows of the tile into shared memory, all loads in flight
#pragma unroll 8
    for (int i = lane; i < KT * CH; i += 32) {
      const int j = i / CH, c = i % CH;
      const long long bj = __shfl_sync(FULL, base, j);
      float kv = 0.f, vv = 0.f;
      if (bj >= 0) {
        kv = to_f32(k_pool[bj + c]);
        vv = to_f32(v_pool[bj + c]);
      }
      k_s[j * KS + c] = kv;
      v_s[j * CH + c] = vv;
    }
    __syncwarp();

    // scores: lane <-> key, f32 dot in channel order
    float s[QT];
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) s[qi] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(&k_s[lane * KS + c]);
#pragma unroll
      for (int qi = 0; qi < QT; ++qi) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[qi * CH + c]);
        s[qi] = fmaf(qv.x, kv.x, s[qi]);
        s[qi] = fmaf(qv.y, kv.y, s[qi]);
        s[qi] = fmaf(qv.z, kv.z, s[qi]);
        s[qi] = fmaf(qv.w, kv.w, s[qi]);
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
      s[qi] = p;
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
        vv[c] = ch < CH ? v_s[j * CH + ch] : 0.f;
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
  constexpr int MS = CH + 2;
  float* mrg = smem + QT * CH;  // reuses the K/V tiles
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
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + 32 * c;
      if (ch < CH)
        out[q_base + qi * CH + ch] = from_f32<TQ>(den > 0.f ? acc[c] / den : 0.f);
    }
  }
}

template <int QT, int CH, typename TQ, typename TKV>
static int launch(const void* q, const void* kp, const void* vp, const void* table,
                  const void* position, void* out, int B, int H, int Tq, int ps,
                  int n_pages, int n_pool, cudaStream_t stream) {
  auto kern = paged_attention_kernel<QT, CH, TQ, TKV>;
  constexpr size_t smem = smem_floats<QT, CH>() * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(CH));
  dim3 grid(B * H, (Tq + QT - 1) / QT);
  kern<<<grid, NWARP * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(position), static_cast<TQ*>(out), H, Tq, ps,
      n_pages, n_pool, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int QT, typename TQ, typename TKV>
static int by_channels(int Ch, const void* q, const void* kp, const void* vp,
                       const void* table, const void* position, void* out, int B,
                       int H, int Tq, int ps, int n_pages, int n_pool,
                       cudaStream_t s) {
  switch (Ch) {
    case 16: return launch<QT, 16, TQ, TKV>(q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
    case 32: return launch<QT, 32, TQ, TKV>(q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
    case 64: return launch<QT, 64, TQ, TKV>(q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
    case 128: return launch<QT, 128, TQ, TKV>(q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TQ, typename TKV>
static int by_tile(int Tq, int Ch, const void* q, const void* kp, const void* vp,
                   const void* table, const void* position, void* out, int B, int H,
                   int ps, int n_pages, int n_pool, cudaStream_t s) {
  if (Tq == 1)
    return by_channels<1, TQ, TKV>(Ch, q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
  return by_channels<8, TQ, TKV>(Ch, q, kp, vp, table, position, out, B, H, Tq, ps, n_pages, n_pool, s);
}

// q, out: (B, H, Tq, Ch); pools: (n_pool, H, ps, Ch); table: (B, n_pages)
// int32; position: (B,) int32; all contiguous. Returns cudaGetLastError().
extern "C" int mx_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* table, const void* position, void* out,
                                  int B, int H, int Tq, int Ch, int ps, int n_pages,
                                  int n_pool, int q_dtype, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == MX_F32 && kv_dtype == MX_F32)
    return by_tile<float, float>(Tq, Ch, q, k_pool, v_pool, table, position, out, B, H, ps, n_pages, n_pool, s);
  if (q_dtype == MX_F32 && kv_dtype == MX_BF16)
    return by_tile<float, __nv_bfloat16>(Tq, Ch, q, k_pool, v_pool, table, position, out, B, H, ps, n_pages, n_pool, s);
  if (q_dtype == MX_BF16 && kv_dtype == MX_BF16)
    return by_tile<__nv_bfloat16, __nv_bfloat16>(Tq, Ch, q, k_pool, v_pool, table, position, out, B, H, ps, n_pages, n_pool, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// Bound on the H100: operations. At GPT-2 shapes (D = 64, T = 1024) the
// forward does 4*D flops per live (query, key) pair and moves 4*T*D
// elements per slice, about 200 flops per byte, far above the ~20 that the
// f32 CUDA cores do per byte of HBM (H100 SXM data sheet, 700 W power
// limit: 67 TFLOP/s over 3.35 TB/s), so the least time is the flops over
// 67 TFLOP/s (these kernels use no tensor cores). The backward does 7
// block products per tile pair against the forward's 2, split 4 (dK/dV)
// and 3 (dQ).
//
// Design: the TPU kernels walk a sequential grid axis and carry m, l and
// the accumulators in VMEM scratch from one grid step to the next. Blocks
// on the card run in no order, so each block owns one output tile and
// walks the other operand's tiles in a loop of its own:
//   forward and dQ: one block per (b*h, tile of 64 queries), looping over
//   the 64-key tiles its rows can see;
//   dK/dV: one block per (b*h, tile of 64 keys), looping over the query
//   tiles that can see it.
// No block writes another's output, so there are no atomics and results
// are the same from run to run. Tiles that the causal mask hides entirely
// are skipped, as _causal_gated does on the TPU. Every tile sits in shared
// memory as f32, transposed to [channel][row] with a row stride of 65
// floats: a warp reading one channel across 32 rows and a warp reading one
// row across 32 channels both hit 32 distinct banks, so one layout serves
// the score products (q k^T, do v^T) and the accumulating products
// (p v, p^T do, ds^T q, ds k). 256 threads form a 16 x 16 grid; thread
// (ty, tx) holds the 4 x 4 scores of rows ty*4+i and columns tx+16*j in
// registers, and the 4 x D/16 accumulator entries of rows ty*4+i and
// channels tx+16*c. A row's 16 owners are the lanes of one half-warp, so
// the row max and row sum of the online softmax are 4 shuffles. Ragged
// lengths are masked in the kernel: rows past Tq load zeros and are not
// stored, keys past Tk are masked out of the softmax.
#include "common.cuh"

constexpr int BT = 64;        // rows of a query or key tile
constexpr int TS = BT + 1;    // row stride of a transposed tile in shared memory
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr unsigned FULL = 0xffffffffu;

template <int D>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  return 3 * D * TS + BT * TS;  // q, k, v tiles and the p tile
}
template <int D>
__host__ __device__ constexpr size_t dkv_smem_floats() {
  return 4 * D * TS + 2 * BT * TS + 2 * BT;  // k, v, q, do, p, ds, lse, di
}
template <int D>
__host__ __device__ constexpr size_t dq_smem_floats() {
  return 4 * D * TS + BT * TS;  // q, do, k, v and the ds tile
}

// Rows [r0, r0 + BT) of a (n, D) row-major slice into sm[d * TS + r] as f32
// times mul; rows at or past n read as 0. Consecutive threads take
// consecutive channels: coalesced in device memory, distinct banks here.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* sm, const T* __restrict__ src, int r0,
                                          int n, float mul) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, d = i % D;
    const int row = r0 + r;
    sm[d * TS + r] = row < n ? to_f32(src[static_cast<size_t>(row) * D + d]) * mul : 0.f;
  }
}

// Sum (or max) over the 16 lanes of a half-warp: the owners of one row.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// End (exclusive) of the keys that query rows [q0, q0 + BT) can see.
__device__ __forceinline__ int key_end(int q0, int Tq, int Tk, int causal) {
  if (!causal) return Tk;
  const int last = min(q0 + BT, Tq) - 1 + (Tk - Tq);  // frontier of the last row
  return max(0, min(Tk, last + 1));
}

// acc[i][j] += sum_d a[d * TS + ra + i] * b[d * TS + rb + 16 j] over d < D:
// the 4 x 4 register tile of a product of two transposed tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, int ra,
                                         const float* b, int rb) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[d * TS + ra + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[d * TS + rb + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][c] += sum_r w[(ra + i) * TS + r] * t[(tx + 16 c) * TS + r] over
// r < BT: the accumulating product of a row-major (64 x 64) weight tile and
// a transposed (D x 64) operand tile.
template <int D>
__device__ __forceinline__ void tile_acc(float (&acc)[4][D / 16], const float* w, int ra,
                                         const float* t, int tx) {
#pragma unroll 4
  for (int r = 0; r < BT; ++r) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[(ra + i) * TS + r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float y = t[(tx + 16 * c) * TS + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(x[i], y, acc[i][c]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int causal,
                 float scale) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* ks = qs + D * TS;
  float* vs = ks + D * TS;
  float* ps = vs + D * TS;
  const int bh = blockIdx.y, q0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;

  load_tile<D>(qs, q + qoff, q0, Tq, scale);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(q0, Tq, Tk, causal);
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_tile<D>(ks, k + koff, k0, Tk, 1.f);
    load_tile<D>(vs, v + koff, k0, Tk, 1.f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, qs, ty * 4, ks, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = col < Tk && (!causal || col <= row + off);
        s[i][j] = live ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      // a row with no live key yet keeps m = -inf: guard exp against nan
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_safe);
        ps[(ty * 4 + i) * TS + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = corr * l[i] + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_acc<D>(acc, ps, ty * 4, vs, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      o[qoff + static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * Tq + row] = l[i] == 0.f ? 0.f : m[i] + logf(l[i]);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk, int causal,
                     float scale) {
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + D * TS;
  float* qs = vs + D * TS;
  float* dos = qs + D * TS;
  float* ps = dos + D * TS;
  float* dss = ps + BT * TS;
  float* lse_s = dss + BT * TS;
  float* di_s = lse_s + BT;
  const int bh = blockIdx.y, k0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;

  load_tile<D>(ks, k + koff, k0, Tk, 1.f);
  load_tile<D>(vs, v + koff, k0, Tk, 1.f);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first query tile with a row that sees key k0 (query r sees k0 when
  // r + off >= k0); every tile before it is masked out entirely
  const int q_begin = causal ? (max(0, k0 - off) / BT) * BT : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BT) {
    __syncthreads();  // the previous tile's q, do, p and ds are no longer read
    load_tile<D>(qs, q + qoff, q0, Tq, scale);
    load_tile<D>(dos, dout + qoff, q0, Tq, 1.f);
    if (threadIdx.x < BT) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Tq ? lse[static_cast<size_t>(bh) * Tq + row] : 0.f;
      di_s[threadIdx.x] = row < Tq ? di[static_cast<size_t>(bh) * Tq + row] : 0.f;
    }
    __syncthreads();
    // transposed scores: rows are keys ty*4+i, columns queries tx+16j
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, ks, ty * 4, qs, tx);
    tile_dot<D>(dp, vs, ty * 4, dos, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        const bool live = row < Tq && key < Tk && (!causal || key <= row + off);
        const float p = live ? expf(s[i][j] - lse_s[r]) : 0.f;
        ps[(ty * 4 + i) * TS + r] = p;
        dss[(ty * 4 + i) * TS + r] = p * (dp[i][j] - di_s[r]);
      }
    }
    __syncthreads();
    tile_acc<D>(dv_acc, ps, ty * 4, dos, tx);
    tile_acc<D>(dk_acc, dss, ty * 4, qs, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const size_t at = koff + static_cast<size_t>(key) * D + tx + 16 * c;
      dk[at] = from_f32<T>(dk_acc[i][c]);
      dv[at] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    T* __restrict__ dq, int Tq, int Tk, int causal, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + D * TS;
  float* ks = dos + D * TS;
  float* vs = ks + D * TS;
  float* dss = vs + D * TS;
  const int bh = blockIdx.y, q0 = blockIdx.x * BT;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int off = Tk - Tq;
  const size_t qoff = static_cast<size_t>(bh) * Tq * D, koff = static_cast<size_t>(bh) * Tk * D;

  load_tile<D>(qs, q + qoff, q0, Tq, scale);
  load_tile<D>(dos, dout + qoff, q0, Tq, 1.f);
  float lse_r[4], di_r[4], dq_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < Tq ? lse[static_cast<size_t>(bh) * Tq + row] : 0.f;
    di_r[i] = row < Tq ? di[static_cast<size_t>(bh) * Tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq_acc[i][c] = 0.f;
  }

  const int k_end = key_end(q0, Tq, Tk, causal);
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous tile's k, v and ds are no longer read
    load_tile<D>(ks, k + koff, k0, Tk, 1.f);
    load_tile<D>(vs, v + koff, k0, Tk, 1.f);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, qs, ty * 4, ks, tx);
    tile_dot<D>(dp, dos, ty * 4, vs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool live = row < Tq && col < Tk && (!causal || col <= row + off);
        const float p = live ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty * 4 + i) * TS + tx + 16 * j] = p * (dp[i][j] - di_r[i]);
      }
    }
    __syncthreads();
    tile_acc<D>(dq_acc, dss, ty * 4, ks, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)  // chain rule through q * scale
      dq[qoff + static_cast<size_t>(row) * D + tx + 16 * c] = from_f32<T>(dq_acc[i][c] * scale);
  }
}

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
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<D, T>;
  const cudaError_t e = allow_smem(kern, smem, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Tq + BT - 1) / BT, BH);
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<T*>(o), lse, Tq, Tk,
                              causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
static int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* di, void* dk, void* dv, int BH, int Tq,
                   int Tk, int causal, cudaStream_t s) {
  static bool attr = false;
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<D, T>;
  const cudaError_t e = allow_smem(kern, smem, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Tk + BT - 1) / BT, BH);
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
                              static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, causal,
                              1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
static int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* di, void* dq, int BH, int Tq, int Tk,
                  int causal, cudaStream_t s) {
  static bool attr = false;
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kern = flash_bwd_dq_kernel<D, T>;
  const cudaError_t e = allow_smem(kern, smem, attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Tq + BT - 1) / BT, BH);
  kern<<<grid, NT, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<const T*>(dout), lse, di,
                              static_cast<T*>(dq), Tq, Tk, causal,
                              1.0f / sqrtf(static_cast<float>(D)));
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

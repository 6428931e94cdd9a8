// Row LayerNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces: _ln_kernel in mxnet_tpu/ops/pallas_layernorm.py (the Pallas
// TPU kernel behind the LayerNorm op's fused dispatch), and computes the
// VJP of its custom_vjp, _ln_bwd there (plain jnp that XLA fuses).
//
// Bound on the H100: bytes. The forward reads x and writes y, the backward
// reads x and the cotangent g and writes dx (plus gamma, beta, dgamma,
// dbeta: d values each), at ~10 flops an element, far below the card's ~20
// f32 flops per byte. At serving shapes (8 to 512 rows of 1024) the bytes
// take under a microsecond and the launch and one round trip to memory
// are most of the time; at the training shape (4096, 1024) the bytes are.
//
// Two routes, which the wrapper (ops/layernorm.py _route) picks before the
// launch:
//   warp:  one warp a row, several rows a block, for rows that are a whole
//          number of 16-byte vectors at 16-byte aligned addresses and fit a
//          warp's registers. Lane l holds the vectors l, l + 32, ... of the
//          row (32 f32 values a lane at d = 1024), read once by 16-byte
//          loads. Statistics in _ln_kernel's order, over the registers: the
//          mean, then the mean of (x - mean)^2 (two passes keep their digits
//          when |mean| >> std, where E[x^2] - mean^2 does not), each summed
//          by __shfl_xor_sync in a fixed order. No shared memory and no
//          __syncthreads in the forward.
//   block: one block of 256 threads a row, scalar loads and block sums in
//          shared memory: the other widths up to MAX_D, ragged rows and
//          misaligned bases.
//
// Backward (the analytic VJP, all in f32): each row recomputes mean and
// rstd from x, as _ln_bwd does, so the only residuals are x and gamma;
// dx = rstd * (dy - mean(dy) - xhat * mean(dy * xhat)) with dy = g * gamma,
// stored in x's dtype. dgamma and dbeta are column sums over all rows of
// g * xhat and g: a fixed grid of blocks strides over the rows, each block
// sums its rows per column in f32 and writes one partial (2 * d f32) to a
// workspace, and a second launch sums the partials in block order. No
// atomics: the sums are the same bit for bit from run to run. On the warp
// route a warp loads its next row while it works on this one, so x, g,
// their successors and gamma take ~200 registers a thread: one block of 8
// warps an SM (the wrapper's BWD_WARPS and BWD_BLOCKS_PER_SM, the fastest
// of the shapes tools/torch_layernorm_bench.py tries).
#include "common.cuh"

constexpr int LN_THREADS = 256;         // block route: threads a row
constexpr int LN_MAX_D = 8192;          // widest row (ops/layernorm.py MAX_D)
constexpr int LN_MAX_WARPS = 8;         // warp route: rows a block
// warp backward: its warps' column sums, at most LN_MAX_WARPS warps at
// d = 1024 (above 48 KiB after cudaFuncSetAttribute)
constexpr int LN_BWD_SMEM = LN_MAX_WARPS * 2 * 1024 * sizeof(float);

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A 32-bit word holds one f32 value or two bf16 values (the lower half first).
template <typename S> struct Word;
template <> struct Word<float> {
  static constexpr int N = 1;
  static __device__ __forceinline__ void get(uint32_t w, float* v) { v[0] = __uint_as_float(w); }
  static __device__ __forceinline__ uint32_t put(const float* v) { return __float_as_uint(v[0]); }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int N = 2;
  static __device__ __forceinline__ void get(uint32_t w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t put(const float* v) {
    // round to nearest even, as torch's .to(bfloat16)
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[0]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v[1]))) << 16);
  }
};

// N values of type S at p, as f32: 16-byte loads, or one 8-byte load when
// they are 8 bytes (bf16 gamma beside an f32 row's 4-value vector).
template <typename S, int N>
__device__ __forceinline__ void load_f32(const S* p, float* v) {
  constexpr int K = Word<S>::N, W = N / K;  // W words
  static_assert(W % 4 == 0 || W == 2, "16- or 8-byte vectors");
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      Word<S>::get(u.x, v + (4 * i) * K);
      Word<S>::get(u.y, v + (4 * i + 1) * K);
      Word<S>::get(u.z, v + (4 * i + 2) * K);
      Word<S>::get(u.w, v + (4 * i + 3) * K);
    }
  } else {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    Word<S>::get(u.x, v);
    Word<S>::get(u.y, v + K);
  }
}

// One 16-byte vector of type T at p from its 16 / sizeof(T) f32 values.
template <typename T>
__device__ __forceinline__ void store_f32(T* p, const float* v) {
  constexpr int K = Word<T>::N;
  uint4 u;
  u.x = Word<T>::put(v);
  u.y = Word<T>::put(v + K);
  u.z = Word<T>::put(v + 2 * K);
  u.w = Word<T>::put(v + 3 * K);
  *reinterpret_cast<uint4*>(p) = u;
}

// Sum over the block; every thread returns the total.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = lane < (LN_THREADS >> 5) ? red[lane] : 0.f;
  return warp_sum(t);
}

// ---------------------------------------------------------------------------
// Forward

// Warp route. C: 16-byte vectors a lane at most (d <= 32 * C * VEC).
template <typename T, typename P, int C>
__global__ void __launch_bounds__(LN_MAX_WARPS * 32)
layernorm_fwd_warp_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                          const P* __restrict__ beta, T* __restrict__ y, int rows, int d,
                          float eps) {
  constexpr int VEC = 16 / sizeof(T);
  // gamma and beta are read with the row while the three fit the registers
  constexpr bool HOLD = C * VEC <= 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: every shuffle below has 32 lanes
  const int nvec = d / VEC;
  const size_t off = static_cast<size_t>(row) * d;
  float v[C][VEC], gm[HOLD ? C : 1][VEC], bt[HOLD ? C : 1][VEC];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + 32 * k;
    if (c < nvec) {
      load_f32<T, VEC>(x + off + c * VEC, v[k]);
      if constexpr (HOLD) {
        load_f32<P, VEC>(gamma + c * VEC, gm[k]);
        load_f32<P, VEC>(beta + c * VEC, bt[k]);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (lane + 32 * k < nvec)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[k][j];
  const float mean = warp_sum(s) / static_cast<float>(d);
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (lane + 32 * k < nvec)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = v[k][j] - mean;
        s2 += c * c;
      }
  const float rstd = rsqrtf(warp_sum(s2) / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + 32 * k;
    if (c < nvec) {
      float g[VEC], b[VEC], o[VEC];
      if constexpr (HOLD) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          g[j] = gm[k][j];
          b[j] = bt[k][j];
        }
      } else {
        load_f32<P, VEC>(gamma + c * VEC, g);
        load_f32<P, VEC>(beta + c * VEC, b);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = (v[k][j] - mean) * rstd * g[j] + b[j];
      store_f32<T>(y + off + c * VEC, o);
    }
  }
}

// Block route: the row staged in shared memory as f32 (d <= 8192 -> at
// most 32 KB), three passes over that copy.
template <typename T, typename P>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_fwd_block_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                           const P* __restrict__ beta, T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const T* xr = x + off;
  T* yr = y + off;

  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / static_cast<float>(d);
  float s2 = 0.f;
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / static_cast<float>(d);
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += LN_THREADS) {
    const float v = (row[i] - mean) * rstd;
    yr[i] = from_f32<T>(v * to_f32(gamma[i]) + to_f32(beta[i]));
  }
}

// ---------------------------------------------------------------------------
// Backward

// Warp route: warp w of the grid takes rows w, w + (all warps), ...,
// loading the next row's x and g while it works on this one; its lanes
// keep their columns' running sums of g * xhat and g in the warp's own
// slice of shared memory (2 * d f32, touched by no other warp), and the
// block adds its warps' slices in warp order into its partial.
template <typename T, typename P, int C>
__global__ void __launch_bounds__(LN_MAX_WARPS * 32)
layernorm_bwd_warp_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float4 sums4[];
  float* sums = reinterpret_cast<float*>(sums4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int nvec = d / VEC;
  float* acc = sums + static_cast<size_t>(warp) * 2 * d;  // g * xhat, then g
  float gm[C][VEC];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int c = lane + 32 * k;
    if (c < nvec) {
      load_f32<P, VEC>(gamma + c * VEC, gm[k]);
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        *reinterpret_cast<float4*>(acc + c * VEC + j) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(acc + d + c * VEC + j) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
  const int stride = gridDim.x * warps;
  float v[C][VEC], gr[C][VEC];  // this row's x and g
  auto load_row = [&](int row, float (&xv)[C][VEC], float (&gv)[C][VEC]) {
    const size_t off = static_cast<size_t>(row) * d;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        load_f32<T, VEC>(x + off + c * VEC, xv[k]);
        load_f32<T, VEC>(g + off + c * VEC, gv[k]);
      }
    }
  };
  int row = blockIdx.x * warps + warp;
  if (row < rows) load_row(row, v, gr);
  for (; row < rows; row += stride) {
    const size_t off = static_cast<size_t>(row) * d;
    float vn[C][VEC], gn[C][VEC];  // the next row's, in flight meanwhile
    if (row + stride < rows) load_row(row + stride, vn, gn);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (lane + 32 * k < nvec)
#pragma unroll
        for (int j = 0; j < VEC; ++j) s += v[k][j];
    const float mean = warp_sum(s) / static_cast<float>(d);
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (lane + 32 * k < nvec)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float c = v[k][j] - mean;
          s2 += c * c;
        }
    const float rstd = rsqrtf(warp_sum(s2) / static_cast<float>(d) + eps);
    float s_dy = 0.f, s_dyx = 0.f;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (lane + 32 * k < nvec)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xh = (v[k][j] - mean) * rstd;
          const float dy = gr[k][j] * gm[k][j];
          v[k][j] = xh;
          s_dy += dy;
          s_dyx += dy * xh;
        }
    const float m_dy = warp_sum(s_dy) / static_cast<float>(d);
    const float m_dyx = warp_sum(s_dyx) / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = lane + 32 * k;
      if (c < nvec) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          o[j] = rstd * (gr[k][j] * gm[k][j] - m_dy - v[k][j] * m_dyx);
        store_f32<T>(dx + off + c * VEC, o);
#pragma unroll
        for (int j = 0; j < VEC; j += 4) {
          float4* a = reinterpret_cast<float4*>(acc + c * VEC + j);
          float4* b = reinterpret_cast<float4*>(acc + d + c * VEC + j);
          float4 ta = *a, tb = *b;
          ta.x += gr[k][j] * v[k][j];
          ta.y += gr[k][j + 1] * v[k][j + 1];
          ta.z += gr[k][j + 2] * v[k][j + 2];
          ta.w += gr[k][j + 3] * v[k][j + 3];
          tb.x += gr[k][j];
          tb.y += gr[k][j + 1];
          tb.z += gr[k][j + 2];
          tb.w += gr[k][j + 3];
          *a = ta;
          *b = tb;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = vn[k][j];
        gr[k][j] = gn[k][j];
      }
  }
  __syncthreads();
  float* part = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += blockDim.x) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += sums[static_cast<size_t>(w) * 2 * d + i];
    part[i] = t;
  }
}

// Block route: block b takes rows b, b + gridDim.x, ...; thread t holds
// the row's columns t, t + 256, ... (at most MAX_D / 256 of them) and their
// running sums in registers, and writes them to the block's partial.
template <typename T, typename P>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_bwd_block_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
                           const T* __restrict__ g, T* __restrict__ dx,
                           float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int K = LN_MAX_D / LN_THREADS;
  __shared__ float red[32];
  float ag[K], ab[K];
#pragma unroll
  for (int k = 0; k < K; ++k) ag[k] = ab[k] = 0.f;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const size_t off = static_cast<size_t>(row) * d;
    float v[K], gr[K];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * LN_THREADS;
      if (i < d) {
        v[k] = to_f32(x[off + i]);
        gr[k] = to_f32(g[off + i]);
        s += v[k];
      }
    }
    const float mean = block_sum(s, red) / static_cast<float>(d);
    float s2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (threadIdx.x + k * LN_THREADS < d) {
        const float c = v[k] - mean;
        s2 += c * c;
      }
    const float rstd = rsqrtf(block_sum(s2, red) / static_cast<float>(d) + eps);
    float s_dy = 0.f, s_dyx = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * LN_THREADS;
      if (i < d) {
        const float xh = (v[k] - mean) * rstd;
        const float dy = gr[k] * to_f32(gamma[i]);
        v[k] = xh;
        s_dy += dy;
        s_dyx += dy * xh;
      }
    }
    const float m_dy = block_sum(s_dy, red) / static_cast<float>(d);
    const float m_dyx = block_sum(s_dyx, red) / static_cast<float>(d);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * LN_THREADS;
      if (i < d) {
        const float dy = gr[k] * to_f32(gamma[i]);
        dx[off + i] = from_f32<T>(rstd * (dy - m_dy - v[k] * m_dyx));
        ag[k] += gr[k] * v[k];
        ab[k] += gr[k];
      }
    }
  }
  float* part = partial + static_cast<size_t>(blockIdx.x) * 2 * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * LN_THREADS;
    if (i < d) {
      part[i] = ag[k];
      part[d + i] = ab[k];
    }
  }
}

// dgamma, dbeta: the column sums of nparts partials (rows of 2 * d f32: the
// sums of g * xhat, then of g), in a fixed order: 32 columns a block, warp
// s of LN_MERGE_WARPS summing the partials s, s + LN_MERGE_WARPS, ... (a few
// loads each, all in flight at once), then the warps' sums in warp order.
constexpr int LN_MERGE_WARPS = 32;

template <typename P>
__global__ void __launch_bounds__(LN_MERGE_WARPS * 32)
layernorm_bwd_merge_kernel(const float* __restrict__ partial, int nparts, int d,
                           P* __restrict__ dgamma, P* __restrict__ dbeta) {
  __shared__ float part[LN_MERGE_WARPS][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int n = 2 * d, col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < n) {
#pragma unroll 4
    for (int p = slice; p < nparts; p += LN_MERGE_WARPS)
      s += partial[static_cast<size_t>(p) * n + col];
  }
  part[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < LN_MERGE_WARPS; ++k) t += part[k][lane];
    if (col < d)
      dgamma[col] = from_f32<P>(t);
    else
      dbeta[col - d] = from_f32<P>(t);
  }
}

// ---------------------------------------------------------------------------
// Launchers

// 16-byte vectors a lane of the warp route at d = 1024: the backward takes
// rows up to d = 1024, the forward rows of up to LN_WARP_VECS vectors a lane
// (4 KiB: d <= 1024 in f32, 2048 in bf16; wider f32 rows lose to the block
// route, tools/torch_layernorm_bench.py)
template <typename T> constexpr int warp_vecs() { return 1024 / (32 * (16 / sizeof(T))); }
constexpr int LN_WARP_VECS = 8;

template <typename T, typename P>
static int fwd(const void* x, const void* g, const void* b, void* y, int rows, int d, float eps,
               int warps, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T), C = warp_vecs<T>();
  const T* xp = static_cast<const T*>(x);
  const P *gp = static_cast<const P*>(g), *bp = static_cast<const P*>(b);
  T* yp = static_cast<T*>(y);
  if (warps == 0) {
    if (d > LN_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    layernorm_fwd_block_kernel<T, P><<<rows, LN_THREADS, d * sizeof(float), s>>>(xp, gp, bp, yp,
                                                                                  d, eps);
  } else {
    const int per_lane = (d / VEC + 31) / 32;
    if (warps < 1 || warps > LN_MAX_WARPS || d % VEC != 0 || per_lane > LN_WARP_VECS)
      return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(x) || !aligned16(g) || !aligned16(b) || !aligned16(y))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const int grid = (rows + warps - 1) / warps;
    if (per_lane <= C)
      layernorm_fwd_warp_kernel<T, P, C><<<grid, warps * 32, 0, s>>>(xp, gp, bp, yp, rows, d, eps);
    else
      layernorm_fwd_warp_kernel<T, P, LN_WARP_VECS><<<grid, warps * 32, 0, s>>>(xp, gp, bp, yp,
                                                                                rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
static int bwd(const void* x, const void* gamma, const void* g, void* dx, void* dgamma,
               void* dbeta, void* partial, int rows, int d, float eps, int warps, int blocks,
               cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T), C = warp_vecs<T>();
  const T *xp = static_cast<const T*>(x), *gr = static_cast<const T*>(g);
  const P* gp = static_cast<const P*>(gamma);
  T* dxp = static_cast<T*>(dx);
  float* part = static_cast<float*>(partial);
  if (rows < 1 || d < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (warps == 0) {
    if (d > LN_MAX_D) return static_cast<int>(cudaErrorInvalidValue);
    layernorm_bwd_block_kernel<T, P><<<blocks, LN_THREADS, 0, s>>>(xp, gp, gr, dxp, part, rows, d,
                                                                   eps);
  } else {
    const size_t smem = static_cast<size_t>(warps) * 2 * d * sizeof(float);
    if (warps < 1 || warps > LN_MAX_WARPS || d % VEC != 0 || d > 32 * C * VEC ||
        smem > LN_BWD_SMEM)
      return static_cast<int>(cudaErrorInvalidValue);
    if (!aligned16(x) || !aligned16(gamma) || !aligned16(g) || !aligned16(dx))
      return static_cast<int>(cudaErrorMisalignedAddress);
    static size_t allowed = 48 * 1024;  // dynamic shared memory opted into
    if (smem > allowed) {
      const cudaError_t e = cudaFuncSetAttribute(layernorm_bwd_warp_kernel<T, P, C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      allowed = smem;
    }
    layernorm_bwd_warp_kernel<T, P, C><<<blocks, warps * 32, smem, s>>>(xp, gp, gr, dxp, part,
                                                                       rows, d, eps);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  layernorm_bwd_merge_kernel<P><<<(2 * d + 31) / 32, LN_MERGE_WARPS * 32, 0, s>>>(
      part, blocks, d, static_cast<P*>(dgamma), static_cast<P*>(dbeta));
  return static_cast<int>(cudaGetLastError());
}

// x, y: (rows, d) contiguous; gamma, beta: (d,). warps: 0 for the block
// route, else the warp route with that many rows a block. Returns
// cudaGetLastError(), or an error for a route the arguments do not fit.
extern "C" int mx_layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows,
                            int d, float eps, int x_dtype, int p_dtype, int warps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == MX_F32 && p_dtype == MX_F32)
    return fwd<float, float>(x, gamma, beta, y, rows, d, eps, warps, s);
  if (x_dtype == MX_BF16 && p_dtype == MX_BF16)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows, d, eps, warps, s);
  if (x_dtype == MX_BF16 && p_dtype == MX_F32)
    return fwd<__nv_bfloat16, float>(x, gamma, beta, y, rows, d, eps, warps, s);
  if (x_dtype == MX_F32 && p_dtype == MX_BF16)
    return fwd<float, __nv_bfloat16>(x, gamma, beta, y, rows, d, eps, warps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, g (the cotangent), dx: (rows, d) contiguous, of x's dtype; gamma,
// dgamma, dbeta: (d,); partial: (blocks, 2 * d) f32 workspace. warps: 0 for
// the block route, else the warp route with that many warps a block.
// Launches the row kernel on `blocks` blocks, then the merge.
extern "C" int mx_layernorm_bwd(const void* x, const void* gamma, const void* g, void* dx,
                                void* dgamma, void* dbeta, void* partial, int rows, int d,
                                float eps, int x_dtype, int p_dtype, int warps, int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == MX_F32 && p_dtype == MX_F32)
    return bwd<float, float>(x, gamma, g, dx, dgamma, dbeta, partial, rows, d, eps, warps,
                             blocks, s);
  if (x_dtype == MX_BF16 && p_dtype == MX_BF16)
    return bwd<__nv_bfloat16, __nv_bfloat16>(x, gamma, g, dx, dgamma, dbeta, partial, rows, d,
                                             eps, warps, blocks, s);
  if (x_dtype == MX_BF16 && p_dtype == MX_F32)
    return bwd<__nv_bfloat16, float>(x, gamma, g, dx, dgamma, dbeta, partial, rows, d, eps,
                                     warps, blocks, s);
  if (x_dtype == MX_F32 && p_dtype == MX_BF16)
    return bwd<float, __nv_bfloat16>(x, gamma, g, dx, dgamma, dbeta, partial, rows, d, eps,
                                     warps, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

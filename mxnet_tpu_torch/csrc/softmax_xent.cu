// Softmax cross entropy with sparse labels for Hopper (sm_90a): forward and
// backward.
//
// Replaces: _xent_kernel in mxnet_tpu/ops/pallas_softmax_xent.py (the Pallas
// TPU kernel behind gluon.loss.SoftmaxCrossEntropyLoss's fused dispatch) and,
// for the backward, _xent_vjp_bwd there, which is plain jnp that XLA fuses
// into one pass; eager PyTorch would make five or more passes over (N, C).
//
// Computes, per row r of the logits x (N, C), f32 or bf16, in f32:
//   forward:  m[r] = max_c x[r, c];  s[r] = sum_c exp(x[r, c] - m[r]);
//             loss[r] = m[r] + log s[r] - x[r, label[r]]
//   backward: dx[r, c] = (exp(x[r, c] - m[r]) * (1 / s[r]) - [c == label[r]]) * g[r],
//             written in x's dtype (the reciprocal taken once per thread,
//             not an IEEE division per element).
// The forward writes (m, s) beside the loss and the backward takes them, not
// lse = m + log s: exp(x - lse) carries lse's rounding, ulp(lse) / 2, into
// every probability, which is 5e-4 relative at logits of 1e4 (measured on
// the card: 5.3e-5 off the plain softmax), where x - m is exact near the
// maximum.
// A label outside [0, C) picks nothing, as the TPU kernel's col == lbl never
// matches there: the loss is m + log s and the one-hot is all zeros. Such a label
// is never used as an index. A row whose maximum is -inf gives a NaN loss,
// as the JAX max-shift exp(x - max) does.
//
// Bound on the H100: bytes. The forward reads the logits once (2 or 4 bytes
// an element) for ~4 flops an element, the backward reads them once and
// writes dx once; at an LM head (4096 x 50257 bf16) that is 411.7 MB in
// 0.123 ms and 823.4 MB in 0.246 ms at 3.35 TB/s (data sheet, 700 W).
//
// Design: the TPU kernel holds a block of 128 whole rows in VMEM. A 50257-
// wide f32 row is 201 KB, no fit for shared memory, so here the forward is
// one block per row and each thread keeps a running (max, sum of exp) pair
// over a strided pass of the row (online softmax, the max rescaled once per
// group of XENT_UNROLL loads): consecutive threads read consecutive logits,
// each logit once. The pairs combine by warp shuffles and then across warps
// through shared memory in a fixed order, so a row's result does not depend
// on the launch. Thread 0 then reads x[label] (one element, just streamed
// through L2). The backward is elementwise over a grid of (row, chunk of
// BWD_CHUNK columns) and recomputes softmax from the saved (m, s). Loads are
// scalar: with C = 50257 (odd) most rows start off a 16-byte boundary.
// Offsets are 64-bit (N * C may pass 2^31).
#include "common.cuh"

constexpr int XENT_THREADS = 256;
constexpr int XENT_WARPS = XENT_THREADS / 32;
constexpr int XENT_UNROLL = 4;  // loads in flight per thread in the forward
constexpr int BWD_THREADS = 256;
constexpr int BWD_PER_THREAD = 8;
constexpr int BWD_CHUNK = BWD_THREADS * BWD_PER_THREAD;  // columns per block

// Merge the pair (m2, s2) into (m, s): both are (max, sum of exp(x - max)).
// Symmetric in its two arguments, so both lanes of a shuffle agree.
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) {  // nothing above -inf yet: exp(-inf - -inf) is NaN
    s = 0.f;
  } else {
    s = s * expf(m - mm) + s2 * expf(m2 - mm);
  }
  m = mm;
}

__device__ __forceinline__ void warp_combine(float& m, float& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    combine(m, s, m2, s2);
  }
}

template <typename T>
__global__ void __launch_bounds__(XENT_THREADS)
xent_fwd_kernel(const T* __restrict__ x, const int* __restrict__ label,
                float* __restrict__ loss, float* __restrict__ stats, int n,
                int c) {
  __shared__ float wm[XENT_WARPS], ws[XENT_WARPS];
  const long long row = blockIdx.x;
  const T* xr = x + row * static_cast<long long>(c);

  float m = -INFINITY, s = 0.f;
  for (int base = threadIdx.x; base < c; base += XENT_THREADS * XENT_UNROLL) {
    float v[XENT_UNROLL];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < XENT_UNROLL; ++k) {
      const int i = base + k * XENT_THREADS;
      v[k] = i < c ? to_f32(xr[i]) : -INFINITY;
      mx = fmaxf(mx, v[k]);
    }
    if (mx > m) {  // s is 0 while m is -inf, and exp(-inf) is 0
      s *= expf(m - mx);
      m = mx;
    }
    if (m != -INFINITY) {
#pragma unroll
      for (int k = 0; k < XENT_UNROLL; ++k) s += expf(v[k] - m);
    }
  }

  warp_combine(m, s);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wm[warp] = m;
    ws[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < XENT_WARPS ? wm[lane] : -INFINITY;
    s = lane < XENT_WARPS ? ws[lane] : 0.f;
    warp_combine(m, s);
    if (lane == 0) {
      const float l = m == -INFINITY ? __int_as_float(0x7fc00000) : m + logf(s);
      const int lb = label[row];
      const float picked = (lb >= 0 && lb < c) ? to_f32(xr[lb]) : 0.f;
      loss[row] = l - picked;
      stats[row] = m;
      stats[n + row] = s;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
xent_bwd_kernel(const T* __restrict__ x, const int* __restrict__ label,
                const float* __restrict__ stats, const float* __restrict__ g,
                T* __restrict__ dx, int n, int c) {
  const long long row = blockIdx.x;
  const long long off = row * static_cast<long long>(c);
  const float m = stats[row], inv_s = 1.f / stats[n + row], gr = g[row];
  const int lb = label[row];
  const int c0 = blockIdx.y * BWD_CHUNK + threadIdx.x;
  // all loads first, so that BWD_PER_THREAD of them are in flight
  float v[BWD_PER_THREAD];
#pragma unroll
  for (int k = 0; k < BWD_PER_THREAD; ++k) {
    const int i = c0 + k * BWD_THREADS;
    v[k] = i < c ? to_f32(x[off + i]) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < BWD_PER_THREAD; ++k) {
    const int i = c0 + k * BWD_THREADS;
    if (i < c) {
      const float p = expf(v[k] - m) * inv_s;
      dx[off + i] = from_f32<T>((p - (i == lb ? 1.f : 0.f)) * gr);
    }
  }
}

// x: (n, c) contiguous f32 or bf16 (dtype code); label: (n,) int32;
// loss: (n,) f32; stats: (2, n) f32, the rows' max and sum of exp.
// Returns cudaGetLastError().
extern "C" int mx_xent_fwd(const void* x, const void* label, void* loss, void* stats, int n,
                           int c, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || c > 0x7fffffff - XENT_THREADS * XENT_UNROLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(label);
  float* lo = static_cast<float*>(loss);
  float* sts = static_cast<float*>(stats);
  if (dtype == MX_F32)
    xent_fwd_kernel<float><<<n, XENT_THREADS, 0, st>>>(static_cast<const float*>(x), lb, lo,
                                                       sts, n, c);
  else if (dtype == MX_BF16)
    xent_fwd_kernel<__nv_bfloat16><<<n, XENT_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lb, lo, sts, n, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (n, c) contiguous, same dtype; label: (n,) int32; stats: (2, n)
// f32 from the forward; g (the loss cotangent): (n,) f32. Returns
// cudaGetLastError().
extern "C" int mx_xent_bwd(const void* x, const void* label, const void* stats, const void* g,
                           void* dx, int n, int c, int dtype, void* stream) {
  const long long chunks = (static_cast<long long>(c) + BWD_CHUNK - 1) / BWD_CHUNK;
  if (n <= 0 || c <= 0 || chunks > 65535 || c > 0x7fffffff - BWD_CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n, static_cast<unsigned>(chunks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lb = static_cast<const int*>(label);
  const float* sts = static_cast<const float*>(stats);
  const float* gg = static_cast<const float*>(g);
  if (dtype == MX_F32)
    xent_bwd_kernel<float><<<grid, BWD_THREADS, 0, st>>>(
        static_cast<const float*>(x), lb, sts, gg, static_cast<float*>(dx), n, c);
  else if (dtype == MX_BF16)
    xent_bwd_kernel<__nv_bfloat16><<<grid, BWD_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lb, sts, gg, static_cast<__nv_bfloat16*>(dx), n,
        c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

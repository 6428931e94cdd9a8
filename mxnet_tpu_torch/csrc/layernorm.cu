// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces: _ln_kernel in mxnet_tpu/ops/pallas_layernorm.py (the Pallas
// TPU kernel behind the LayerNorm op's fused dispatch).
//
// Bound on the H100: bytes. Per row it reads d inputs and writes d outputs
// and does ~8 flops per element, far below the card's ~20 flops per byte
// of f32 CUDA-core rate, so the least time is (2*rows*d*itemsize + 2*d*4)
// / 3.35 TB/s. At serving shapes (8 to 512 rows of 1024) that is well under
// a microsecond, so the launch itself is most of the time.
//
// Design: one block of 256 threads per row. The row is read from device
// memory once into shared memory as f32 (d <= 8192 -> at most 32 KB), and
// the mean, the variance of (x - mean), and the normalize + affine pass
// all read that copy: one read and one write of the row, where eager
// PyTorch's composition makes six passes with f32 temporaries. Sums are
// f32, reduced warp by warp and then across warps in a fixed order, so a
// row's result does not depend on the launch.
#include "common.cuh"

constexpr int LN_THREADS = 256;

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

template <typename T, typename P>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ x, const P* __restrict__ gamma,
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

template <typename T, typename P>
static void launch(const void* x, const void* g, const void* b, void* y,
                   int rows, int d, float eps, cudaStream_t stream) {
  layernorm_kernel<T, P><<<rows, LN_THREADS, d * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(g),
      static_cast<const P*>(b), static_cast<T*>(y), d, eps);
}

// x, y: (rows, d) contiguous; gamma, beta: (d,). Returns cudaGetLastError().
extern "C" int mx_layernorm(const void* x, const void* gamma, const void* beta,
                            void* y, int rows, int d, float eps, int x_dtype,
                            int p_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == MX_F32 && p_dtype == MX_F32)
    launch<float, float>(x, gamma, beta, y, rows, d, eps, s);
  else if (x_dtype == MX_BF16 && p_dtype == MX_BF16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, rows, d, eps, s);
  else if (x_dtype == MX_BF16 && p_dtype == MX_F32)
    launch<__nv_bfloat16, float>(x, gamma, beta, y, rows, d, eps, s);
  else if (x_dtype == MX_F32 && p_dtype == MX_BF16)
    launch<float, __nv_bfloat16>(x, gamma, beta, y, rows, d, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

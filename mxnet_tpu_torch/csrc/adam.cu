// Multi-tensor Adam for Hopper (sm_90a): one launch updates every parameter.
//
// Replaces: _adam_kernel in mxnet_tpu/ops/pallas_optimizer.py (the Pallas
// TPU kernel behind Adam.update_raw's fused dispatch, one pallas_call per
// parameter).
//
// Computes, per element, in f32 and in the op order of
// mxnet_tpu/ops/optimizer_ops.py adam_update:
//   g = g * rescale_grad; g = clip(g, -clip, clip) if clip > 0; g += wd * w
//   m = beta1 * m + (1 - beta1) * g;  v = beta2 * v + (1 - beta2) * g * g
//   w = w - lr * m / (sqrt(v) + epsilon)
// in place on the f32 master weight w and the f32 moments m and v, with an
// f32, bf16 or f16 gradient and an optional bf16 or f16 copy of the new
// weight written in the same pass. lr (the bias-corrected rate times the
// tensor's lr_mult) and wd (times wd_mult) are per-tensor f32 values read
// from device memory, so a schedule changes them without a host sync.
//
// Dynamic loss scaling (float16 mixed precision) adds two optional device
// values: inv_scale, by which the gradient is multiplied before
// rescale_grad (g * (1/scale), then * rescale_grad, the JAX TrainStep's
// order), and skip, which, when nonzero, makes the launch write nothing: an
// overflowed step leaves w, m, v and the copy bit-unchanged, decided on the
// card without a host sync.
//
// Bound on the H100: bytes. Per element it reads w, g, m, v and writes w,
// m, v: 28 bytes with an f32 gradient for ~12 flops, so the least time is
// the bytes over the H100 SXM's 3.35 TB/s (data sheet, 700 W power limit):
// for the 354.8 M parameters of gpt2_345m, 9.93 GB in 2.97 ms.
//
// Design: the TPU kernel is one pallas_call per parameter over padded
// (rows, 128) blocks. Eager PyTorch would pay a launch per parameter (292
// at gpt2_345m) and the plain update ten. Here a device table holds one
// row per tensor (pointers, size, first chunk, flags) and the grid walks
// the concatenation of all tensors in chunks of 4096 elements, one block
// per chunk: thread 0 finds the chunk's tensor by binary search over the
// tensors' first chunks, and 256 threads stream the chunk with
// consecutive threads on consecutive elements. No padding, no copies:
// each byte is read once and written once.
#include "common.cuh"

#include <cuda_fp16.h>

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_CHUNK = 4096;  // elements per block; kept in step with ops/optimizer.py
constexpr int TABLE_COLS = 8;     // w, g, m, v, low, n, first chunk, flags
constexpr long long FLAG_G_BF16 = 1;  // flags, kept in step with ops/optimizer.py
constexpr long long FLAG_G_F16 = 2;
constexpr long long FLAG_LOW_F16 = 4;  // the copy is f16 (else bf16)

__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const long long* __restrict__ table, int n_tensors, const float* __restrict__ lr,
            const float* __restrict__ wd, const float* __restrict__ inv_scale,
            const int* __restrict__ skip, float beta1, float beta2, float omb1, float omb2,
            float eps, float rescale, float clip) {
  __shared__ int tensor;
  if (skip != nullptr && *skip != 0) return;
  const long long chunk = blockIdx.x;
  if (threadIdx.x == 0) {
    // the last tensor whose first chunk is <= this chunk
    int lo = 0, hi = n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * TABLE_COLS + 6] <= chunk) lo = mid; else hi = mid - 1;
    }
    tensor = lo;
  }
  __syncthreads();
  const long long* e = table + static_cast<size_t>(tensor) * TABLE_COLS;
  float* w = reinterpret_cast<float*>(e[0]);
  const void* g = reinterpret_cast<const void*>(e[1]);
  float* m = reinterpret_cast<float*>(e[2]);
  float* v = reinterpret_cast<float*>(e[3]);
  void* low = reinterpret_cast<void*>(e[4]);
  const long long n = e[5];
  const long long flags = e[7];
  const float lr_t = lr[tensor], wd_t = wd[tensor];
  const float inv = inv_scale != nullptr ? *inv_scale : 1.f;
  const long long base = (chunk - e[6]) * ADAM_CHUNK;

#pragma unroll 4
  for (int j = 0; j < ADAM_CHUNK / ADAM_THREADS; ++j) {
    const long long i = base + j * ADAM_THREADS + threadIdx.x;
    if (i >= n) break;
    const float wf = w[i];
    float gf = (flags & FLAG_G_BF16) ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i])
               : (flags & FLAG_G_F16) ? __half2float(static_cast<const __half*>(g)[i])
                                      : static_cast<const float*>(g)[i];
    if (inv_scale != nullptr) gf = gf * inv;
    gf = gf * rescale;
    if (clip > 0.f) gf = fminf(fmaxf(gf, -clip), clip);
    gf = gf + wd_t * wf;
    const float mf = beta1 * m[i] + omb1 * gf;
    const float vf = beta2 * v[i] + omb2 * (gf * gf);
    const float nw = wf - lr_t * mf / (sqrtf(vf) + eps);
    w[i] = nw;
    m[i] = mf;
    v[i] = vf;
    if (low != nullptr) {
      if (flags & FLAG_LOW_F16)
        static_cast<__half*>(low)[i] = __float2half_rn(nw);
      else
        static_cast<__nv_bfloat16*>(low)[i] = __float2bfloat16(nw);
    }
  }
}

// table: (n_tensors, 8) int64 on the device, rows (w, g, m, v, low | 0, n,
// first chunk, flags) with the first chunks ascending; lr, wd: (n_tensors,)
// f32 on the device; inv_scale: a device f32 or NULL; skip: a device int32
// or NULL; n_chunks: the total chunk count (the grid). Returns
// cudaGetLastError().
extern "C" int mx_adam(const void* table, int n_tensors, int n_chunks, const void* lr,
                       const void* wd, const void* inv_scale, const void* skip, float beta1,
                       float beta2, float omb1, float omb2, float eps, float rescale,
                       float clip, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<<<n_chunks, ADAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_tensors, static_cast<const float*>(lr),
      static_cast<const float*>(wd), static_cast<const float*>(inv_scale),
      static_cast<const int*>(skip), beta1, beta2, omb1, omb2, eps, rescale, clip);
  return static_cast<int>(cudaGetLastError());
}

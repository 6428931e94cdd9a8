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
// f32 or bf16 gradient and an optional bf16 copy of the new weight written
// in the same pass. lr (the bias-corrected rate times the tensor's
// lr_mult) and wd (times wd_mult) are per-tensor f32 values read from
// device memory, so a schedule changes them without a host sync.
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

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_CHUNK = 4096;  // elements per block; kept in step with ops/optimizer.py
constexpr int TABLE_COLS = 8;     // w, g, m, v, low, n, first chunk, flags
constexpr long long FLAG_G_BF16 = 1;

__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const long long* __restrict__ table, int n_tensors, const float* __restrict__ lr,
            const float* __restrict__ wd, float beta1, float beta2, float omb1, float omb2,
            float eps, float rescale, float clip) {
  __shared__ int tensor;
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
  __nv_bfloat16* low = reinterpret_cast<__nv_bfloat16*>(e[4]);
  const long long n = e[5];
  const bool g_bf16 = (e[7] & FLAG_G_BF16) != 0;
  const float lr_t = lr[tensor], wd_t = wd[tensor];
  const long long base = (chunk - e[6]) * ADAM_CHUNK;

#pragma unroll 4
  for (int j = 0; j < ADAM_CHUNK / ADAM_THREADS; ++j) {
    const long long i = base + j * ADAM_THREADS + threadIdx.x;
    if (i >= n) break;
    const float wf = w[i];
    float gf = g_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(g)[i])
                      : static_cast<const float*>(g)[i];
    gf = gf * rescale;
    if (clip > 0.f) gf = fminf(fmaxf(gf, -clip), clip);
    gf = gf + wd_t * wf;
    const float mf = beta1 * m[i] + omb1 * gf;
    const float vf = beta2 * v[i] + omb2 * (gf * gf);
    const float nw = wf - lr_t * mf / (sqrtf(vf) + eps);
    w[i] = nw;
    m[i] = mf;
    v[i] = vf;
    if (low != nullptr) low[i] = __float2bfloat16(nw);
  }
}

// table: (n_tensors, 8) int64 on the device, rows (w, g, m, v, low | 0, n,
// first chunk, flags) with the first chunks ascending; lr, wd: (n_tensors,)
// f32 on the device; n_chunks: the total chunk count (the grid). Returns
// cudaGetLastError().
extern "C" int mx_adam(const void* table, int n_tensors, int n_chunks, const void* lr,
                       const void* wd, float beta1, float beta2, float omb1, float omb2,
                       float eps, float rescale, float clip, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  adam_kernel<<<n_chunks, ADAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), n_tensors, static_cast<const float*>(lr),
      static_cast<const float*>(wd), beta1, beta2, omb1, omb2, eps, rescale, clip);
  return static_cast<int>(cudaGetLastError());
}

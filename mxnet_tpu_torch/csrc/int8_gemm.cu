// INT8 fully connected and convolution products for Hopper (sm_90a):
// s8 x s8 -> s32 on the tensor cores, then the requantisation to f32,
// bf16 or f16.
//
// Replaces: no Pallas kernel. This is the counterpart of XLA's int8 dot
// and conv behind mxnet_tpu/contrib/quantization.py, quantized_fully_connected
// (lax.dot_general, :116) and quantized_conv (lax.conv_general_dilated,
// :135), both with preferred_element_type=int32. PyTorch on the card has no
// integer mm or conv2d (torch._int_mm needs M > 16 and K, N multiples of 8,
// which LeNet's K = 25 and Dense(4) fail), so the port needs its own.
//
// Two launches:
//   int8_im2col_kernel: the int8 NCHW activation (B, C, H, W) as patches
//     (G, M, K_pad), M = B*OH*OW, K = C/G*KH*KW in the weight's (c, kh, kw)
//     order, zero where the window leaves the image (padding) and for
//     k >= K; K_pad is K rounded up to 32 (one mma step). Stride, dilation
//     and groups are the convolution's.
//   int8_gemm_kernel: C[m, n] = sum_k A[m, k] W[n, k] over the true K, in
//     s32, then out = (float)C * (data_scale * ws[n]) (+ bias[n]), each
//     step rounded on its own (__fmul_rn, __fadd_rn: no contraction into an
//     FMA), cast to the output dtype: the order of JAX's
//     acc.astype(f32) * (data_scale * ws) + bias. blockIdx.z is the group.
//     For a convolution row m is (b, oh, ow) and the epilogue writes NCHW
//     directly (P = OH*OW output positions an image); for a product P = 1.
// data_scale is read from a device pointer (no host sync). The s32 sum is
// exact (|C| <= 127^2 * K < 2^31 for K < 133,000), so the result does not
// depend on the order of the sums: the plain version (an f64 matmul over
// F.unfold patches, exact below 2^53) gives the same bits.
//
// Bound on the H100: bytes at most of the paths' shapes. At resnet50's res4
// 3x3 layer, B = 32 (M = 6272, K = 2304, N = 256), the product is 7.4 G
// int8 operations, 3.7 us at 1,979 TOPS (H100 SXM data sheet, 700 W), and
// its bytes (A 14.5 MB, W 0.6 MB, f32 out 6.4 MB) take 6.4 us at 3.35 TB/s.
//
// Design: a simple tiled kernel, right first. Blocks of BM x BN outputs
// walk K in 64-byte steps through two shared-memory stages filled by
// 16-byte cp.async (rows padded to 80 bytes, so ldmatrix's eight row reads
// fall in distinct banks); warps take 16 x 8 x 32 mma.sync steps with
// fragments from ldmatrix, as the bf16 kernels do (an s8 fragment holds the
// bytes of a bf16 one). Tails in M, N and K are masked in the loads (zero
// fill) and the stores. Rows whose stride or base is not 16-byte aligned
// (a Dense with K = 120) take byte loads instead of cp.async. 128 x 128
// tiles (8 warps of 64 x 32) when they fill three quarters of the SMs, else
// 64 x 64 (4 warps of 32 x 32). wgmma with TMA, and the activation's
// quantisation fused into the im2col, are later work.
#include "common.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int BK = 64;             // bytes of K a stage
constexpr int LDS = BK + 16;       // shared row stride in bytes
constexpr int LDS16 = LDS / 2;     // the same in b16 elements (ldmatrix's view)
constexpr int IM2COL_THREADS = 256;

// Sixteen consecutive k of patch row m of group g: thread w writes bytes
// [16w, 16w + 16) of the (G, M, K_pad) output with one 16-byte store. The
// chunk's first k is split into (c, kh, kw) by division once and the next
// fifteen by counting on, since integer division, not memory, bounds this
// kernel (dividing each byte's k out took 192 us at resnet50's stem, B =
// 32, against a 21 us bytes bound; tools/torch_int8_bench.py). Index
// arithmetic is 32-bit (I = int) when every offset fits.
template <typename I>
__global__ void __launch_bounds__(IM2COL_THREADS)
int8_im2col_kernel(const int8_t* __restrict__ x, uint4* __restrict__ out, int C, int H, int W,
                   int G, int KH, int KW, int sh, int sw, int ph, int pw, int dh, int dw, int OH,
                   int OW, I M, int K, int K_pad) {
  const int chunks_row = K_pad / 16;
  const I total = static_cast<I>(G) * M * chunks_row;
  const int cg = C / G;
  const int khw = KH * KW;
  const int ohw = OH * OW;
  for (I w = blockIdx.x * static_cast<I>(blockDim.x) + threadIdx.x; w < total;
       w += static_cast<I>(gridDim.x) * blockDim.x) {
    const I rest = w / chunks_row;
    int k = static_cast<int>(w - rest * chunks_row) * 16;
    const I gi = rest / M;
    const I m = rest - gi * M;
    const I b = m / ohw;
    const int p = static_cast<int>(m - b * ohw);
    const int oh = p / OW, ow = p - (p / OW) * OW;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (k < K) {
      int c = k / khw;
      const int r = k - c * khw;
      int kh = r / KW, kw = r - (r / KW) * KW;
      const int ih0 = oh * sh - ph, iw0 = ow * sw - pw;
      const int8_t* xg = x + (b * C + gi * cg) * H * W;
#pragma unroll
      for (int j = 0; j < 16; ++j, ++k) {
        if (k >= K) break;
        const int ih = ih0 + kh * dh, iw = iw0 + kw * dw;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                           xg[(static_cast<I>(c) * H + ih) * W + iw]))
                       << (8 * (j & 3));
        if (++kw == KW) {
          kw = 0;
          if (++kh == KH) {
            kh = 0;
            ++c;
          }
        }
      }
    }
    out[w] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// One BR x 64-byte tile of a row-major int8 matrix (row stride ld) into
// shared memory (row stride LDS), rows from r0 and bytes from k0; rows past
// `rows` and bytes past K read as zeros.
template <int BR, int THREADS, bool VEC>
__device__ __forceinline__ void load_tile(int8_t* __restrict__ dst, const int8_t* __restrict__ src,
                                          long long ld, int r0, int rows, int k0, int K, int tid) {
#pragma unroll
  for (int i = tid; i < BR * (BK / 16); i += THREADS) {
    const int r = i >> 2, c = (i & 3) * 16;
    const int gr = r0 + r, gk = k0 + c;
    int8_t* d = dst + r * LDS + c;
    if (VEC) {
      int bytes = 0;
      const int8_t* s = src;
      if (gr < rows && gk < K) {
        bytes = min(16, K - gk);
        s = src + gr * ld + gk;
      }
      cp_async16(d, s, bytes);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (gr < rows) {
        const int8_t* s = src + gr * ld;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gk + j < K)
            v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(s[gk + j])) << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// out[(m / P) * n_total * P + (g * N + n) * P + m % P] for m < M, n < N of
// group g = blockIdx.z, where A is this group's (M, K) rows (stride lda, the
// group's block a_group further on) and W its (N, K) rows (stride ldw,
// w_group).
template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC, typename OutT>
__global__ void __launch_bounds__(32 * WARPS_M * WARPS_N)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Wt,
                 OutT* __restrict__ out, const float* __restrict__ dscale,
                 const float* __restrict__ ws, const float* __restrict__ bias, int M, int N,
                 int K, long long lda, long long ldw, long long a_group, long long w_group, int P,
                 int n_total) {
  constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MI = WM / 16, NJ = WN / 8;
  static_assert(NJ % 2 == 0, "B fragments load in pairs of 8-column tiles");
  __shared__ __align__(128) int8_t sA[2][BM * LDS];
  __shared__ __align__(128) int8_t sB[2][BN * LDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int8_t* a = A + g * a_group;
  const int8_t* w = Wt + g * w_group;

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + BK - 1) / BK;
  load_tile<BM, THREADS, VEC>(sA[0], a, lda, m0, M, 0, K, tid);
  load_tile<BN, THREADS, VEC>(sB[0], w, ldw, n0, N, 0, K, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < ktiles) {
      load_tile<BM, THREADS, VEC>(sA[st ^ 1], a, lda, m0, M, (kt + 1) * BK, K, tid);
      load_tile<BN, THREADS, VEC>(sB[st ^ 1], w, ldw, n0, N, (kt + 1) * BK, K, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* ta = reinterpret_cast<const uint16_t*>(sA[st]) + (wm * WM) * LDS16;
    const uint16_t* tb = reinterpret_cast<const uint16_t*>(sB[st]) + (wn * WN) * LDS16;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[MI][4];
      uint32_t bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], ta + i * 16 * LDS16 + a_off(lane, LDS16) + ks * 16);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        uint32_t r[4];
        ldsm_x4(r, tb + j * 16 * LDS16 + bn_off(lane, LDS16) + ks * 16);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();
  }

  const float ds = *dscale;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + gq + 8 * h;
      if (m >= M) continue;
      const int b = m / P;
      OutT* orow = out + (static_cast<long long>(b) * n_total * P + (m - b * P));
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * WN + j * 8 + 2 * tq + e;
          if (n >= N) continue;
          const int ng = g * N + n;
          float v = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), __fmul_rn(ds, ws[ng]));
          if (bias != nullptr) v = __fadd_rn(v, bias[ng]);
          orow[static_cast<long long>(ng) * P] = from_f32<OutT>(v);
        }
    }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, typename OutT>
cudaError_t launch_gemm(bool vec, const int8_t* a, const int8_t* w, void* out,
                        const float* dscale, const float* ws, const float* bias, int M, int N,
                        int K, long long lda, long long ldw, long long a_group, long long w_group,
                        int G, int P, cudaStream_t st) {
  const long long mt = (static_cast<long long>(M) + BM - 1) / BM;
  const long long nt = (static_cast<long long>(N) + BN - 1) / BN;
  if (mt > 0x7fffffffLL || nt > 65535 || G > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt), G);
  OutT* o = static_cast<OutT*>(out);
  if (vec)
    int8_gemm_kernel<BM, BN, WARPS_M, WARPS_N, true, OutT><<<grid, 32 * WARPS_M * WARPS_N, 0, st>>>(
        a, w, o, dscale, ws, bias, M, N, K, lda, ldw, a_group, w_group, P, G * N);
  else
    int8_gemm_kernel<BM, BN, WARPS_M, WARPS_N, false, OutT><<<grid, 32 * WARPS_M * WARPS_N, 0, st>>>(
        a, w, o, dscale, ws, bias, M, N, K, lda, ldw, a_group, w_group, P, G * N);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch_tiles(bool vec, const int8_t* a, const int8_t* w, void* out,
                           const float* dscale, const float* ws, const float* bias, int M, int N,
                           int K, long long lda, long long ldw, long long a_group,
                           long long w_group, int G, int P, cudaStream_t st) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long big = ((static_cast<long long>(M) + 127) / 128) * ((N + 127) / 128) * G;
  if (N > 64 && 4 * big >= 3LL * sms)
    return launch_gemm<128, 128, 2, 4, OutT>(vec, a, w, out, dscale, ws, bias, M, N, K, lda, ldw,
                                             a_group, w_group, G, P, st);
  return launch_gemm<64, 64, 2, 2, OutT>(vec, a, w, out, dscale, ws, bias, M, N, K, lda, ldw,
                                         a_group, w_group, G, P, st);
}

}  // namespace

// x: (B, C, H, W) int8, contiguous; out: (G, B*OH*OW, K_pad) int8,
// contiguous, 16-byte aligned, K_pad a multiple of 32 and >= C/G*KH*KW.
// Returns cudaGetLastError().
extern "C" int mx_int8_im2col(const void* x, void* out, int B, int C, int H, int W, int G, int KH,
                              int KW, int sh, int sw, int ph, int pw, int dh, int dw, int OH,
                              int OW, int K_pad, void* stream) {
  if (B <= 0 || C <= 0 || G <= 0 || C % G != 0 || KH <= 0 || KW <= 0 || OH <= 0 || OW <= 0 ||
      sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || K_pad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = C / G * KH * KW;
  if (K > K_pad || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long M = static_cast<long long>(B) * OH * OW;
  const long long chunks = static_cast<long long>(G) * M * (K_pad / 16);
  const long long blocks = (chunks + IM2COL_THREADS - 1) / IM2COL_THREADS;
  const unsigned grid = static_cast<unsigned>(blocks < (1LL << 30) ? blocks : (1LL << 30));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  uint4* op = static_cast<uint4*>(out);
  const long long limit = (1LL << 31) - IM2COL_THREADS * static_cast<long long>(grid);
  if (chunks < limit && static_cast<long long>(B) * C * H * W < (1LL << 31))
    int8_im2col_kernel<int><<<grid, IM2COL_THREADS, 0, st>>>(
        xp, op, C, H, W, G, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, static_cast<int>(M), K, K_pad);
  else
    int8_im2col_kernel<long long><<<grid, IM2COL_THREADS, 0, st>>>(
        xp, op, C, H, W, G, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, M, K, K_pad);
  return static_cast<int>(cudaGetLastError());
}

// a: G blocks (a_group bytes apart) of (M, K) int8 rows, stride lda; w: G
// blocks (w_group apart) of (N, K) rows, stride ldw; dscale: one f32 on the
// device; ws: (G*N,) f32; bias: (G*N,) f32 or NULL; out: f32, bf16 or f16
// (dtype code of common.cuh), (M / P, G*N, P) for P > 1 (NCHW), (M, G*N)
// for P = 1. Returns cudaGetLastError().
extern "C" int mx_int8_gemm(const void* a, const void* w, void* out, const void* dscale,
                            const void* ws, const void* bias, int M, int N, int K, long long lda,
                            long long ldw, long long a_group, long long w_group, int G, int P,
                            int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || P <= 0 || M % P != 0 || lda < K || ldw < K ||
      (G > 1 && (a_group < static_cast<long long>(M) * lda ||
                 w_group < static_cast<long long>(N) * ldw)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = lda % 16 == 0 && ldw % 16 == 0 && a_group % 16 == 0 && w_group % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* dsp = static_cast<const float*>(dscale);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == MX_F32)
    err = dispatch_tiles<float>(vec, ap, wp, out, dsp, wsp, bp, M, N, K, lda, ldw, a_group,
                                w_group, G, P, st);
  else if (dtype == MX_BF16)
    err = dispatch_tiles<__nv_bfloat16>(vec, ap, wp, out, dsp, wsp, bp, M, N, K, lda, ldw,
                                        a_group, w_group, G, P, st);
  else if (dtype == MX_F16)
    err = dispatch_tiles<__half>(vec, ap, wp, out, dsp, wsp, bp, M, N, K, lda, ldw, a_group,
                                 w_group, G, P, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

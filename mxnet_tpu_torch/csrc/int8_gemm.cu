// INT8 fully connected and convolution products for Hopper (sm_90a):
// s8 x s8 -> s32 on the tensor cores, then the requantisation to f32,
// bf16 or f16.
//
// Replaces: no Pallas kernel. This is the counterpart of XLA's int8 dot
// and conv behind mxnet_tpu/contrib/quantization.py, quantized_fully_connected
// (lax.dot_general, :116) and quantized_conv (lax.conv_general_dilated,
// :135), both with preferred_element_type=int32, and of the activation's
// quantisation before them (_QuantizedLayer, :178). PyTorch on the card has
// no integer mm or conv2d for these shapes (torch._int_mm needs M > 16 and
// K, N multiples of 8, which LeNet's K = 25 and Dense(4) fail).
//
// Three kernels:
//   int8_im2col_kernel: the NCHW activation (B, C, H, W) as s8 patches
//     (G, M, K_pad), M = B*OH*OW, K = C/G*KH*KW in the weight's (c, kh, kw)
//     order, zero where the window leaves the image and for k >= K; K_pad is
//     K rounded up to 32. The input is int8 (copied) or f32 / bf16 with the
//     activation scale s on the device, each element then becoming
//     clamp(rint(x / s), -127, 127) with IEEE division and rounding half to
//     even: torch.clamp(torch.round(x / s), -127, 127) and JAX's
//     jnp.clip(jnp.round(x / s), -127, 127), bit for bit.
//   int8_gemm_wgmma_kernel: C[m, n] = sum_k A[m, k] W[n, k] per group in
//     s32 on wgmma, A (M, K) and W (N, K) rows read by TMA; then
//     out = (float)C * (data_scale * ws[n]) (+ bias[n]), each step rounded on
//     its own (__fmul_rn, __fadd_rn: no contraction into an FMA), cast to the
//     output dtype: the order of JAX's acc.astype(f32) * (data_scale * ws) +
//     bias. For a convolution row m is (b, oh, ow) and the output is NCHW (P =
//     OH*OW output positions an image); for a product P = 1.
//   int8_gemm_kernel: the same product on mma.sync m16n8k32 with cp.async
//     (or byte) loads, for operands TMA cannot take: a row stride or base
//     that is not a multiple of 16 bytes (LeNet's Dense at K = 120 and 84).
// The caller (mxnet_tpu_torch/contrib/quantization.py, gemm_plan) picks the
// product's route, its tile width and its split of K by shape. The s32 sum
// is exact (|C| <= 127^2 * K < 2^31 for K < 133,000), so its value does not
// depend on the order of the partial sums, split-K included: the plain
// version (an f64 matmul over F.unfold patches, exact below 2^53) gives the
// same bits.
//
// Bounds on the H100 (resnet50_v1, B = 32): the product at res4's 3x3 (M
// 6272, K 2304, N 256) is 7.4 G int8 operations, 3.7 us at 1,979 TOPS, and
// its bytes (A 14.5 MB, W 0.6 MB, f32 out 6.4 MB) 6.4 us at 3.35 TB/s; the
// stem's (A 64 MB, f32 out 103 MB) 50 us. The im2col is bytes: the f32
// activation read once and the patches written once (res4 3x3: 6.4 + 14.5
// MB, 6.2 us).
//
// Design of the product: a persistent grid (one block an SM) walks the
// output tiles of 128 rows x BN (64 or 128) channels, split along K into
// `splits` parts where the tiles alone would leave SMs idle. In a block one
// producer warp issues TMA loads of 128-byte K slices of A and W (128-byte
// swizzle, rows and K past the tensor filled with zeros: the M and K tails)
// into a ring of stages guarded by mbarriers; two consumer warpgroups
// multiply with wgmma m64nBNk32 from shared memory, keeping one k-slice's
// MMAs in flight. Where every block has one tile they share it, 64 rows
// each; where blocks have more, they take whole tiles in turns, so that
// one's epilogue (memory-bound at the stem's 103 MB of f32 output) runs
// beside the other's MMAs. A split writes its s32 partial tile to a
// workspace; the last split of a tile to arrive (a counter) adds the
// others and runs the epilogue, which stages the scaled tile in shared
// memory so that each NCHW channel row goes out in runs along the output
// positions.
//
// Design of the im2col: a block takes `toh` output rows of one image and a
// chunk of up to 64 channels of one group (where one row's window is more
// than a block can stage: one row, fewer channels, then part of the row).
// It stages the input window those rows need (every row and column the
// taps reach, only the taps' rows for one output row; zero outside the image),
// quantised to s8, in shared memory, each thread keeping several loads in
// flight; then writes each patch row's segment for its channels with
// 16-byte stores. A 1x1 layer stages channels last ([position][channel]),
// so that a 16-byte run of its patch row is one run of shared memory, and
// loads four positions at once where the layer is unstrided. Other kernels
// stage channels first ([channel][row][column]); a table gives each k of
// the segment its tap's offset in the window, and a warp gathers 32
// consecutive positions, a lane a position (the lanes' reads of one tap
// are consecutive bytes, free of bank conflicts), into rows in shared
// memory that it then writes out in runs of 64 bytes. Integer division and
// one load in flight a thread bounded the earlier design (a thread a
// 16-byte chunk, reading each byte from NCHW global memory).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through cudart

#include "common.cuh"
#include "mma_sm90.cuh"
#include "wgmma_sm90.cuh"

namespace {

// input dtype codes of mx_int8_im2col (the float ones as common.cuh's)
enum { IN_F32 = MX_F32, IN_BF16 = MX_BF16, IN_S8 = 3 };

// ---------------------------------------------------------------------------
// im2col

constexpr int IM2COL_THREADS = 256;
constexpr int IM2COL_WARPS = IM2COL_THREADS / 32;
constexpr int IM2COL_BATCH = 4;              // window loads a thread keeps in flight
constexpr int IM2COL_CHUNK = 64;             // channels a block at most
constexpr int IM2COL_BUDGET = 32 * 1024;     // staged window bytes a block, as planned
constexpr int IM2COL_SMEM_MAX = 200 * 1024;  // the most a block may stage
// channels first: a warp gathers 32 positions x RUN 16-byte chunks of their
// patch rows at a time into rows of RUN + 1 chunks (an odd number of 16-byte
// granules apart, so the lanes' 16-byte writes do not collide)
constexpr int IM2COL_RUN = 4;
constexpr int IM2COL_ROW = 16 * (IM2COL_RUN + 1);
constexpr int IM2COL_OUT_STAGE = IM2COL_WARPS * 32 * IM2COL_ROW;

// e / d for e * d < 2^32, by one multiply: m = floor(2^32 / d) + 1.
struct FastDiv {
  uint32_t d, m;
};
__host__ __device__ __forceinline__ FastDiv fast_div(int d) {
  return {static_cast<uint32_t>(d),
          d == 1 ? 0u : static_cast<uint32_t>((1ULL << 32) / static_cast<uint32_t>(d) + 1)};
}
__device__ __forceinline__ int divide(int e, FastDiv f) {
  return f.d == 1 ? e : static_cast<int>(__umulhi(static_cast<uint32_t>(e), f.m));
}

struct Im2colPlan {
  int B, C, H, W, G, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, K_pad;
  int cg, khw;          // channels a group, taps a channel
  int toh, tow, cc;     // output rows, columns and channels a block (tow < OW: toh = 1)
  int row_tiles, col_tiles, chunks;
  int Wc;               // staged columns (channels first)
  int vec;              // channels last: 4 when a lane loads 4 positions at once, else 1
  FastDiv fd_tow, fd_wc, fd_khw, fd_kw;
};

__device__ __forceinline__ int8_t quantize(int8_t v, float) { return v; }
__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -127.f), 127.f)));
}
__device__ __forceinline__ int8_t quantize(__nv_bfloat16 v, float s) {
  return quantize(__bfloat162float(v), s);
}

// Four consecutive elements, 4 * sizeof(T)-byte aligned, in one load.
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  if (sizeof(T) == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
    v[0] = e[0], v[1] = e[1], v[2] = e[2], v[3] = e[3];
  } else if (sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
    v[0] = e[0], v[1] = e[1], v[2] = e[2], v[3] = e[3];
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
    v[0] = e[0], v[1] = e[1], v[2] = e[2], v[3] = e[3];
  }
}

// CL: channels last (1x1 kernels), else channels first.
template <typename T, bool CL>
__global__ void __launch_bounds__(IM2COL_THREADS)
int8_im2col_kernel(const T* __restrict__ x, int8_t* __restrict__ out,
                   const float* __restrict__ scale, Im2colPlan q) {
  extern __shared__ __align__(16) int8_t sx[];
  int bid = blockIdx.x;
  const int chunk = bid % q.chunks;
  bid /= q.chunks;
  const int g = bid % q.G;
  bid /= q.G;
  const int ct = bid % q.col_tiles;
  bid /= q.col_tiles;
  const int rt = bid % q.row_tiles;
  const int b = bid / q.row_tiles;
  const int oh0 = rt * q.toh, ow0 = ct * q.tow;
  const int toh = min(q.toh, q.OH - oh0);
  const int tow = min(q.tow, q.OW - ow0);
  const int cl0 = chunk * q.cc;                 // first channel of the chunk in its group
  const int ncl = min(q.cc, q.cg - cl0);        // its channels
  const bool last = cl0 + ncl == q.cg;
  const int k0 = cl0 * q.khw;                   // its first k
  const int seg = last ? q.K_pad - k0 : ncl * q.khw;  // bytes of a patch row it writes
  const float s = scale != nullptr ? *scale : 1.f;
  const T* xb = x + (static_cast<long long>(b) * q.C + g * q.cg + cl0) * q.H * q.W;
  // the block's positions, (ohl, owl) = divmod(pos, q.tow), are consecutive
  // patch rows: its rows are whole (tow = OW) or it has one (toh = 1)
  const int npos = toh * tow;
  int8_t* ob = out + (static_cast<long long>(g) * q.B * q.OH * q.OW +
                      (static_cast<long long>(b) * q.OH + oh0) * q.OW + ow0) * q.K_pad + k0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (CL) {
    // [position][channel], a row of seg + 4 bytes (4-byte aligned, and an
    // odd number of words, so the transposing byte writes of a warp fall in
    // distinct banks); channels past ncl are the row's zeros. With vec = 4
    // (stride 1, no padding, W a multiple of 4) a lane loads four
    // consecutive positions of a channel at once.
    const int ld = seg + 4;
    const int nq = npos / q.vec;  // loads a channel
    const FastDiv fd_nq = fast_div(nq);
    for (int e = tid; e < seg * nq; e += IM2COL_THREADS) {
      const int c = divide(e, fd_nq);
      const int pos = (e - c * nq) * q.vec;
      const int ohl = divide(pos, q.fd_tow);
      const int owl = pos - ohl * q.tow;
      const int ih = (oh0 + ohl) * q.sh - q.ph, iw = (ow0 + owl) * q.sw - q.pw;
      int8_t* dst = sx + pos * ld + c;
      if (q.vec == 4) {
        T v[4];
        if (c < ncl) load4(xb + (static_cast<long long>(c) * q.H + ih) * q.W + iw, v);
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[u * ld] = c < ncl ? quantize(v[u], s) : static_cast<int8_t>(0);
      } else {
        int8_t v = 0;
        if (c < ncl && ih >= 0 && ih < q.H && iw >= 0 && iw < q.W)
          v = quantize(xb[(static_cast<long long>(c) * q.H + ih) * q.W + iw], s);
        *dst = v;
      }
    }
    __syncthreads();
    const int nch = seg / 16;
    const FastDiv fd_nch = fast_div(nch);
    for (int e = tid; e < npos * nch; e += IM2COL_THREADS) {
      const int pos = divide(e, fd_nch);
      const int j = e - pos * nch;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(sx + pos * ld + 16 * j);
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(pos) * q.K_pad + 16 * j) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  } else {
    // [channel][row][column] over the window: row r is input row ih0 + r *
    // rstep, column c is input column iw0 + c. One output row needs only
    // its taps' KH rows (rstep = dh); more need every row between.
    const bool one_row = toh == 1;
    const int R = one_row ? q.KH : (toh - 1) * q.sh + (q.KH - 1) * q.dh + 1;
    const int rstep = one_row ? q.dh : 1;
    const int plane = R * q.Wc;
    const FastDiv fd_plane = fast_div(plane);
    const int ih0 = oh0 * q.sh - q.ph, iw0 = ow0 * q.sw - q.pw;
    const int total = ncl * plane;
    for (int e0 = tid; e0 < total; e0 += IM2COL_BATCH * IM2COL_THREADS) {
      T v[IM2COL_BATCH];
      int dst[IM2COL_BATCH];
      bool in[IM2COL_BATCH];
#pragma unroll
      for (int u = 0; u < IM2COL_BATCH; ++u) {  // the loads first, all in flight
        const int e = e0 + u * IM2COL_THREADS;
        const int c = divide(e, fd_plane);
        const int rem = e - c * plane;
        const int r = divide(rem, q.fd_wc);
        const int col = rem - r * q.Wc;
        const int ih = ih0 + r * rstep, iw = iw0 + col;
        dst[u] = e < total ? e : -1;
        in[u] = e < total && ih >= 0 && ih < q.H && iw >= 0 && iw < q.W;
        if (in[u]) v[u] = xb[(static_cast<long long>(c) * q.H + ih) * q.W + iw];
      }
#pragma unroll
      for (int u = 0; u < IM2COL_BATCH; ++u)
        if (dst[u] >= 0) sx[dst[u]] = in[u] ? quantize(v[u], s) : static_cast<int8_t>(0);
    }
    // tap (c, kh, kw) of k = k0 + i: its offset from an output position's
    // corner of the window, sx[c][ohl*sh + kh*dh / rstep][owl*sw + kw*dw];
    // -1 (a zero) for k past the chunk's channels
    int* tap = reinterpret_cast<int*>(sx + ((ncl * plane + 15) & ~15));
    int8_t* rows = reinterpret_cast<int8_t*>(tap + ((seg + 3) & ~3)) + warp * 32 * IM2COL_ROW;
    for (int i = tid; i < seg; i += IM2COL_THREADS) {
      const int c = divide(i, q.fd_khw), rr = i - c * q.khw;
      const int kh = divide(rr, q.fd_kw), kw = rr - kh * q.KW;
      tap[i] = c < ncl ? c * plane + kh * (q.dh / rstep) * q.Wc + kw * q.dw : -1;
    }
    __syncthreads();
    // a warp takes 32 consecutive positions, a lane a position, and RUN
    // chunks of their rows at a time: the lanes' reads of a tap fall on
    // consecutive columns; then the warp writes the 32 runs of 16 RUN bytes
    const int nch = seg / 16;
    const int runs = (nch + IM2COL_RUN - 1) / IM2COL_RUN;
    const FastDiv fd_runs = fast_div(runs);
    const int groups = (npos + 31) / 32;
    for (int it = warp; it < groups * runs; it += IM2COL_WARPS) {
      const int pg = divide(it, fd_runs), j0 = (it - pg * runs) * IM2COL_RUN;
      const int pos = pg * 32 + lane;
      const int nj = min(IM2COL_RUN, nch - j0);
      if (pos < npos) {
        const int ohl = divide(pos, q.fd_tow), owl = pos - ohl * q.tow;
        const int8_t* corner = sx + ohl * q.sh * q.Wc + owl * q.sw;
        for (int j = 0; j < nj; ++j) {
          const int4* tp = reinterpret_cast<const int4*>(tap + 16 * (j0 + j));
          uint32_t v[4];
#pragma unroll
          for (int w4 = 0; w4 < 4; ++w4) {
            const int4 o = tp[w4];
            const uint32_t b0 = o.x < 0 ? 0u : static_cast<uint8_t>(corner[o.x]);
            const uint32_t b1 = o.y < 0 ? 0u : static_cast<uint8_t>(corner[o.y]);
            const uint32_t b2 = o.z < 0 ? 0u : static_cast<uint8_t>(corner[o.z]);
            const uint32_t b3 = o.w < 0 ? 0u : static_cast<uint8_t>(corner[o.w]);
            v[w4] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
          }
          *reinterpret_cast<uint4*>(rows + lane * IM2COL_ROW + 16 * j) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
      __syncwarp();
      const int live = min(32, npos - pg * 32);
      for (int e = lane; e < live * nj; e += 32) {
        const int r = e / nj, j = e - r * nj;  // nj <= 4: a short division
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(pg * 32 + r) * q.K_pad +
                                  16 * (j0 + j)) =
            *reinterpret_cast<const uint4*>(rows + r * IM2COL_ROW + 16 * j);
      }
      __syncwarp();
    }
  }
}

// Bytes a block of the plan stages. Channels last: a position's row is its
// segment (at most the chunk's channels and 32, or K_pad) and 4 bytes
// more. Channels first: the window's channel planes, the tap table (an int
// a k of the segment) and the warps' gathered rows.
long long im2col_smem(const Im2colPlan& q, bool cl) {
  const long long kmax = q.K_pad < q.cc * q.khw + 32 ? q.K_pad : q.cc * q.khw + 32;
  if (cl) return static_cast<long long>(q.toh) * q.tow * (kmax + 4);
  const long long rows = q.toh == 1 ? q.KH : (q.toh - 1LL) * q.sh + (q.KH - 1LL) * q.dh + 1;
  return ((q.cc * rows * q.Wc + 15) & ~15LL) + 4 * ((kmax + 3) & ~3LL) + IM2COL_OUT_STAGE;
}

// Every e / d the kernel takes by FastDiv is exact for this plan.
bool im2col_divisions_exact(const Im2colPlan& q, bool cl) {
  auto ok = [](long long e, long long d) { return d <= 1 || (e + 256) * d < (1LL << 32); };
  const long long kmax = q.K_pad < q.cc * q.khw + 32 ? q.K_pad : q.cc * q.khw + 32;
  const long long npos = static_cast<long long>(q.toh) * q.tow;
  const long long nch = kmax / 16;  // the most a segment has
  if (cl) return ok(kmax * npos, npos) && ok(npos, q.tow) && ok(npos * nch, nch);
  const long long rows = q.toh == 1 ? q.KH : (q.toh - 1LL) * q.sh + (q.KH - 1LL) * q.dh + 1;
  const long long plane = rows * q.Wc, runs = (nch + IM2COL_RUN - 1) / IM2COL_RUN;
  return ok(q.cc * plane + IM2COL_BATCH * IM2COL_THREADS, plane) && ok(plane, q.Wc) &&
         ok(kmax, q.khw) && ok(q.khw, q.KW) && ok((npos + 31) / 32 * runs, runs) &&
         ok(npos, q.tow);
}

void set_tiles(Im2colPlan& q, int toh, int tow, int cc) {
  q.row_tiles = (q.OH + toh - 1) / toh;
  q.toh = toh;
  q.col_tiles = (q.OW + tow - 1) / tow;
  q.tow = tow;
  q.Wc = (q.tow - 1) * q.sw + (q.KW - 1) * q.dw + 1;
  q.cc = cc;
  q.chunks = (q.cg + q.cc - 1) / q.cc;
}

// Output rows and channels a block: chunks of up to 64 channels (a
// multiple of 16, so that every chunk's segment starts on a 16-byte
// boundary); rows as many as keep the staged window within the budget,
// then fewer until the grid has two blocks an SM. Where one output row's
// window is still more than a block may stage (a wide or much dilated
// map), a block takes one row, then fewer channels (down to 16), then
// part of the row.
bool plan_im2col(Im2colPlan& q, int sms, bool aligned16) {
  const bool cl = q.KH == 1 && q.KW == 1;
  const int cc = q.cg <= IM2COL_CHUNK ? q.cg : IM2COL_CHUNK;
  set_tiles(q, q.OH, q.OW, cc);
  while (q.toh > 1 && im2col_smem(q, cl) - (cl ? 0 : IM2COL_OUT_STAGE) > IM2COL_BUDGET)
    set_tiles(q, (q.toh + 1) / 2, q.OW, cc);
  const long long per_row = static_cast<long long>(q.B) * q.G * q.chunks;
  while (q.toh > 1 && per_row * q.row_tiles < 2LL * sms) set_tiles(q, (q.toh + 1) / 2, q.OW, cc);
  set_tiles(q, (q.OH + q.row_tiles - 1) / q.row_tiles, q.OW, cc);  // the rows spread evenly
  auto fits = [&] {
    return im2col_smem(q, cl) <= IM2COL_SMEM_MAX && im2col_divisions_exact(q, cl);
  };
  if (!fits()) set_tiles(q, 1, q.OW, cc);
  while (!fits() && ((q.cc / 2 + 15) & ~15) < q.cc) set_tiles(q, 1, q.OW, (q.cc / 2 + 15) & ~15);
  while (!fits() && q.tow > 1) {
    const int tow = (q.tow + 1) / 2;
    set_tiles(q, 1, tow > 4 ? (tow + 3) & ~3 : tow, q.cc);
  }
  // four positions a load: a stride-1 unpadded 1x1 over rows of a multiple
  // of 4 elements (so four positions never straddle a row or a tile) from
  // an aligned base
  q.vec = cl && q.sw == 1 && q.sh == 1 && q.pw == 0 && q.ph == 0 && q.W % 4 == 0 &&
                  q.tow % 4 == 0 && aligned16
              ? 4 : 1;
  q.fd_tow = fast_div(q.tow);
  q.fd_wc = fast_div(q.Wc);
  q.fd_khw = fast_div(q.khw);
  q.fd_kw = fast_div(q.KW);
  return fits() &&
         static_cast<long long>(q.B) * q.G * q.chunks * q.row_tiles * q.col_tiles < (1LL << 31);
}

template <typename T, bool CL>
cudaError_t launch_im2col(const void* x, void* out, const float* scale, const Im2colPlan& q,
                          cudaStream_t st) {
  const int smem = static_cast<int>(im2col_smem(q, CL));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_im2col_kernel<T, CL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long blocks =
      static_cast<long long>(q.B) * q.row_tiles * q.col_tiles * q.G * q.chunks;
  int8_im2col_kernel<T, CL><<<static_cast<unsigned>(blocks), IM2COL_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(out), scale, q);
  return cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess)
      sms = n;
    else
      return 132;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// The product on wgmma, fed by TMA

constexpr int WG_BM = 128;  // rows a tile, as two halves of 64 (one wgmma each)
constexpr int WG_BK = 128;  // bytes of K a stage: one 128-byte swizzled row
constexpr int WG_CONSUMERS = 2;
constexpr int WG_THREADS = 128 * WG_CONSUMERS + 32;  // and one producer warp
constexpr int WG_EPI_LD = 64 + 4;  // floats a staged channel row: 4 words over 64, so the
                                   // fragment writes of a warp fall in distinct banks

template <int BN>
struct WgCfg {
  static constexpr int STAGES = BN == 128 ? 4 : 6;
  static constexpr int A_BYTES = WG_BM * WG_BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * WG_BK;
  // a consumer's staging of 64 scaled rows ([channel][row]), then its
  // tile's channel scales and biases
  static constexpr int EPI_FLOATS = BN * WG_EPI_LD + 2 * BN;
  static constexpr int EPI_BYTES = WG_CONSUMERS * EPI_FLOATS * 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + (2 * STAGES + 2) * 8 + 16;
};

// The epilogue of 64 rows from m0 (their s32 accumulator fragments `acc`)
// by warpgroup wg: scaled into shared memory as [channel][row], then out:
// NCHW rows in runs along the positions (a lane a row, each lane's image
// and position its own, so a run that crosses an image boundary splits
// there), or (M, G*N) rows along the channels for P = 1.
template <int BN, typename OutT>
__device__ __forceinline__ void epilogue_rows(const int (&acc)[BN / 2], float* sc,
                                              const float* s_scale, const float* s_bias,
                                              bool has_bias, OutT* __restrict__ out, int m0,
                                              int M, int n0, int N, int ng0, int n_total, int P,
                                              int wg, int t) {
  const int warp = t / 32, lane = t % 32;
  named_sync(1 + wg, 128);  // the rows staged before are read; the scales are written
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * (lane & 3) + e;
      const float scl = s_scale[col], bs = s_bias[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), scl);
        if (has_bias) v = __fadd_rn(v, bs);
        sc[col * WG_EPI_LD + 16 * warp + (lane >> 2) + 8 * h] = v;
      }
    }
  named_sync(1 + wg, 128);
  const int cols = min(BN, N - n0);
  if (P > 1) {
    const int r = t & 63, m = m0 + r;
    if (m < M) {
      const int b = m / P, p = m - b * P;
      OutT* o = out + (static_cast<long long>(b) * n_total + ng0) * P + p;
#pragma unroll 4
      for (int c = t >> 6; c < cols; c += 2)
        o[static_cast<long long>(c) * P] = from_f32<OutT>(sc[c * WG_EPI_LD + r]);
    }
  } else if (t < cols) {
    const int rows = min(64, M - m0);
    OutT* o = out + static_cast<long long>(m0) * n_total + ng0 + t;
    for (int r = 0; r < rows; ++r)
      o[static_cast<long long>(r) * n_total] = from_f32<OutT>(sc[t * WG_EPI_LD + r]);
  }
}

// One warpgroup's pass over K slices [kb0, kb1) of the ring (stage and
// phase advanced past them): HALVES 64-row halves of A (the first at half
// h0 into acc0, the second, rows 64-127, into acc1) times the W slice,
// keeping one slice's MMAs in flight and releasing each stage when its MMAs
// are done. HALVES = 0 waits for each slice and releases it unread. The
// count is a template argument so that no branch separates the MMAs
// (ptxas serialises wgmma across one).
template <int BN, int STAGES, int STAGE_BYTES, int A_BYTES, int HALVES>
__device__ __forceinline__ void consume_slices(int (&acc0)[BN / 2], int (&acc1)[BN / 2],
                                               uint32_t stage0, uint32_t full0, uint32_t empty0,
                                               int& stage, uint32_t& phase, int kb0, int kb1,
                                               int h0, int t) {
  int prev = -1;
  for (int k = kb0; k < kb1; ++k) {
    mbar_wait(full0 + 8 * stage, phase);
    if (HALVES == 0) {
      if (t == 0) mbar_arrive(empty0 + 8 * stage);
    } else {
      const uint32_t sa = stage0 + stage * STAGE_BYTES;
      const uint32_t sw = sa + A_BYTES;
      wgmma_fence_regs(acc0);
      if (HALVES == 2) wgmma_fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 32; ++kk) {
        const int keep = (k > kb0 || kk > 0) ? 1 : 0;
        const uint64_t dw = sw128_desc(sw + 32 * kk);
        wgmma_s8<BN>(acc0, sw128_desc(sa + h0 * 64 * WG_BK + 32 * kk), dw, keep);
        if (HALVES == 2) wgmma_s8<BN>(acc1, sw128_desc(sa + 64 * WG_BK + 32 * kk), dw, keep);
      }
      wgmma_commit();
      wgmma_fence_regs(acc0);
      if (HALVES == 2) wgmma_fence_regs(acc1);
      if (prev >= 0) {  // the previous slice's MMAs are done: release its stage
        wgmma_wait<1>();
        wgmma_fence_regs(acc0);
        if (HALVES == 2) wgmma_fence_regs(acc1);
        if (t == 0) mbar_arrive(empty0 + 8 * prev);
      }
    }
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (HALVES > 0 && prev >= 0) {
    wgmma_wait<0>();
    wgmma_fence_regs(acc0);
    if (HALVES == 2) wgmma_fence_regs(acc1);
    if (t == 0) mbar_arrive(empty0 + 8 * prev);
  }
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w, OutT* __restrict__ out,
                       const float* __restrict__ dscale, const float* __restrict__ ws,
                       const float* __restrict__ bias, int* __restrict__ partial,
                       int* __restrict__ counters, int M, int N, int K, int G, int P,
                       int splits) {
  using Cfg = WgCfg<BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // stages 1024-byte aligned (the 128-byte swizzle's period)
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* epi = reinterpret_cast<float*>(smem + STAGES * Cfg::STAGE_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + STAGES * Cfg::STAGE_BYTES + Cfg::EPI_BYTES);
  int* last_flag = reinterpret_cast<int*>(bars + 2 * STAGES + 2);
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + STAGES);
  const uint32_t turn0 = smem_u32(bars + 2 * STAGES);  // a consumer's turn at the ring

  const int tid = threadIdx.x;
  const int mt = (M + WG_BM - 1) / WG_BM, nt = (N + BN - 1) / BN;
  const int kb = (K + WG_BK - 1) / WG_BK;
  const int items = G * mt * nt * splits;
  const bool turn_based = items > static_cast<int>(gridDim.x);  // some block has two items
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, turn_based ? 1 : WG_CONSUMERS);
    }
    mbar_init(turn0, 1);
    mbar_init(turn0 + 8, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // roles by warp, broadcast from lane 0 so that the compiler sees them
  // warp-uniform (a branch it takes for divergent makes ptxas serialise
  // the wgmma instructions under it)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  // item = tile * splits + split; tile = (g * mt + mi) * nt + ni
  if (warp >= 4 * WG_CONSUMERS) {
    if (tid == 128 * WG_CONSUMERS) {  // the producer
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int sp = it % splits, tile = it / splits;
        const int ni = tile % nt, mi = tile / nt % mt, g = tile / nt / mt;
        const int kb0 = static_cast<int>(static_cast<long long>(sp) * kb / splits);
        const int kb1 = static_cast<int>(static_cast<long long>(sp + 1) * kb / splits);
        for (int k = kb0; k < kb1; ++k) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t sa = stage0 + stage * Cfg::STAGE_BYTES;
          mbar_expect_tx(full, Cfg::STAGE_BYTES);
          tma_load_3d(sa, &map_a, full, k * WG_BK, mi * WG_BM, g);
          tma_load_3d(sa + Cfg::A_BYTES, &map_w, full, k * WG_BK, ni * BN, g);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers. Where the block has one item, cooperatively: warpgroup
  // wg takes rows [64 wg, 64 wg + 64) of it. Where it has more, in turns:
  // warpgroup wg takes the items j = wg, wg + 2, ... whole (both 64-row
  // halves), so that one's epilogue runs beside the other's MMAs; their
  // mainloops take the ring in item order (each waits for the other to
  // finish the item before), so each can count the other's slices to keep
  // its place in the ring, and every wait on a stage finds it one round on
  // at most.
  const int wg = warp / 4, t = tid % 128;
  const float ds = *dscale;
  float* sc = epi + wg * Cfg::EPI_FLOATS;
  float* s_scale = sc + BN * WG_EPI_LD;
  float* s_bias = s_scale + BN;
  const int n_total = G * N;
  int acc0[BN / 2], acc1[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0;
  int stage = 0;
  uint32_t phase = 0;
  int j = 0, turns = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++j) {
    const int sp = it % splits, tile = it / splits;
    const int ni = tile % nt, mi = tile / nt % mt, g = tile / nt / mt;
    const int kb0 = static_cast<int>(static_cast<long long>(sp) * kb / splits);
    const int kb1 = static_cast<int>(static_cast<long long>(sp + 1) * kb / splits);
    if (turn_based && (j & 1) != wg) {  // the other warpgroup's item
      stage += kb1 - kb0;
      while (stage >= STAGES) {
        stage -= STAGES;
        phase ^= 1;
      }
      continue;
    }
    const int n0 = ni * BN, m0 = mi * WG_BM;
    const int h0 = turn_based ? 0 : wg;           // the first (or only) half it takes
    const bool live = m0 + 64 * h0 < M;           // that half holds rows of A
    const bool lower = turn_based && m0 + 64 < M;  // and the second half, in turns
    // the tile's channel scales, loaded before the mainloop and staged
    // after it (the epilogue reads them)
    float scl = 0.f, bsv = 0.f;
    if (t < BN && n0 + t < N) {
      scl = __fmul_rn(ds, ws[g * N + n0 + t]);
      if (bias != nullptr) bsv = bias[g * N + n0 + t];
    }
    if (turn_based && j > 0) mbar_wait(turn0 + 8 * wg, turns++ & 1);  // the item before is taken
    if (lower)
      consume_slices<BN, STAGES, Cfg::STAGE_BYTES, Cfg::A_BYTES, 2>(
          acc0, acc1, stage0, full0, empty0, stage, phase, kb0, kb1, 0, t);
    else if (live)
      consume_slices<BN, STAGES, Cfg::STAGE_BYTES, Cfg::A_BYTES, 1>(
          acc0, acc1, stage0, full0, empty0, stage, phase, kb0, kb1, h0, t);
    else
      consume_slices<BN, STAGES, Cfg::STAGE_BYTES, Cfg::A_BYTES, 0>(
          acc0, acc1, stage0, full0, empty0, stage, phase, kb0, kb1, h0, t);
    if (turn_based && t == 0) mbar_arrive(turn0 + 8 * (1 - wg));  // the other's turn
    if (t < BN) {
      s_scale[t] = scl;
      s_bias[t] = bsv;
    }
    if (!live) continue;

    if (splits > 1) {
      // this split's s32 partial halves, in fragment order (coalesced); the
      // last split of the tile (half) to arrive sums them all in split order
      int* own = partial + static_cast<long long>(it) * (WG_BM * BN) + h0 * (64 * BN);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) own[i * 128 + t] = acc0[i];
      if (lower)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) own[(BN / 2 + i) * 128 + t] = acc1[i];
      __threadfence();
      named_sync(1 + wg, 128);
      if (t == 0) {
        int* cnt = counters + 2 * tile + h0;
        const int arrived = atomicAdd(cnt, 1);
        last_flag[wg] = arrived == splits - 1;
      }
      named_sync(1 + wg, 128);
      if (!last_flag[wg]) continue;
      __threadfence();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = 0;
      for (int o = 0; o < splits; ++o) {
        const int* p =
            partial + static_cast<long long>(tile * splits + o) * (WG_BM * BN) + h0 * (64 * BN);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc0[i] += __ldcg(p + i * 128 + t);
        if (lower)
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc1[i] += __ldcg(p + (BN / 2 + i) * 128 + t);
      }
    }

    epilogue_rows<BN, OutT>(acc0, sc, s_scale, s_bias, bias != nullptr, out, m0 + 64 * h0, M,
                            n0, N, g * N + n0, n_total, P, wg, t);
    if (lower)
      epilogue_rows<BN, OutT>(acc1, sc, s_scale, s_bias, bias != nullptr, out, m0 + 64, M, n0,
                              N, g * N + n0, n_total, P, wg, t);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d map (K bytes, rows, groups) of int8 rows, ld bytes apart, groups
// gstride apart, in boxes of 128 bytes x box_rows x 1, 128-byte swizzle.
cudaError_t encode_rows(CUtensorMap* map, const void* base, int K, int rows, int G, long long ld,
                        long long gstride, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(gstride)};
  const cuuint32_t box[3] = {WG_BK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, typename OutT>
cudaError_t launch_wgmma(const CUtensorMap& ma, const CUtensorMap& mw, void* out,
                         const float* dscale, const float* ws, const float* bias, int* partial,
                         int* counters, int M, int N, int K, int G, int P, int splits,
                         cudaStream_t st) {
  using Cfg = WgCfg<BN>;
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_gemm_wgmma_kernel<BN, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const long long items = static_cast<long long>(G) * ((M + WG_BM - 1) / WG_BM) *
                          ((N + BN - 1) / BN) * splits;
  if (items >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  int8_gemm_wgmma_kernel<BN, OutT><<<grid, WG_THREADS, Cfg::SMEM, st>>>(
      ma, mw, static_cast<OutT*>(out), dscale, ws, bias, partial, counters, M, N, K, G, P,
      splits);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch_wgmma(int bn, const CUtensorMap& ma, const CUtensorMap& mw, void* out,
                           const float* dscale, const float* ws, const float* bias, int* partial,
                           int* counters, int M, int N, int K, int G, int P, int splits,
                           cudaStream_t st) {
  if (bn == 128)
    return launch_wgmma<128, OutT>(ma, mw, out, dscale, ws, bias, partial, counters, M, N, K, G,
                                   P, splits, st);
  return launch_wgmma<64, OutT>(ma, mw, out, dscale, ws, bias, partial, counters, M, N, K, G, P,
                                splits, st);
}

// ---------------------------------------------------------------------------
// The product on mma.sync: blocks of BM x BN outputs walk K in 64-byte steps
// through two shared-memory stages filled by 16-byte cp.async (rows padded
// to 80 bytes, so ldmatrix's eight row reads fall in distinct banks); warps
// take 16 x 8 x 32 mma.sync steps with fragments from ldmatrix. Tails in M,
// N and K are masked in the loads (zero fill) and the stores. Rows whose
// stride or base is not 16-byte aligned take byte loads instead of
// cp.async. 128 x 128 tiles (8 warps of 64 x 32) when they fill three
// quarters of the SMs, else 64 x 64 (4 warps of 32 x 32).

constexpr int BK = 64;        // bytes of K a stage
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int LDS16 = LDS / 2;  // the same in b16 elements (ldmatrix's view)

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
  const long long big = ((static_cast<long long>(M) + 127) / 128) * ((N + 127) / 128) * G;
  if (N > 64 && 4 * big >= 3LL * sm_count())
    return launch_gemm<128, 128, 2, 4, OutT>(vec, a, w, out, dscale, ws, bias, M, N, K, lda, ldw,
                                             a_group, w_group, G, P, st);
  return launch_gemm<64, 64, 2, 2, OutT>(vec, a, w, out, dscale, ws, bias, M, N, K, lda, ldw,
                                         a_group, w_group, G, P, st);
}

}  // namespace

// x: (B, C, H, W), contiguous, int8 (in_dtype IN_S8, scale NULL) or f32 /
// bf16 (IN_F32 / IN_BF16, scale one f32 on the device); out: (G, B*OH*OW,
// K_pad) int8, contiguous, 16-byte aligned, K_pad a multiple of 32 and >=
// C/G*KH*KW. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int mx_int8_im2col(const void* x, void* out, const void* scale, int in_dtype, int B,
                              int C, int H, int W, int G, int KH, int KW, int sh, int sw, int ph,
                              int pw, int dh, int dw, int OH, int OW, int K_pad, void* stream) {
  if (B <= 0 || C <= 0 || G <= 0 || C % G != 0 || KH <= 0 || KW <= 0 || OH <= 0 || OW <= 0 ||
      sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || ph < 0 || pw < 0 || K_pad % 32 != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 || (in_dtype == IN_S8) != (scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Im2colPlan q{B, C, H, W, G, KH, KW, sh, sw, ph, pw, dh, dw, OH, OW, K_pad};
  q.cg = C / G;
  q.khw = KH * KW;
  if (q.cg * q.khw > K_pad || static_cast<long long>(G) * B * OH * OW * K_pad >= (1LL << 46) ||
      !plan_im2col(q, sm_count(), (reinterpret_cast<uintptr_t>(x) & 15) == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cl = KH == 1 && KW == 1;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype == IN_S8)
    e = cl ? launch_im2col<int8_t, true>(x, out, s, q, st)
           : launch_im2col<int8_t, false>(x, out, s, q, st);
  else if (in_dtype == IN_F32)
    e = cl ? launch_im2col<float, true>(x, out, s, q, st)
           : launch_im2col<float, false>(x, out, s, q, st);
  else if (in_dtype == IN_BF16)
    e = cl ? launch_im2col<__nv_bfloat16, true>(x, out, s, q, st)
           : launch_im2col<__nv_bfloat16, false>(x, out, s, q, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

// The wgmma route. a: G blocks (a_group bytes apart) of (M, K) int8 rows,
// stride lda; w: G blocks (w_group apart) of (N, K) rows, stride ldw; base
// addresses, strides and group strides multiples of 16 bytes. bn: 64 or 128
// channels a tile; splits: parts of K (1 to ceil(K / 128)); for splits > 1,
// partial: G * ceil(M/128) * ceil(N/bn) * splits * 128 * bn int32 and
// counters: G * ceil(M/128) * ceil(N/bn) * 2 int32, zero, both the call's
// own (no launch in flight beside it may share them). dscale, ws, bias, out, P and dtype as mx_int8_gemm's.
extern "C" int mx_int8_gemm_wgmma(const void* a, const void* w, void* out, const void* dscale,
                                  const void* ws, const void* bias, void* partial, void* counters,
                                  int M, int N, int K, long long lda, long long ldw,
                                  long long a_group, long long w_group, int G, int P, int bn,
                                  int splits, int dtype, void* stream) {
  const int kb = (K + WG_BK - 1) / WG_BK;
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || P <= 0 || M % P != 0 || lda < K || ldw < K ||
      (bn != 64 && bn != 128) || splits < 1 || splits > kb ||
      (splits > 1 && (partial == nullptr || counters == nullptr)) || lda % 16 != 0 ||
      ldw % 16 != 0 || a_group % 16 != 0 || w_group % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(a) & 15) != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (G > 1 && (a_group < static_cast<long long>(M) * lda ||
                 w_group < static_cast<long long>(N) * ldw)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma, mw;
  cudaError_t e = encode_rows(&ma, a, K, M, G, lda, a_group, WG_BM);
  if (e == cudaSuccess) e = encode_rows(&mw, w, K, N, G, ldw, w_group, bn);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* dsp = static_cast<const float*>(dscale);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  int* pp = static_cast<int*>(partial);
  int* cp = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == MX_F32)
    e = dispatch_wgmma<float>(bn, ma, mw, out, dsp, wsp, bp, pp, cp, M, N, K, G, P, splits, st);
  else if (dtype == MX_BF16)
    e = dispatch_wgmma<__nv_bfloat16>(bn, ma, mw, out, dsp, wsp, bp, pp, cp, M, N, K, G, P,
                                      splits, st);
  else if (dtype == MX_F16)
    e = dispatch_wgmma<__half>(bn, ma, mw, out, dsp, wsp, bp, pp, cp, M, N, K, G, P, splits, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

// The mma.sync route. a: G blocks (a_group bytes apart) of (M, K) int8
// rows, stride lda; w: G blocks (w_group apart) of (N, K) rows, stride ldw;
// dscale: one f32 on the device; ws: (G*N,) f32; bias: (G*N,) f32 or NULL;
// out: f32, bf16 or f16 (dtype code of common.cuh), (M / P, G*N, P) for P >
// 1 (NCHW), (M, G*N) for P = 1. Returns cudaGetLastError().
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

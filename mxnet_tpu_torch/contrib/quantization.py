"""INT8 post-training quantization: the port of
``mxnet_tpu/contrib/quantization.py`` (reference:
``python/mxnet/contrib/quantization.py`` + ``src/operator/quantization/``).

The calibration (min-max or KL-divergence over a calibration set) is the
JAX package's numpy code. Two execution modes, as there:

  - *simulated* (``quantize_net``): int8-grid values stored dequantized in
    the model dtype;
  - *real int8* (``quantized_fully_connected`` / ``quantized_conv``
    registry ops + ``convert_to_int8``): s8 x s8 products with s32
    accumulation and one f32 requantisation scale, on the card by the
    hand-written kernels of ``csrc/int8_gemm.cu``: for a convolution an
    im2col launch, which also quantises a float activation, then the
    tensor-core product with the requantisation in its epilogue, written
    NCHW. The product has two routes (:func:`gemm_plan`): ``wgmma`` fed by
    TMA where every row stride and base is a multiple of 16 bytes, else
    ``mma.sync``. PyTorch on the card has no integer matmul or convolution
    that takes these shapes (``torch._int_mm`` needs M > 16 and K, N
    multiples of 8).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (the patches by ``F.unfold`` and the product by a ``matmul``, both
in float64, exact for these integers, rounded to int32) only for CPU
tensors. The epilogue is JAX's, in JAX's order:
``acc.astype(f32) * (data_scale * ws)``, then ``+ bias``, then the cast.
Activations are quantized as ``round(x / scale)`` with the divisor a
device tensor (a CUDA tensor divided by a host scalar is multiplied by its
reciprocal, which moves values at the rounding edges); ``torch.round``
rounds half to even, as ``jnp.round``, and the im2col kernel's
``rintf(__fdiv_rn(x, scale))`` is the same.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..analysis import audit as _audit
from ..base import MXNetError, dtype_torch
from ..ops import cuda_common as _cc
from ..registry import register

__all__ = ["quantize_array", "dequantize_array", "calib_minmax", "calib_entropy",
           "quantize_net", "quantized_fully_connected", "quantized_conv",
           "convert_to_int8", "QuantizedDense", "QuantizedConv2D",
           "int8_im2col", "int8_im2col_plain", "int8_gemm", "int8_gemm_plain",
           "gemm_plan"]

#: kernel launches since the last reset (read by chip_smoke.py):
#: ``int8_gemm`` counts the products of both routes, ``int8_gemm_wgmma``
#: and ``int8_gemm_mma`` each route's
launches = {"int8_gemm": 0, "int8_gemm_wgmma": 0, "int8_gemm_mma": 0,
            "int8_im2col": 0}


def _raw(x):
    """The tensor of an NDArray, tensor or host array."""
    if hasattr(x, "_data") and torch.is_tensor(x._data):
        return x._data
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _f32(v, device):
    """``v`` (a number, array, NDArray or tensor) as an f32 tensor on
    ``device``; a number rounded to f32 once (as ``jnp.asarray(v,
    float32)``) and made there by a fill, with no copy from the host."""
    if isinstance(v, (int, float, np.floating, np.integer)):
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return _raw(v).to(device=device, dtype=torch.float32)


def _scalar(v, device):
    """``v`` as a 0-d f32 tensor on ``device`` (a true divisor there)."""
    return _f32(v, device).reshape(())


def quantize_array(x, scale=None, axis=None):
    """f32 -> (int8, scale). Per-channel when axis is given."""
    xf = _raw(x).to(torch.float32)
    if scale is None:
        dims = tuple(i for i in range(xf.dim()) if i != axis) \
            if axis is not None else None
        a = xf.abs()
        amax = a.amax() if dims is None else (a.amax(dim=dims, keepdim=True)
                                              if dims else a)
        scale = amax / _scalar(127.0, xf.device) + 1e-12
    q = torch.clamp(torch.round(xf / _f32(scale, xf.device)), -127, 127) \
        .to(torch.int8)
    return q, scale


def dequantize_array(q, scale, dtype="bfloat16"):
    q = _raw(q)
    return (q.to(torch.float32) * _f32(scale, q.device)).to(dtype_torch(dtype))


def calib_minmax(samples):
    """Min-max calibration: scale from the absolute max over samples."""
    amax = max(float(np.abs(np.asarray(s)).max()) for s in samples)
    return amax / 127.0 + 1e-12


def calib_entropy(samples, num_bins=2048, num_quantized_bins=255):
    """KL-divergence (entropy) calibration, the JAX package's algorithm.

    The KL is taken between the FULL histogram and the clip-then-quantize
    approximation expanded back over all bins, so clipped tail mass piled
    into the threshold bin is penalized wherever the true distribution
    extends past the threshold (bounded tanh-like activations keep ~amax;
    long-tail relu-like ones clip their outliers)."""
    data = np.abs(np.concatenate([np.asarray(s).ravel() for s in samples]))
    amax = float(data.max()) + 1e-12
    hist, edges = np.histogram(data, bins=num_bins, range=(0, amax))
    p_full = hist.astype(np.float64)
    total = p_full.sum()
    if total == 0:
        return amax / 127.0
    p_full /= total
    eps = 1e-10
    best_kl, best_t = np.inf, amax
    for i in range(num_quantized_bins, num_bins + 1, num_bins // 64 or 1):
        t = edges[i] if i < len(edges) else amax
        # clip: tail mass lands in the threshold bin
        clipped = p_full[:i].copy()
        clipped[-1] += p_full[i:].sum()
        # quantize the clipped range into num_quantized_bins levels
        factor = max(1, i // num_quantized_bins)
        q = np.zeros(i)
        for j in range(0, i, factor):
            chunk = clipped[j:j + factor]
            nz = int((chunk > 0).sum())
            if nz:
                q[j:j + factor] = np.where(chunk > 0, chunk.sum() / nz, 0.0)
        q_full = np.concatenate([q, np.zeros(num_bins - i)])
        q_full = q_full / max(q_full.sum(), eps)
        pe = p_full + eps
        qe = q_full + eps
        kl = float(np.sum(pe * np.log(pe / qe)))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return best_t / 127.0


# --------------------------------------------------------------------------
# the kernels (csrc/int8_gemm.cu) and their plain versions
# --------------------------------------------------------------------------
def _pair(v):
    return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * 2


def k_padded(k):
    """K rounded up to 32, one s8 mma step: the im2col's row length and the
    converted layers' padded weight rows."""
    return (int(k) + 31) // 32 * 32


def _out_hw(h, w, kernel, stride, pad, dilate):
    oh = (h + 2 * pad[0] - dilate[0] * (kernel[0] - 1) - 1) // stride[0] + 1
    ow = (w + 2 * pad[1] - dilate[1] * (kernel[1] - 1) - 1) // stride[1] + 1
    return oh, ow


def _check_int8(name, t, dev):
    if t.dtype != torch.int8 or t.device != dev or not t.is_contiguous():
        raise MXNetError(f"int8 kernels: {name} must be a contiguous int8 "
                         f"tensor on {dev}, got {t.dtype} on {t.device}")


def _quantize(x, scale):
    """``clamp(round(x / scale), -127, 127)`` as int8, x taken to f32 first
    and ``scale`` a device divisor: ``_QuantizedLayer``'s quantisation (and
    JAX's ``jnp.clip(jnp.round(xf / a_scale), -127, 127)``)."""
    xf = x.to(torch.float32)
    return torch.clamp(torch.round(xf / _scalar(scale, xf.device)), -127,
                       127).to(torch.int8)


def int8_im2col_plain(xq, kernel, stride, pad, dilate, groups, k_pad):
    """Plain version of ``int8_im2col_kernel`` on an int8 input:
    ``F.unfold`` of the NCHW input in float64 as (G, B*OH*OW, k_pad) int8,
    zero past K."""
    b, c = xq.shape[:2]
    kh, kw = kernel
    k = c // groups * kh * kw
    cols = F.unfold(xq.to(torch.float64), (kh, kw), dilation=dilate,
                    padding=pad, stride=stride)             # (B, C*KH*KW, L)
    cols = cols.reshape(b, groups, k, -1).permute(1, 0, 3, 2)  # (G, B, L, K)
    out = torch.zeros((groups, b * cols.shape[2], k_pad), dtype=torch.int8,
                      device=xq.device)
    out[:, :, :k] = cols.reshape(groups, -1, k).to(torch.int8)
    return out


# input dtype codes of mx_int8_im2col
_IM2COL_IN = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}


def int8_im2col(x, kernel, stride, pad, dilate, groups, k_pad, scale=None):
    """The s8 patches of an NCHW activation, (G, B*OH*OW, k_pad) int8: of
    an int8 ``x`` as it is (no ``scale``), or of an f32 or bf16 ``x``
    quantised with the activation ``scale`` as ``_QuantizedLayer`` does.
    The kernel for a CUDA tensor, the plain version (the quantisation,
    then ``int8_im2col_plain``) for a CPU tensor."""
    kernel, stride, pad, dilate = map(_pair, (kernel, stride, pad, dilate))
    if x.dtype == torch.int8:
        if scale is not None:
            raise MXNetError("int8_im2col: an int8 input is quantised "
                             "already and takes no scale")
    elif x.dtype in (torch.float32, torch.bfloat16):
        if scale is None:
            raise MXNetError(f"int8_im2col: a {x.dtype} input needs the "
                             f"activation scale")
    else:
        raise MXNetError(f"int8_im2col: input must be int8, float32 or "
                         f"bfloat16, got {x.dtype}")
    if _audit.recording():
        b, _, h, w = x.shape
        oh, ow = _out_hw(h, w, kernel, stride, pad, dilate)
        ins = [x] + ([scale] if torch.is_tensor(scale) else [])
        return _audit.record_kernel(
            (__name__, "int8_im2col"), "int8_im2col_kernel", ins,
            [((groups, b * oh * ow, k_pad), torch.int8)])[0]
    if x.device.type == "cpu":
        xq = x if scale is None else _quantize(x, scale)
        return int8_im2col_plain(xq, kernel, stride, pad, dilate, groups,
                                 k_pad)
    _cc.check_device(x)
    if not x.is_contiguous():
        raise MXNetError("int8_im2col: the input must be contiguous")
    b, c, h, w = x.shape
    oh, ow = _out_hw(h, w, kernel, stride, pad, dilate)
    if c % groups or oh <= 0 or ow <= 0 or k_pad % 32 \
            or c // groups * kernel[0] * kernel[1] > k_pad:
        raise MXNetError(f"int8_im2col: bad shape {tuple(x.shape)} for "
                         f"kernel {kernel}, groups {groups}, k_pad {k_pad}")
    s = None if scale is None else _scalar(scale, x.device).contiguous()
    out = torch.empty((groups, b * oh * ow, k_pad), dtype=torch.int8,
                      device=x.device)
    lib = _cc.load("int8_gemm")
    rc = lib.mx_int8_im2col(x.data_ptr(), out.data_ptr(),
                            None if s is None else s.data_ptr(),
                            _IM2COL_IN[x.dtype], b, c, h, w, groups,
                            kernel[0], kernel[1], stride[0], stride[1],
                            pad[0], pad[1], dilate[0], dilate[1], oh, ow,
                            k_pad, _cc.stream_ptr(x.device))
    _cc.check_launch(lib, rc, "int8_im2col")
    launches["int8_im2col"] += 1
    return out


def _requant(acc, ds, ws, bias, out_dtype):
    """JAX's epilogue on an int32 accumulator whose channel axis is last:
    ``acc.astype(f32) * (data_scale * ws)``, ``+ bias``, the cast."""
    out = acc.to(torch.float32) * (ds * ws)
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _to_nchw(out, positions):
    """(M, N) rows m = (b, p) as (B, N, P) for P = ``positions`` > 1."""
    if positions == 1:
        return out
    m, n = out.shape
    return out.reshape(m // positions, positions, n).permute(0, 2, 1) \
        .contiguous()


def int8_gemm_plain(a, w, k, data_scale, ws, bias=None, out_dtype="float32",
                    groups=1, positions=1):
    """Plain version of ``int8_gemm_kernel``: the groups' products over the
    first ``k`` columns as a float64 ``matmul`` rounded to int32, then
    JAX's epilogue, (M, G*N), or (M / P, G*N, P) for ``positions`` P > 1."""
    g = groups
    m = a.numel() // (g * a.shape[-1])
    a3 = a.reshape(g, m, a.shape[-1])[..., :k].to(torch.float64)
    w3 = w.reshape(g, -1, w.shape[-1])[..., :k].to(torch.float64)
    acc = torch.matmul(a3, w3.transpose(1, 2)).round().to(torch.int32)
    acc = acc.permute(1, 0, 2).reshape(m, -1)                  # (M, G*N)
    dev = a.device
    ds = _scalar(data_scale, dev)
    ws = _channel_scales(ws, acc.shape[1], dev)
    bias = None if bias is None else bias.to(torch.float32)
    return _to_nchw(_requant(acc, ds, ws, bias, dtype_torch(out_dtype)),
                    positions)


def _channel_scales(ws, n, dev):
    ws = _f32(ws, dev).reshape(-1)
    return ws.expand(n).contiguous() if ws.numel() == 1 else ws.contiguous()


# the wgmma route's tile: 128 rows, 128 bytes of K a stage
GEMM_BM, GEMM_BK = 128, 128
GEMM_MAX_SPLITS = 4


def gemm_plan(m, n, k, groups, lda, ldw, aligned, sms):
    """The product's route for these operands, ``(route, tile width,
    splits of K)``. ``wgmma`` (TMA loads) when both row strides are
    multiples of 16 bytes and ``aligned`` (both bases are): tiles 128
    channels wide where N > 64 and those tiles give half the ``sms`` SMs
    one each, else 64 wide (more tiles, less shared-memory traffic a
    slice); K split into at most GEMM_MAX_SPLITS parts, the count that
    finishes soonest: waves of (tile, part) items times the 128-byte K
    slices of a part, and, once K is split, four slices more for writing
    and summing the s32 partial tiles; the fewest parts on a tie. Else
    ``mma`` (mma.sync with cp.async or byte loads), which picks its own
    tiles, unsplit."""
    if lda % 16 or ldw % 16 or not aligned:
        return "mma", 0, 1
    m_tiles = groups * -(-m // GEMM_BM)
    bn = 128 if n > 64 and 2 * m_tiles * -(-n // 128) >= sms else 64
    tiles = m_tiles * -(-n // bn)
    slices = -(-k // GEMM_BK)

    def cost(s):
        return -(-tiles * s // sms) * (-(-slices // s) + (4 if s > 1 else 0))

    return "wgmma", bn, min(range(1, min(slices, GEMM_MAX_SPLITS) + 1),
                            key=cost)


_sms = {}  # device -> its SM count


def _sm_count(dev):
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count  # lint: disable=JH005 -- a memo of a constant
    return _sms[dev]


def int8_gemm(a, w, k, data_scale, ws, bias=None, out_dtype="float32",
              groups=1, positions=1):
    """``C[m, n] = sum_{j < k} a[m, j] w[n, j]`` per group in s32, then
    JAX's requantisation: the kernel for CUDA tensors, the plain version
    for CPU tensors. ``a``: (G, M, lda) or (M, lda) int8, ``w``: (G*N,
    ldw) int8 (rows past ``k`` ignored), ``data_scale`` a scalar,
    ``ws`` (G*N,) or one value, ``bias`` (G*N,) or None. Returns (M, G*N),
    or NCHW (M / P, G*N, P) for ``positions`` P > 1. The route, tile and
    split are :func:`gemm_plan`'s."""
    return _int8_gemm(a, w, k, data_scale, ws, bias, out_dtype, groups,
                      positions, None)


def _record_gemm(a, w, k, data_scale, ws, bias, out_dtype, groups, positions,
                 plan):
    """The product's record (``analysis.audit``) on the route gemm_plan
    gives for aligned operands (a record holds no addresses)."""
    g = int(groups)
    lda, ldw = a.shape[-1], w.shape[-1]
    m, n = a.numel() // (g * lda), w.shape[0] // g
    if plan is None:
        sms = _sm_count(a.device) if a.device.type == "cuda" else 132
        plan = gemm_plan(m, n, int(k), g, lda, ldw, True, sms)
    kind = "int8_gemm_wgmma" if plan[0] == "wgmma" else "int8_gemm_mma"
    shape = (m, g * n) if positions == 1 else \
        (m // positions, g * n, positions)
    ins = [a, w] + [t for t in (data_scale, ws, bias) if torch.is_tensor(t)]
    scratch = []
    if plan[0] == "wgmma" and plan[2] > 1:  # the split's partials, counters
        tiles = g * -(-m // GEMM_BM) * -(-n // plan[1])
        scratch = [((tiles * plan[2] * GEMM_BM * plan[1] + 2 * tiles,),
                    torch.int32)]
    return _audit.record_kernel(
        (__name__, kind), kind + "_kernel" if plan[0] == "wgmma" else
        "int8_gemm_kernel", ins, [(shape, dtype_torch(out_dtype))],
        flops=2.0 * g * m * n * int(k), scratch=scratch)[0]


def _int8_gemm(a, w, k, data_scale, ws, bias, out_dtype, groups, positions,
               plan):
    """:func:`int8_gemm` on ``plan``'s route, tile and split (a triple as
    :func:`gemm_plan` returns), or on gemm_plan's for None: the checks and
    benchmarks hold the routes and tilings against each other with it."""
    if _audit.recording():
        return _record_gemm(a, w, k, data_scale, ws, bias, out_dtype, groups,
                            positions, plan)
    if a.device.type == "cpu":
        return int8_gemm_plain(a, w, k, data_scale, ws, bias, out_dtype,
                               groups, positions)
    _cc.check_device(a)
    dev = a.device
    _check_int8("a", a, dev)
    _check_int8("w", w, dev)
    g = int(groups)
    lda, ldw = a.shape[-1], w.shape[-1]
    m = a.numel() // (g * lda)
    n = w.shape[0] // g
    if a.numel() != g * m * lda or w.shape[0] != g * n or k > min(lda, ldw) \
            or m % positions:
        raise MXNetError(f"int8_gemm: shapes {tuple(a.shape)} x "
                         f"{tuple(w.shape)} with k {k}, groups {g}")
    out_dt = dtype_torch(out_dtype)
    ds = _scalar(data_scale, dev)
    wsc = _channel_scales(ws, g * n, dev)
    if wsc.numel() != g * n:
        raise MXNetError(f"int8_gemm: {wsc.numel()} weight scales for "
                         f"{g * n} channels")
    b = None if bias is None else bias.to(torch.float32).contiguous()
    shape = (m, g * n) if positions == 1 else \
        (m // positions, g * n, positions)
    out = torch.empty(shape, dtype=out_dt, device=dev)
    if plan is None:
        plan = gemm_plan(m, n, int(k), g, lda, ldw,
                         a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0,
                         _sm_count(dev))
    if plan[0] not in ("wgmma", "mma"):
        raise MXNetError(f"int8_gemm: no route {plan[0]!r}")
    lib = _cc.load("int8_gemm")
    bias_ptr = None if b is None else b.data_ptr()
    if plan[0] == "wgmma":
        _, bn, splits = plan
        partial = counters = None
        if splits > 1:
            # the s32 partial tiles, then a zeroed arrival count a tile half:
            # the call's own, so that no other launch in flight shares them
            tiles = g * -(-m // GEMM_BM) * -(-n // bn)
            size = tiles * splits * GEMM_BM * bn
            work = torch.empty(size + 2 * tiles, dtype=torch.int32,
                               device=dev)
            partial, counters = work[:size], work[size:].zero_()
        rc = lib.mx_int8_gemm_wgmma(
            a.data_ptr(), w.data_ptr(), out.data_ptr(), ds.data_ptr(),
            wsc.data_ptr(), bias_ptr,
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(), m, n, int(k),
            lda, ldw, m * lda, n * ldw, g, int(positions), bn, splits,
            _cc.dtype_code(out_dt), _cc.stream_ptr(dev))
        kind = "int8_gemm_wgmma"
    else:
        rc = lib.mx_int8_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                              ds.data_ptr(), wsc.data_ptr(), bias_ptr, m, n,
                              int(k), lda, ldw, m * lda, n * ldw, g,
                              int(positions), _cc.dtype_code(out_dt),
                              _cc.stream_ptr(dev))
        kind = "int8_gemm_mma"
    _cc.check_launch(lib, rc, kind)
    launches["int8_gemm"] += 1
    launches[kind] += 1
    return out


def _fc(dataq, w2d, k, bias, data_scale, weight_scale, flatten, out_dtype):
    """The int8 product of ``quantized_fully_connected`` with the weight as
    (N, ldw) rows of which the first ``k`` count."""
    if flatten and dataq.dim() > 2:
        dataq = dataq.reshape(dataq.shape[0], -1)
    lead = dataq.shape[:-1]
    a = dataq.reshape(-1, dataq.shape[-1]).contiguous()
    out = int8_gemm(a, w2d.contiguous(), k, data_scale, weight_scale, bias,
                    out_dtype)
    return out.reshape(*lead, out.shape[-1])


def _conv(data, w2d, k, bias, kernel, stride, pad, dilate, groups,
          data_scale, weight_scale, out_dtype, quantize=False):
    """``quantized_conv`` with the weight as (O, ldw) rows: the im2col
    launch (which, with ``quantize``, quantises the float ``data`` by
    ``data_scale``; else ``data`` is int8), then the product written
    NCHW."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    x = data.contiguous()
    b, _, h, w = x.shape
    oh, ow = _out_hw(h, w, kernel, stride, pad, dilate)
    cols = int8_im2col(x, kernel, stride, pad, dilate, groups, k_padded(k),
                       data_scale if quantize else None)
    out = int8_gemm(cols, w2d.contiguous(), k, data_scale, weight_scale,
                    bias, out_dtype, groups=groups, positions=oh * ow)
    return out.reshape(b, -1, oh, ow)


@register("_contrib_quantized_fully_connected", aliases=("quantized_fully_connected",))
def quantized_fully_connected(dataq, weightq, bias=None, data_scale=1.0,
                              weight_scale=1.0, num_hidden=None, no_bias=False,
                              flatten=True, out_dtype="float32"):
    """int8 GEMM: ``s8 x s8 -> s32`` accumulate, then one f32 requant-scale.

    ``weight_scale`` may be per-output-channel (shape ``(num_hidden,)`` or
    ``(num_hidden, 1)``). The output is dequantized f32/bf16."""
    b = bias if bias is not None and not no_bias else None
    return _fc(dataq, weightq, weightq.shape[1], b, data_scale, weight_scale,
               flatten, out_dtype)


@register("_contrib_quantized_conv", aliases=("quantized_conv",))
def quantized_conv(dataq, weightq, bias=None, kernel=None, stride=(1, 1),
                   pad=(0, 0), dilate=(1, 1), num_filter=None, num_group=1,
                   no_bias=False, data_scale=1.0, weight_scale=1.0,
                   out_dtype="float32"):
    """int8 convolution with s32 accumulation (NCHW, like ``Convolution``)."""
    o = weightq.shape[0]
    k = weightq[0].numel()
    b = bias if bias is not None and not no_bias else None
    return _conv(dataq, weightq.reshape(o, k), k, b, tuple(weightq.shape[2:]),
                 stride, pad, dilate, int(num_group), data_scale,
                 weight_scale, out_dtype)


class _QuantizedLayer(torch.nn.Module):
    """Shared int8-inference plumbing for the converted layers (the JAX
    ``_QuantizedLayer``): static-or-dynamic activation scale, int8
    clip/round, the full Activation-registry tail, dtype restore.
    Subclasses supply ``_compute(data, a_scale)``, ``data`` the input as it
    came: the Dense quantises it in PyTorch, the convolution's im2col kernel
    as it writes the patches. A torch module, so it takes a converted
    child's place in its parent; called on an NDArray it returns an
    NDArray, on a tensor a tensor."""

    def __init__(self, wq, w_scale, bias=None, activation=None,
                 act_scale=None):
        super().__init__()
        self._wq = wq
        self._ws = _f32(w_scale, wq.device).reshape(-1)
        self._bias = bias
        self._act = activation
        self._act_scale = act_scale

    def forward(self, x):
        from ..ndarray import NDArray
        from ..ops.nn import activation as _activation

        data = _raw(x)
        orig_dtype = data.dtype
        if self._act_scale is not None:
            a_scale = _scalar(self._act_scale, data.device)
        else:
            # |x| and its max are exact in any float type: the f32 max
            # of the f32 copy JAX takes
            a_scale = data.abs().amax().to(torch.float32) \
                / _scalar(127.0, data.device) + 1e-12
        out = self._compute(data, a_scale)
        if self._act is not None:
            # the full Activation registry (relu/sigmoid/tanh/softrelu/...)
            out = _activation(out, act_type=self._act)
        out = out.to(orig_dtype)
        return NDArray(out) if isinstance(x, NDArray) else out


class QuantizedDense(_QuantizedLayer):
    """Inference-only replacement for ``gluon.nn.Dense`` holding int8 weights
    (produced by :func:`convert_to_int8`). Activations are quantized with the
    calibrated static scale when available, else dynamically per batch."""

    def _compute(self, data, a_scale):
        return _fc(_quantize(data, a_scale), self._wq, self._wq.shape[1],
                   self._bias, a_scale, self._ws, True, "float32")


class QuantizedConv2D(_QuantizedLayer):
    """Inference-only replacement for ``gluon.nn.Conv2D`` holding int8
    weights (produced by :func:`convert_to_int8`). Besides the
    (O, C/G, KH, KW) weight it keeps, made once, its (O, k_pad) rows zero
    past K, the row length of the im2col's patches."""

    def __init__(self, wq, w_scale, bias, kernel, strides, padding, dilation,
                 groups, activation=None, act_scale=None):
        super().__init__(wq, w_scale, bias=bias, activation=activation,
                         act_scale=act_scale)
        self._kernel = kernel
        self._strides = strides
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        o = wq.shape[0]
        self._k = wq[0].numel()
        self._w2d = torch.zeros((o, k_padded(self._k)), dtype=torch.int8,
                                device=wq.device)
        self._w2d[:, :self._k] = wq.reshape(o, self._k)

    def _compute(self, data, a_scale):
        if data.dtype not in (torch.float32, torch.bfloat16):
            data = data.to(torch.float32)
        return _conv(data, self._w2d, self._k, self._bias,
                     tuple(self._kernel), self._strides, self._padding,
                     self._dilation, int(self._groups), a_scale, self._ws,
                     "float32", quantize=True)


def convert_to_int8(net, calib_data=None, exclude_patterns=("embed",),
                    calib_mode="minmax"):
    """Swap every ``Dense`` and ``Conv2D`` child of a Gluon block tree for
    its int8 counterpart (s8×s8→s32 with one requant scale). Returns the
    (mutated) net and {layer_name: weight_scale}. With ``calib_data`` (list
    of input batches), activation scales come from running the f32 net once
    with capture hooks — ``calib_mode`` picks min-max or KL-divergence
    (entropy) thresholding; otherwise activations quantize dynamically per
    batch."""
    from ..gluon import nn as _gnn

    if calib_mode not in ("minmax", "entropy"):
        raise ValueError(f"calib_mode must be minmax|entropy, got {calib_mode}")

    def _quantizable(child):
        return isinstance(child, (_gnn.Dense, _gnn.Conv2D))

    # eager from here on, as the JAX package drops its compiled programs:
    # the port's hybridize records a flag and captures nothing, and a
    # calibration forward outside a step graph reaches the hooks
    for blk in [net] + [c for _, c in _walk_blocks(net)]:
        if hasattr(blk, "_active"):
            blk._active = False

    act_stats = {}
    if calib_data is not None:
        hooked = []
        samples = {}

        def _capture(blk, name):
            orig = blk.forward

            def fwd(x, *a, **k):
                xd = _raw(x).detach()
                if calib_mode == "entropy":
                    # bounded histogram sample per layer; .copy() detaches
                    # the strided view from the full activation buffer
                    xa = np.abs(xd.float().cpu().numpy()).ravel()
                    if xa.size > 65536:
                        xa = xa[:: xa.size // 65536 + 1]
                    samples.setdefault(name, []).append(xa.copy())
                else:
                    # device-side reduction: only a scalar crosses to host
                    act_stats[name] = max(act_stats.get(name, 0.0),
                                          float(xd.abs().amax()))
                return orig(x, *a, **k)

            blk.forward = fwd
            hooked.append((blk, orig))

        for name, child in _walk_blocks(net):
            if _quantizable(child):
                _capture(child, name)
        try:
            with torch.no_grad():
                for batch in calib_data:
                    net(batch)
        finally:
            for blk, _orig in hooked:
                del blk.forward
        if calib_mode == "entropy":
            for name, chunks in samples.items():
                # calib_entropy returns the scale directly (threshold/127)
                act_stats[name] = 127.0 * calib_entropy(chunks)

    scales = {}
    for parent, key, child, name in _walk_children(net):
        if not _quantizable(child):
            continue
        weight = child._reg_params["weight"]
        if any(s in name for s in exclude_patterns) or weight._var is None:
            continue
        wq, ws = quantize_array(weight._var.detach(), axis=0)
        bp = child._reg_params.get("bias")
        bias = bp._var.detach() if bp is not None and bp._var is not None \
            else None
        a_scale = (act_stats[name] / 127.0 + 1e-12) if name in act_stats \
            else None
        if isinstance(child, _gnn.Dense):
            q = QuantizedDense(wq, ws, bias=bias,
                               activation=getattr(child, "_act", None),
                               act_scale=a_scale)
        else:
            q = QuantizedConv2D(wq, ws, bias, child._kernel, child._strides,
                                child._padding, child._dilation,
                                child._groups,
                                activation=getattr(child, "_act", None),
                                act_scale=a_scale)
        parent._children[key] = q
        scales[name] = ws.detach().cpu().numpy()
    return net, scales


def _walk_blocks(net, prefix=""):
    for _parent, _key, child, name in _walk_children(net, prefix):
        yield name, child


def _walk_children(net, prefix=""):
    for key, child in list(getattr(net, "_children", {}).items()):
        name = f"{prefix}{key}"
        yield net, key, child, name
        yield from _walk_children(child, prefix=name + ".")


def quantize_net(net, calib_data=None, calib_mode="naive", quantized_dtype="int8",
                 exclude_patterns=("bias", "gamma", "beta", "running", "embed")):
    """Quantize a Gluon block's weight parameters in place (simulated int8:
    stored dequantized with int8-grid values; scales returned)."""
    scales = {}
    for name, p in net.collect_params().items():
        if p._var is None or any(s in name for s in exclude_patterns):
            continue
        if p._var.dim() < 2:
            continue
        q, scale = quantize_array(p._var.detach(), axis=0)
        p.set_data(dequantize_array(q, scale, dtype=p._var.dtype))
        scales[name] = scale.detach().cpu().numpy()
    return net, scales

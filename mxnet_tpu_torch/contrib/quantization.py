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
    hand-written kernels of ``csrc/int8_gemm.cu`` (an im2col launch for a
    convolution, then the tensor-core product with the requantisation in
    its epilogue, written NCHW). PyTorch on the card has no integer matmul
    or convolution that takes these shapes (``torch._int_mm`` needs M > 16
    and K, N multiples of 8).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (the patches by ``F.unfold`` and the product by a ``matmul``, both
in float64, exact for these integers, rounded to int32) only for CPU
tensors. The epilogue is JAX's, in JAX's order:
``acc.astype(f32) * (data_scale * ws)``, then ``+ bias``, then the cast.
Activations are quantized as ``round(x / scale)`` with the divisor a
device tensor (a CUDA tensor divided by a host scalar is multiplied by its
reciprocal, which moves values at the rounding edges); ``torch.round``
rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_torch
from ..ops import cuda_common as _cc
from ..registry import register

__all__ = ["quantize_array", "dequantize_array", "calib_minmax", "calib_entropy",
           "quantize_net", "quantized_fully_connected", "quantized_conv",
           "convert_to_int8", "QuantizedDense", "QuantizedConv2D",
           "int8_im2col", "int8_im2col_plain", "int8_gemm", "int8_gemm_plain"]

#: kernel launches since the last reset (read by chip_smoke.py)
launches = {"int8_gemm": 0, "int8_im2col": 0}


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


def int8_im2col_plain(xq, kernel, stride, pad, dilate, groups, k_pad):
    """Plain version of ``int8_im2col_kernel``: ``F.unfold`` of the int8
    NCHW input in float64 as (G, B*OH*OW, k_pad) int8, zero past K."""
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


def int8_im2col(xq, kernel, stride, pad, dilate, groups, k_pad):
    """The patches of an int8 NCHW activation, (G, B*OH*OW, k_pad) int8:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    kernel, stride, pad, dilate = map(_pair, (kernel, stride, pad, dilate))
    if xq.device.type == "cpu":
        return int8_im2col_plain(xq, kernel, stride, pad, dilate, groups,
                                 k_pad)
    _cc.check_device(xq)
    _check_int8("data", xq, xq.device)
    b, c, h, w = xq.shape
    oh, ow = _out_hw(h, w, kernel, stride, pad, dilate)
    if c % groups or oh <= 0 or ow <= 0 or k_pad % 32 \
            or c // groups * kernel[0] * kernel[1] > k_pad:
        raise MXNetError(f"int8_im2col: bad shape {tuple(xq.shape)} for "
                         f"kernel {kernel}, groups {groups}, k_pad {k_pad}")
    out = torch.empty((groups, b * oh * ow, k_pad), dtype=torch.int8,
                      device=xq.device)
    lib = _cc.load("int8_gemm")
    rc = lib.mx_int8_im2col(xq.data_ptr(), out.data_ptr(), b, c, h, w, groups,
                            kernel[0], kernel[1], stride[0], stride[1],
                            pad[0], pad[1], dilate[0], dilate[1], oh, ow,
                            k_pad, _cc.stream_ptr(xq.device))
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


def int8_gemm(a, w, k, data_scale, ws, bias=None, out_dtype="float32",
              groups=1, positions=1):
    """``C[m, n] = sum_{j < k} a[m, j] w[n, j]`` per group in s32, then
    JAX's requantisation: the kernel for CUDA tensors, the plain version
    for CPU tensors. ``a``: (G, M, lda) or (M, lda) int8, ``w``: (G*N,
    ldw) int8 (rows past ``k`` ignored), ``data_scale`` a scalar,
    ``ws`` (G*N,) or one value, ``bias`` (G*N,) or None. Returns (M, G*N),
    or NCHW (M / P, G*N, P) for ``positions`` P > 1."""
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
    lib = _cc.load("int8_gemm")
    rc = lib.mx_int8_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(),
                          ds.data_ptr(), wsc.data_ptr(),
                          None if b is None else b.data_ptr(), m, n, int(k),
                          lda, ldw, m * lda, n * ldw, g, int(positions),
                          _cc.dtype_code(out_dt), _cc.stream_ptr(dev))
    _cc.check_launch(lib, rc, "int8_gemm")
    launches["int8_gemm"] += 1
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


def _conv(dataq, w2d, k, bias, kernel, stride, pad, dilate, groups,
          data_scale, weight_scale, out_dtype):
    """``quantized_conv`` with the weight as (O, ldw) rows: the im2col
    launch, then the product written NCHW."""
    stride, pad, dilate = _pair(stride), _pair(pad), _pair(dilate)
    x = dataq.contiguous()
    b, _, h, w = x.shape
    oh, ow = _out_hw(h, w, kernel, stride, pad, dilate)
    cols = int8_im2col(x, kernel, stride, pad, dilate, groups, k_padded(k))
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
    Subclasses supply ``_compute(xq, a_scale)``. A torch module, so it
    takes a converted child's place in its parent; called on an NDArray it
    returns an NDArray, on a tensor a tensor."""

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
        xf = data.to(torch.float32)
        if self._act_scale is not None:
            a_scale = _scalar(self._act_scale, xf.device)
        else:
            a_scale = xf.abs().amax() / _scalar(127.0, xf.device) + 1e-12
        xq = torch.clamp(torch.round(xf / a_scale), -127, 127) \
            .to(torch.int8)
        out = self._compute(xq, a_scale)
        if self._act is not None:
            # the full Activation registry (relu/sigmoid/tanh/softrelu/...)
            out = _activation(out, act_type=self._act)
        out = out.to(orig_dtype)
        return NDArray(out) if isinstance(x, NDArray) else out


class QuantizedDense(_QuantizedLayer):
    """Inference-only replacement for ``gluon.nn.Dense`` holding int8 weights
    (produced by :func:`convert_to_int8`). Activations are quantized with the
    calibrated static scale when available, else dynamically per batch."""

    def _compute(self, xq, a_scale):
        return _fc(xq, self._wq, self._wq.shape[1], self._bias, a_scale,
                   self._ws, True, "float32")


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

    def _compute(self, xq, a_scale):
        return _conv(xq, self._w2d, self._k, self._bias, tuple(self._kernel),
                     self._strides, self._padding, self._dilation,
                     int(self._groups), a_scale, self._ws, "float32")


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

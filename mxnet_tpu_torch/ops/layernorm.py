"""LayerNorm forward: the CUDA kernel ``csrc/layernorm.cu`` and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_layernorm.py`` (``_ln_kernel``).
Forward only: this slice serves. :func:`layer_norm` launches the kernel for
a CUDA tensor and takes :func:`layer_norm_plain` only for a CPU tensor.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["layer_norm", "layer_norm_plain", "MAX_D"]

#: widest row the kernel takes: the row is staged in shared memory as f32
MAX_D = 8192

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """f32 mean, variance of (x - mean), ``rsqrt(var + eps)``, then the
    affine; the result in ``x.dtype`` (the JAX ``layer_norm`` composition)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape)."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    _cc.check_device(x)
    d = x.shape[-1]
    if d > MAX_D:
        raise MXNetError(f"layer_norm kernel takes d <= {MAX_D}, got {d}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.device != x.device or tuple(p.shape) != (d,) \
                or not p.is_contiguous():
            raise MXNetError(f"layer_norm: {name} must be a contiguous ({d},) "
                             f"tensor on {x.device}, got {tuple(p.shape)} on "
                             f"{p.device}")
    if not x.is_contiguous():
        raise MXNetError("layer_norm kernel needs a contiguous input")
    xdt, pdt = _cc.dtype_code(x.dtype), _cc.dtype_code(gamma.dtype)
    if beta.dtype != gamma.dtype:
        raise MXNetError("layer_norm: gamma and beta dtypes differ")
    rows = x.numel() // d if d else 0
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    lib = _cc.load("layernorm")
    rc = lib.mx_layernorm(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                          out.data_ptr(), rows, d, float(eps), xdt, pdt,
                          _cc.stream_ptr(x.device))
    _cc.check_launch(lib, rc, "layer_norm")
    launches += 1
    return out

"""LayerNorm: the forward CUDA kernel ``csrc/layernorm.cu``, its plain
PyTorch version, and the analytic backward.

Counterpart of ``mxnet_tpu/ops/pallas_layernorm.py``. As there, the
forward is the kernel (``_ln_kernel``) and the backward is the analytic VJP
in plain tensor code (``_ln_bwd``): :class:`LayerNormFn` ties them
together, so a gradient flows through the kernel's output to x, gamma and
beta. The forward launches the kernel for a CUDA tensor and takes
:func:`layer_norm_plain` only for a CPU tensor.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_bwd", "LayerNormFn",
           "MAX_D"]

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


def layer_norm_bwd(x, gamma, g, eps=1e-5):
    """The analytic LayerNorm VJP of ``_ln_bwd``: f32 math over rows of the
    last axis, then (dx, dgamma, dbeta) in the dtypes of x and gamma."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    gf = g.reshape(-1, d).float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    dy = gf * gamma.float()
    dx = rstd * (dy - dy.mean(dim=-1, keepdim=True)
                 - xhat * (dy * xhat).mean(dim=-1, keepdim=True))
    dgamma = (gf * xhat).sum(dim=0)
    dbeta = gf.sum(dim=0)
    return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
            dbeta.to(gamma.dtype))


class LayerNormFn(torch.autograd.Function):
    """The forward kernel (plain version on the CPU) with the analytic
    backward; saves x and gamma, as ``_ln_fwd`` does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, g, ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape),
    differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, gamma, beta)):
        return LayerNormFn.apply(x, gamma, beta, float(eps))
    return _forward(x, gamma, beta, eps)


def _forward(x, gamma, beta, eps):
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

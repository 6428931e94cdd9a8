"""LayerNorm: the forward and backward CUDA kernels ``csrc/layernorm.cu``
and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/pallas_layernorm.py``. There the forward is
the kernel (``_ln_kernel``) and the backward is the analytic VJP in plain
jnp (``_ln_bwd``); here both are kernels, and :class:`LayerNormFn` ties
them together, so a gradient flows through the kernel's output to x, gamma
and beta. Each wrapper launches its kernel for a CUDA tensor and takes the
plain version (:func:`layer_norm_plain`, :func:`layer_norm_bwd`) only for
a CPU tensor.

Both kernels have two routes (``_route``): one warp a row with the row in
registers, for rows that fit a warp and are read by 16-byte loads, and one
block a row for the other widths up to :data:`MAX_D`, ragged rows and
misaligned bases.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["layer_norm", "layer_norm_plain", "layer_norm_bwd", "LayerNormFn",
           "MAX_D"]

#: widest row the kernels take (the block route's; JAX's ``_MAX_D``)
MAX_D = 8192
# The routes' shapes, measured on the H100 (tools/torch_layernorm_bench.py,
# PERF.md):
#: warp route, forward: rows (warps) a block, and the longest row it takes,
#: 4 KiB (8 16-byte vectors a lane: d <= 1024 in f32, 2048 in bf16; wider
#: f32 rows were faster on the block route)
FWD_WARPS = 2
FWD_WARP_MAX_BYTES = 4096
#: warp route, backward: warps a block (their column sums, BWD_WARPS * 2 * d
#: f32 of shared memory, 64 KiB at d = 1024), and the widest row it takes
BWD_WARPS = 8
BWD_WARP_MAX_D = 1024
#: backward blocks per SM: the grid that strides over the rows, one
#: partial of dgamma and dbeta a block (one block of 8 warps fills an SM's
#: registers: ~200 a thread, with the next row's x and g in flight)
BWD_BLOCKS_PER_SM = 1

#: kernel launches since the last reset (read by chip_smoke.py): the
#: forward, the backward's row kernel and its merge of the column sums
launches = {"fwd": 0, "bwd": 0, "bwd_merge": 0}


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
    """The forward kernel with the backward kernel (their plain versions on
    the CPU); saves x and gamma, as ``_ln_fwd`` does."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _forward(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(x, gamma, g, ctx.eps)
        return dx, dgamma, dbeta, None


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of ``x`` (any leading shape),
    differentiable in x, gamma and beta."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, gamma, beta)):
        return LayerNormFn.apply(x, gamma, beta, float(eps))
    return _forward(x, gamma, beta, eps)


def _route(d, dtype, ptrs, max_d):
    """The kernel that rows of ``d`` values of ``dtype`` take: ``"warp"``
    (one warp a row, the row in registers) when ``d <= max_d``, a row is a
    whole number of 16-byte vectors and every address in ``ptrs`` is
    16-byte aligned; ``"block"`` (one block a row, scalar loads)
    otherwise."""
    vec = 16 // dtype.itemsize
    if 0 < d <= max_d and d % vec == 0 and all(p % 16 == 0 for p in ptrs):
        return "warp"
    return "block"


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _bwd_blocks(rows, warps, device):
    """The backward's grid: one block for every ``warps`` rows (one row for
    the block route, ``warps`` 0), at most BWD_BLOCKS_PER_SM a SM."""
    return max(1, min(-(-rows // max(warps, 1)),
                      BWD_BLOCKS_PER_SM * _sm_count(device)))


def _check(what, x, *params):
    """Refuse what the kernels do not take; returns (rows, d)."""
    _cc.check_device(x)
    d = x.shape[-1]
    if d > MAX_D:
        raise MXNetError(f"{what} kernel takes d <= {MAX_D}, got {d}")
    for name, p in params:
        if p.device != x.device or tuple(p.shape) != (d,) \
                or not p.is_contiguous():
            raise MXNetError(f"{what}: {name} must be a contiguous ({d},) "
                             f"tensor on {x.device}, got {tuple(p.shape)} on "
                             f"{p.device}")
    if not x.is_contiguous():
        raise MXNetError(f"{what} kernel needs a contiguous input")
    if any(p.dtype != params[0][1].dtype for _, p in params):
        raise MXNetError(f"{what}: gamma and beta dtypes differ")
    return (x.numel() // d if d else 0), d


def _forward(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    rows, d = _check("layer_norm", x, ("gamma", gamma), ("beta", beta))
    xdt, pdt = _cc.dtype_code(x.dtype), _cc.dtype_code(gamma.dtype)
    out = torch.empty_like(x)
    if rows == 0 or d == 0:
        return out
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr())
    max_d = FWD_WARP_MAX_BYTES // x.element_size()
    warps = FWD_WARPS if _route(d, x.dtype, ptrs, max_d) == "warp" else 0
    lib = _cc.load("layernorm")
    rc = lib.mx_layernorm(*ptrs, rows, d, float(eps), xdt, pdt, warps,
                          _cc.stream_ptr(x.device))
    _cc.check_launch(lib, rc, "layer_norm")
    launches["fwd"] += 1
    return out


def _backward(x, gamma, g, eps):
    """(dx, dgamma, dbeta) for the cotangent ``g`` of LayerNorm's output:
    the backward kernel (row kernel, then the merge of its column sums) for
    CUDA tensors, :func:`layer_norm_bwd` for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_bwd(x, gamma, g, eps)
    rows, d = _check("layer_norm backward", x, ("gamma", gamma))
    xdt, pdt = _cc.dtype_code(x.dtype), _cc.dtype_code(gamma.dtype)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise MXNetError(f"layer_norm backward: cotangent {tuple(g.shape)} "
                         f"{g.dtype} on {g.device} for an output "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    if rows == 0 or d == 0:
        return dx, torch.zeros_like(gamma), torch.zeros_like(gamma)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(gamma)
    ptrs = (x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr())
    warps = BWD_WARPS if _route(d, x.dtype, ptrs, BWD_WARP_MAX_D) == "warp" \
        else 0
    blocks = _bwd_blocks(rows, warps, x.device)
    partial = torch.empty((blocks, 2 * d), dtype=torch.float32,
                          device=x.device)
    lib = _cc.load("layernorm")
    rc = lib.mx_layernorm_bwd(*ptrs, dgamma.data_ptr(), dbeta.data_ptr(),
                              partial.data_ptr(), rows, d, float(eps), xdt,
                              pdt, warps, blocks, _cc.stream_ptr(x.device))
    _cc.check_launch(lib, rc, "layer_norm backward")
    launches["bwd"] += 1
    launches["bwd_merge"] += 1
    return dx, dgamma, dbeta

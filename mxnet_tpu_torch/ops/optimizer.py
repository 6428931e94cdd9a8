"""Adam: the multi-tensor CUDA kernel ``csrc/adam.cu`` and its plain
PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_optimizer.py`` (``_adam_kernel``)
and of ``adam_update`` in ``mxnet_tpu/ops/optimizer_ops.py``. The math is
the exact op order of the latter: rescale, clip, + wd·w, the moment
averages, then ``w - lr_t·m / (sqrt(v) + epsilon)``, all f32, with the
bias-corrected ``lr_t`` computed by the caller.

Updates are **in place**: the weight, the two moments and the optional
low-precision copy are overwritten, the port's analog of the JAX
``TrainStep`` donating its parameter and state buffers. Nothing is
returned that the caller does not already hold.

For float16 mixed precision both take ``inv_scale`` (a 0-d f32 tensor:
the gradient is multiplied by it before ``rescale_grad``, the JAX
``TrainStep``'s unscaling order) and ``skip`` (a 0-d int32 or bool
tensor: when nonzero nothing is written, the JAX step's ``lax.cond``
skip). Both stay on the card, so an overflowed step costs no host sync.

:func:`adam_update_fused` takes lists of tensors and updates them all in
one kernel launch for CUDA tensors; for CPU tensors it runs
:func:`adam_update_multi`, the plain version, which loops
:func:`adam_update`.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..analysis import audit as _audit
from ..base import MXNetError
from . import cuda_common as _cc
from . import cuda_graph as _cg

__all__ = ["adam_update", "adam_update_multi", "adam_update_fused",
           "sgd_update",
           "sgd_mom_update", "nag_mom_update"]

#: elements per block of the kernel (ADAM_CHUNK in csrc/adam.cu)
CHUNK = 4096
# per-tensor flags of the kernel's table (FLAG_* in csrc/adam.cu)
_FLAG_G_BF16, _FLAG_G_F16, _FLAG_LOW_F16 = 1, 2, 4
_GRAD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_LOW_DTYPES = (torch.bfloat16, torch.float16)

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# the last pointer table sent to the card, reused while the tensors stay put
_table_cache = {"key": None, "table": None}
_table_lock = threading.Lock()


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                out_low=None, inv_scale=None, skip=None):
    """Plain version, one tensor, in place. ``lr`` is the bias-corrected
    rate and ``wd`` the weight decay, each a float or a 0-d f32 tensor.
    ``weight``, ``mean`` and ``var`` are f32; ``grad`` f32, bf16 or f16;
    ``out_low``, if given, receives the new weight in its own dtype.
    ``inv_scale`` and ``skip`` as in the module docstring."""
    g = grad.float()
    if inv_scale is not None:
        g = g * inv_scale
    g = g * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * weight
    if skip is None:
        mean.copy_(beta1 * mean + (1 - beta1) * g)
        var.copy_(beta2 * var + (1 - beta2) * (g * g))
        weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
        if out_low is not None:
            out_low.copy_(weight)
        return weight, mean, var
    keep = skip.bool()
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * (g * g)
    w = weight - lr * m / (torch.sqrt(v) + epsilon)
    if out_low is not None:
        out_low.copy_(torch.where(keep, out_low, w.to(out_low.dtype)))
    mean.copy_(torch.where(keep, mean, m))
    var.copy_(torch.where(keep, var, v))
    weight.copy_(torch.where(keep, weight, w))
    return weight, mean, var


def adam_update_multi(weights, grads, means, vars_, lr, wd, *, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                      clip_gradient=-1.0, out_lows=None, inv_scale=None,
                      skip=None):
    """Plain version of :func:`adam_update_fused` (same arguments):
    :func:`adam_update` tensor by tensor, on any device."""
    ws = list(weights)
    n = len(ws)
    if not n:
        return
    dev = ws[0].device
    lr_v, wd_v = _per_tensor(lr, n, dev), _per_tensor(wd, n, dev)
    for i, (w, g, m, v) in enumerate(zip(ws, grads, means, vars_)):
        adam_update(w, g, m, v, lr_v[i], beta1, beta2, epsilon, wd_v[i],
                    rescale_grad, clip_gradient,
                    out_lows[i] if out_lows is not None else None,
                    inv_scale, skip)


def _apply_wd(grad, weight, wd, rescale_grad, clip_gradient):
    """``optimizer_ops._apply_wd``: rescale, clip, then + wd·w, in f32."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight.float()


def sgd_update(weight, grad, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """``optimizer_ops.sgd_update``, in place: ``w - lr·g``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    weight.copy_(weight.float() - lr * g)
    return weight


def sgd_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``optimizer_ops.sgd_mom_update``, in place: ``mom = momentum·mom -
    lr·g; w = w + mom``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom.float() - lr * g)
    weight.copy_(weight.float() + mom)
    return weight, mom


def nag_mom_update(weight, grad, mom, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """``optimizer_ops.nag_mom_update``, in place: ``mom = momentum·mom +
    g; w = w - lr·(g + momentum·mom)``."""
    g = _apply_wd(grad, weight, wd, rescale_grad, clip_gradient)
    mom.copy_(momentum * mom.float() + g)
    weight.copy_(weight.float() - lr * (g + momentum * mom))
    return weight, mom


def _per_tensor(x, n, device):
    """``x`` (a float, a 0-d or an (n,) tensor) as an (n,) f32 tensor."""
    if torch.is_tensor(x):
        x = x.to(device=device, dtype=torch.float32)
        if x.dim() == 0:
            x = x.expand(n)
    else:
        x = torch.full((n,), float(x), dtype=torch.float32, device=device)
    if tuple(x.shape) != (n,):
        raise MXNetError(f"per-tensor value of shape {tuple(x.shape)}, "
                         f"expected ({n},)")
    return x.contiguous()


def _check(ws, gs, ms, vs, lows):
    dev = ws[0].device
    _cc.check_device(ws[0])
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        for name, t, dts in (("weight", w, (torch.float32,)),
                             ("mean", m, (torch.float32,)),
                             ("var", v, (torch.float32,)),
                             ("grad", g, _GRAD_DTYPES)):
            if t.device != dev or t.dtype not in dts \
                    or not t.is_contiguous() or t.numel() != w.numel():
                raise MXNetError(
                    f"adam kernel: {name} {i} must be a contiguous "
                    f"{'/'.join(str(d)[6:] for d in dts)} tensor of "
                    f"{w.numel()} elements on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if lows is not None and lows[i] is not None:
            low = lows[i]
            if low.device != dev or low.dtype not in _LOW_DTYPES \
                    or not low.is_contiguous() or low.numel() != w.numel():
                raise MXNetError(f"adam kernel: low-precision copy {i} must "
                                 f"be a contiguous bf16 or f16 tensor like "
                                 f"its weight")


def _flags(grad, low):
    """A table row's flags: the gradient's dtype and the copy's."""
    flags = {torch.bfloat16: _FLAG_G_BF16,
             torch.float16: _FLAG_G_F16}.get(grad.dtype, 0)
    if low is not None and low.dtype == torch.float16:
        flags |= _FLAG_LOW_F16
    return flags


def _table(ws, gs, ms, vs, lows):
    """The (N, 8) int64 device table of (w, g, m, v, low | 0, n, first
    chunk, flags), and the total chunk count. Sent to the card (pinned,
    asynchronously) only when a pointer or a size changed.

    Inside a step graph's capture (``ops/cuda_graph.py``) the table is not
    a graph node: a captured copy would read its pinned host source again
    at every replay, after that memory was freed. The capture allocates the
    device table outside the graph's memory pool and fills it once, after
    the capture ends; the graph keeps it. Inside any other capture only a
    table already on the card serves."""
    rows = np.zeros((len(ws), 8), dtype=np.int64)
    chunk = 0
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        low = lows[i] if lows is not None else None
        n = w.numel()
        rows[i] = (w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                   low.data_ptr() if low is not None else 0, n, chunk,
                   _flags(g, low))
        chunk += -(-n // CHUNK)
    key = (ws[0].device, rows.tobytes())
    if _cg.capturing():
        table = _cg.persistent_empty(rows.shape, torch.int64)
        host = torch.from_numpy(rows)
        _cg.after_capture(lambda: table.copy_(host))
        return table, chunk
    with _table_lock:
        if _table_cache["key"] != key:
            if torch.cuda.is_current_stream_capturing():
                raise MXNetError("adam kernel: a new pointer table cannot be "
                                 "sent to the card inside a CUDA graph "
                                 "capture; capture through "
                                 "ops.cuda_graph.StepGraph")
            host = torch.from_numpy(rows).pin_memory()
            _table_cache["table"] = host.to(ws[0].device, non_blocking=True)
            _table_cache["key"] = key
        return _table_cache["table"], chunk


def _record(ws, gs, ms, vs, lr, wd, lows, inv_scale, skip):
    """The kernel's record (``analysis.audit``): it reads the gradients and
    the per-tensor rates and writes every weight, moment and copy."""
    if sum(w.numel() for w in ws) == 0:
        return
    lows = [t for t in (lows or ()) if t is not None]
    written = ws + ms + vs + lows
    extra = [t for t in (lr, wd, inv_scale, skip) if torch.is_tensor(t)]
    _audit.record_kernel((__name__, None), "adam_kernel",
                         written + gs + extra,
                         written=range(len(written)))


def adam_update_fused(weights, grads, means, vars_, lr, wd, *, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                      clip_gradient=-1.0, out_lows=None, inv_scale=None,
                      skip=None):
    """Adam over lists of tensors, in place. ``lr`` and ``wd`` are per
    tensor: (N,) f32 tensors on the weights' device (a schedule's values
    stay on the card), 0-d tensors or floats. ``out_lows`` is None or a
    list with, per tensor, None or a bf16 or f16 tensor that receives the
    new weight in the same pass. ``inv_scale`` and ``skip`` as in the
    module docstring. One kernel launch for CUDA tensors; the plain
    version, tensor by tensor, for CPU tensors."""
    global launches
    ws, gs, ms, vs = list(weights), list(grads), list(means), list(vars_)
    if not (len(ws) == len(gs) == len(ms) == len(vs)) or \
            (out_lows is not None and len(out_lows) != len(ws)):
        raise MXNetError("adam_update_fused: lists of different lengths")
    if not ws:
        return
    n = len(ws)
    clip = -1.0 if clip_gradient is None else float(clip_gradient)
    dev = ws[0].device
    if _audit.recording():
        _record(ws, gs, ms, vs, lr, wd, out_lows, inv_scale, skip)
        return
    if dev.type == "cpu":
        adam_update_multi(ws, gs, ms, vs, lr, wd, beta1=beta1, beta2=beta2,
                          epsilon=epsilon, rescale_grad=rescale_grad,
                          clip_gradient=clip, out_lows=out_lows,
                          inv_scale=inv_scale, skip=skip)
        return
    lr_v, wd_v = _per_tensor(lr, n, dev), _per_tensor(wd, n, dev)
    _check(ws, gs, ms, vs, out_lows)
    for name, t, dt in (("inv_scale", inv_scale, torch.float32),
                        ("skip", skip, torch.int32)):
        if t is not None and (t.device != dev or t.dtype != dt
                              or t.numel() != 1):
            raise MXNetError(f"adam kernel: {name} must be one {dt} value "
                             f"on {dev}")
    table, n_chunks = _table(ws, gs, ms, vs, out_lows)
    if n_chunks == 0:
        return
    if n_chunks >= 2 ** 31:
        raise MXNetError(f"adam kernel: {n_chunks} chunks exceed the grid")
    lib = _cc.load("adam")
    rc = lib.mx_adam(table.data_ptr(), n, n_chunks, lr_v.data_ptr(),
                     wd_v.data_ptr(),
                     inv_scale.data_ptr() if inv_scale is not None else None,
                     skip.data_ptr() if skip is not None else None,
                     beta1, beta2, 1.0 - beta1, 1.0 - beta2,
                     epsilon, float(rescale_grad), clip,
                     _cc.stream_ptr(dev))
    _cc.check_launch(lib, rc, "adam")
    launches += 1

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

:func:`adam_update_fused` takes lists of tensors and updates them all in
one kernel launch for CUDA tensors; for CPU tensors it loops
:func:`adam_update`, the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["adam_update", "adam_update_fused"]

#: elements per block of the kernel (ADAM_CHUNK in csrc/adam.cu)
CHUNK = 4096
_FLAG_G_BF16 = 1

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0

# the last pointer table sent to the card, reused while the tensors stay put
_table_cache = {"key": None, "table": None}


def adam_update(weight, grad, mean, var, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                out_low=None):
    """Plain version, one tensor, in place. ``lr`` is the bias-corrected
    rate and ``wd`` the weight decay, each a float or a 0-d f32 tensor.
    ``weight``, ``mean`` and ``var`` are f32; ``grad`` f32 or bf16;
    ``out_low``, if given, receives the new weight in its own dtype."""
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * weight
    mean.copy_(beta1 * mean + (1 - beta1) * g)
    var.copy_(beta2 * var + (1 - beta2) * (g * g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    if out_low is not None:
        out_low.copy_(weight)
    return weight, mean, var


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
                             ("grad", g, (torch.float32, torch.bfloat16))):
            if t.device != dev or t.dtype not in dts \
                    or not t.is_contiguous() or t.numel() != w.numel():
                raise MXNetError(
                    f"adam kernel: {name} {i} must be a contiguous "
                    f"{'/'.join(str(d)[6:] for d in dts)} tensor of "
                    f"{w.numel()} elements on {dev}, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if lows is not None and lows[i] is not None:
            low = lows[i]
            if low.device != dev or low.dtype != torch.bfloat16 \
                    or not low.is_contiguous() or low.numel() != w.numel():
                raise MXNetError(f"adam kernel: low-precision copy {i} must "
                                 f"be a contiguous bf16 tensor like its "
                                 f"weight")


def _table(ws, gs, ms, vs, lows):
    """The (N, 8) int64 device table of (w, g, m, v, low | 0, n, first
    chunk, flags), and the total chunk count. Sent to the card (pinned,
    asynchronously) only when a pointer or a size changed."""
    rows = np.zeros((len(ws), 8), dtype=np.int64)
    chunk = 0
    for i, (w, g, m, v) in enumerate(zip(ws, gs, ms, vs)):
        low = lows[i] if lows is not None else None
        n = w.numel()
        rows[i] = (w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                   low.data_ptr() if low is not None else 0, n, chunk,
                   _FLAG_G_BF16 if g.dtype == torch.bfloat16 else 0)
        chunk += -(-n // CHUNK)
    key = (ws[0].device, rows.tobytes())
    if _table_cache["key"] != key:
        host = torch.from_numpy(rows).pin_memory()
        _table_cache["table"] = host.to(ws[0].device, non_blocking=True)
        _table_cache["key"] = key
    return _table_cache["table"], chunk


def adam_update_fused(weights, grads, means, vars_, lr, wd, *, beta1=0.9,
                      beta2=0.999, epsilon=1e-8, rescale_grad=1.0,
                      clip_gradient=-1.0, out_lows=None):
    """Adam over lists of tensors, in place. ``lr`` and ``wd`` are per
    tensor: (N,) f32 tensors on the weights' device (a schedule's values
    stay on the card), 0-d tensors or floats. ``out_lows`` is None or a
    list with, per tensor, None or a bf16 tensor that receives the new
    weight in the same pass. One kernel launch for CUDA tensors; the plain
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
    lr_v, wd_v = _per_tensor(lr, n, dev), _per_tensor(wd, n, dev)
    if dev.type == "cpu":
        for i in range(n):
            adam_update(ws[i], gs[i], ms[i], vs[i], lr_v[i], beta1, beta2,
                        epsilon, wd_v[i], rescale_grad, clip,
                        out_lows[i] if out_lows is not None else None)
        return
    _check(ws, gs, ms, vs, out_lows)
    table, n_chunks = _table(ws, gs, ms, vs, out_lows)
    if n_chunks == 0:
        return
    if n_chunks >= 2 ** 31:
        raise MXNetError(f"adam kernel: {n_chunks} chunks exceed the grid")
    lib = _cc.load("adam")
    rc = lib.mx_adam(table.data_ptr(), n, n_chunks, lr_v.data_ptr(),
                     wd_v.data_ptr(), beta1, beta2, 1.0 - beta1, 1.0 - beta2,
                     epsilon, float(rescale_grad), clip,
                     _cc.stream_ptr(dev))
    _cc.check_launch(lib, rc, "adam")
    launches += 1

"""Softmax cross entropy with sparse labels: the CUDA kernels
``csrc/softmax_xent.cu`` (forward and backward) and their plain PyTorch
versions.

Counterpart of ``mxnet_tpu/ops/pallas_softmax_xent.py`` (``_xent_kernel``
and the custom VJP ``_xent_vjp_bwd``). The per-row loss
``logsumexp(x) - x[label]`` is computed in one pass over the logits, and
the (N, C) log-softmax of the ``log_softmax -> pick`` composition never
exists in either direction. :class:`SoftmaxXentFn` saves the logits, the
labels and the per-row f32 statistics that the forward kernel writes
beside the loss, the row's max and sum of ``exp(x - max)``; its backward
computes ``(softmax(x) - onehot) · g`` from them. (Recomputing softmax as
``exp(x - lse)`` instead would carry lse's rounding into every
probability: 5e-4 relative at logits of 1e4.) Each wrapper launches its
kernel for CUDA tensors and takes its plain version only for CPU tensors.

A label outside ``[0, C)`` picks nothing, as in the JAX kernel (its
``col == lbl`` never matches): the loss is ``lse`` and the one-hot row is
all zeros.
"""
from __future__ import annotations

import torch

from .. import config as _config
from ..analysis import audit as _audit
from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["xent_kernel_supported", "softmax_cross_entropy_fused",
           "softmax_cross_entropy_plain", "softmax_cross_entropy_bwd_plain",
           "SoftmaxXentFn"]

#: kernel launches since the last reset (read by chip_smoke.py)
launches = {"fwd": 0, "bwd": 0}


def xent_kernel_supported(pred, axis=-1) -> bool:
    """Whether ``SoftmaxCrossEntropyLoss`` takes the fused path: the
    ``fused_softmax_xent`` knob on, ``pred.ndim >= 2``, the class axis last,
    and f32 or bf16 logits. Float16 logits take the composition, as the JAX
    gate sends them there: a dispatch rule, not a fallback.

    The JAX gate has three more terms, all TPU facts that do not apply to
    the card: ``_on_tpu()``, ``C % 128 == 0`` (rows padded to 128 lanes) and
    ``C <= 65536`` (a block of whole rows in VMEM). The kernels here stream
    a row of any width, so the port drops all three."""
    if not _config.get("fused_softmax_xent") or pred.dim() < 2:
        return False
    return (axis % pred.dim() == pred.dim() - 1
            and pred.dtype in (torch.float32, torch.bfloat16))


def softmax_cross_entropy_plain(x2, labels):
    """Plain version of the forward kernel: ``(loss, lse)``, each (N,) f32,
    with ``lse = max + log(sum(exp(x - max)))`` (``_xent_forward``'s
    max-shift) and ``loss = lse - x[label]`` (0 picked for a label outside
    ``[0, C)``)."""
    xf = x2.float()
    c = xf.shape[-1]
    m = xf.amax(dim=-1, keepdim=True)
    lse = m.squeeze(-1) + torch.log(torch.exp(xf - m).sum(dim=-1))
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < c)
    picked = xf.gather(1, lbl.clamp(0, c - 1)[:, None]).squeeze(1)
    return lse - torch.where(valid, picked, torch.zeros_like(picked)), lse


def softmax_cross_entropy_bwd_plain(x2, labels, g):
    """Plain version of the backward, ``_xent_vjp_bwd``: ``(softmax(x) -
    onehot) · g`` in f32, cast to ``x2.dtype``. The one-hot is subtracted in
    place by a scatter (no (N, C) integer tensor), and only for labels in
    ``[0, C)``."""
    c = x2.shape[-1]
    p = torch.softmax(x2.float(), dim=-1)
    lbl = labels.long()
    valid = ((lbl >= 0) & (lbl < c)).float()
    p.scatter_add_(1, lbl.clamp(0, c - 1)[:, None], -valid[:, None])
    return (p * g.float()[:, None]).to(x2.dtype)


def _check(x2, labels):
    _cc.check_device(x2)
    n, c = x2.shape
    if not x2.is_contiguous():
        raise MXNetError("softmax_xent kernels need contiguous logits")
    if labels.device != x2.device or labels.dtype != torch.int32 \
            or tuple(labels.shape) != (n,) or not labels.is_contiguous():
        raise MXNetError(f"softmax_xent: labels must be a contiguous ({n},) "
                         f"int32 tensor on {x2.device}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    return n, c, _cc.dtype_code(x2.dtype)


def _xent_fwd(x2, labels):
    """The forward: the kernel for a CUDA tensor, the plain version for a
    CPU tensor. Returns ``(loss, stats)``: stats is the kernel's (2, N) f32
    row max and sum of exp (so ``lse = stats[0] + log(stats[1])``), None on
    the CPU (the plain backward recomputes softmax from the logits)."""
    if _audit.recording():
        n = x2.shape[0]
        loss, stats = _audit.record_kernel(
            (__name__, "fwd"), "xent_fwd_kernel", [x2, labels],
            [((n,), torch.float32), ((2, n), torch.float32)])
        return loss, stats
    if x2.device.type == "cpu":
        return softmax_cross_entropy_plain(x2, labels)[0], None
    n, c, code = _check(x2, labels)
    loss = torch.empty(n, dtype=torch.float32, device=x2.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x2.device)
    if n and c:
        lib = _cc.load("softmax_xent")
        rc = lib.mx_xent_fwd(x2.data_ptr(), labels.data_ptr(),
                             loss.data_ptr(), stats.data_ptr(), n, c, code,
                             _cc.stream_ptr(x2.device))
        _cc.check_launch(lib, rc, "softmax_xent forward")
        launches["fwd"] += 1
    return loss, stats


def _xent_bwd(x2, labels, stats, g):
    """The backward: the kernel (softmax from the forward's ``stats``) for a
    CUDA tensor, the plain version for a CPU tensor. Returns dx in x2's
    dtype."""
    if _audit.recording():
        g = g.to(torch.float32).contiguous()
        return _audit.record_kernel(
            (__name__, "bwd"), "xent_bwd_kernel", [x2, labels, stats, g],
            [(x2.shape, x2.dtype)])[0]
    if x2.device.type == "cpu":
        return softmax_cross_entropy_bwd_plain(x2, labels, g)
    n, c, code = _check(x2, labels)
    g = g.to(torch.float32).contiguous()
    for name, t, shape in (("stats", stats, (2, n)), ("g", g, (n,))):
        if t.device != x2.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise MXNetError(f"softmax_xent backward: {name} must be a "
                             f"contiguous {shape} f32 tensor on {x2.device}")
    dx = torch.empty_like(x2)
    if n and c:
        lib = _cc.load("softmax_xent")
        rc = lib.mx_xent_bwd(x2.data_ptr(), labels.data_ptr(),
                             stats.data_ptr(), g.data_ptr(), dx.data_ptr(),
                             n, c, code, _cc.stream_ptr(x2.device))
        _cc.check_launch(lib, rc, "softmax_xent backward")
        launches["bwd"] += 1
    return dx


class SoftmaxXentFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Saves the
    logits, the labels and the forward's row statistics, where the JAX
    custom VJP saves the logits and labels and recomputes softmax from
    scratch."""

    @staticmethod
    def forward(ctx, x2, labels):
        loss, stats = _xent_fwd(x2, labels)
        ctx.save_for_backward(x2, labels, stats)
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, labels, stats = ctx.saved_tensors
        return _xent_bwd(x2, labels, stats, g), None


def softmax_cross_entropy_fused(pred, label):
    """Per-row sparse-label cross entropy ``logsumexp(pred) - pred[label]``
    over the last axis; the leading shape is kept and the result is f32.
    ``label`` (float or int, ``pred.shape[:-1]`` elements) is cast to int32,
    as in JAX."""
    c = pred.shape[-1]
    lead = pred.shape[:-1]
    x2 = pred.reshape(-1, c).contiguous()
    lbl = torch.as_tensor(label, device=pred.device).reshape(-1) \
        .to(torch.int32).contiguous()
    if torch.is_grad_enabled() and pred.requires_grad:
        loss = SoftmaxXentFn.apply(x2, lbl)
    else:
        loss = _xent_fwd(x2, lbl)[0]
    return loss.reshape(lead)


from ..registry import register  # noqa: E402


@register("softmax_cross_entropy_fused")
def _softmax_cross_entropy_fused_op(pred, label, interpret=None):
    """``nd.softmax_cross_entropy_fused``: :func:`softmax_cross_entropy_fused`
    (the kernels on the card, the plain version on the CPU). ``interpret``,
    the JAX op's Pallas interpreter switch, has no meaning here and is
    ignored."""
    return softmax_cross_entropy_fused(pred, label)

"""Flash attention: the CUDA kernels ``csrc/flash_attention.cu`` (forward,
dK/dV and dQ) and their plain PyTorch versions.

Counterpart of ``mxnet_tpu/ops/flash_attention.py`` (``_fwd_kernel``,
``_bwd_dkv_kernel``, ``_bwd_dq_kernel``). Every kernel runs on the tensor
cores: bf16 in bf16, f32 in 3xTF32 (f32-accurate, not bit-identical to the
plain versions). The kernels read their operands by 16-byte copies, so the
wrappers refuse a tensor whose data is not 16-byte aligned.
Tensors are (B, H, T, D) at the public functions, as in the JAX package;
the kernels see them as contiguous (B·H, T, D) slices. The causal mask is
aligned bottom-right (query r sees keys c <= r + Tk - Tq); a query that
sees no key outputs 0 and stores lse = 0. :func:`flash_attention` is
differentiable through :class:`FlashAttention`, which saves (q, k, v, o,
lse) as the JAX custom VJP does. Each wrapper launches its kernel for
CUDA tensors and takes its plain version only for CPU tensors.

The JAX package engages flash only past a sequence crossover of 2048
(``_FLASH_MIN_SEQ``) and only for head dims that are a multiple of 64.
Both were TPU facts: the crossover was measured on a v5e, and the d % 64
rule comes from padding the head dim to 128 lanes. Neither applies to
the card, so :func:`flash_supported` admits every length and the head
dims the kernels are built for (``KERNEL_HEAD_DIMS``); the dispatch of
``ops.attention.multi_head_attention`` sends any other head dim to the
plain path. ``chip_smoke.py``
times the kernel against ``scaled_dot_product_attention`` at T = 1024 and
2048, from which a crossover, if there is one on the card, can be
re-derived.
"""
from __future__ import annotations

import math

import torch

from .. import config as _config
from ..analysis import audit as _audit
from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["flash_attention", "flash_supported", "FlashAttention",
           "flash_fwd_plain", "flash_bwd_plain", "chunked_attention",
           "chunked_attention_vjp", "KERNEL_HEAD_DIMS"]

#: head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 128)

#: kernel launches since the last reset (read by chip_smoke.py)
launches = {"fwd": 0, "dkv": 0, "dq": 0}

# the kernels' grid puts B·H on the y axis
_MAX_BH = 65535


def flash_supported(q, k, v, mask=None) -> bool:
    """Whether the kernels take these inputs: no mask, f32 or bf16 in one
    dtype, a head dim the kernels instantiate, any Tq and Tk."""
    if mask is not None:
        return False
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        return False
    b, h, tq, d = q.shape
    return (d in KERNEL_HEAD_DIMS and k.shape == v.shape
            and tuple(k.shape[:2]) == (b, h) and k.shape[3] == d
            and 0 < b * h <= _MAX_BH)


def _scores(q, k, causal):
    """f32 scores ``(q * scale) k^T`` and the live mask (None: all live)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if not causal:
        return s, None
    tq, tk = s.shape[-2], s.shape[-1]
    live = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
    return s.masked_fill(~live, float("-inf")), live


def flash_fwd_plain(q, k, v, causal, rounded=False):
    """Plain version of the forward kernel: exact f32-softmax attention.
    Returns ``(out, lse)``, out in q's dtype and lse (B, H, Tq) f32; a row
    with no live key gives out 0 and lse 0. With ``rounded`` and bf16
    inputs, the numerators exp(s - m) are rounded to bf16 before the
    product with v and the sum is divided by the f32 row sum l afterwards,
    as the bf16 tensor-core kernel does (f32 inputs: the exact math, which
    the f32 kernel's 3xTF32 products match to a few f32 ulps per sum)."""
    s, _ = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    dead = m == float("-inf")
    m = torch.where(dead, torch.zeros_like(m), m)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    lse = torch.where(dead, torch.zeros_like(m), m + torch.log(l))
    if rounded and q.dtype == torch.bfloat16:
        e, = _to_bf16(e)
        out = torch.matmul(e, v.float()) / torch.where(dead, torch.ones_like(l), l)
    else:
        p = torch.exp(s - lse).masked_fill(dead, 0.0)
        out = torch.matmul(p, v.float())
    return out.to(q.dtype), lse.squeeze(-1)


def _recompute(q, k, v, do, lse, di, causal):
    """The FA-2 recompute shared by both backward plain versions, as
    ``_bwd_recompute``: p = exp(s - lse) under the mask and
    ds = p (do v^T - di). Returns (p, ds), f32 (B, H, Tq, Tk)."""
    s, live = _scores(q, k, causal)
    p = torch.exp(s - lse.unsqueeze(-1))
    if live is not None:
        p = p.masked_fill(~live, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - di.unsqueeze(-1))


def _to_bf16(*ts):
    """Each f32 tensor rounded to bf16 (nearest even) and widened back."""
    return tuple(t.to(torch.bfloat16).float() for t in ts)


def _flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, rounded=False):
    """Plain version of the dK/dV kernel: exact f32 math by default. With
    ``rounded`` and bf16 inputs, p and ds are rounded to bf16 before the
    accumulating products and the scale is applied to dk at the end, as the
    bf16 tensor-core kernel does (f32 inputs: the exact math, which the f32
    kernel's 3xTF32 products match to a few f32 ulps per sum)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _recompute(q, k, v, do, lse, di, causal)
    if rounded and q.dtype == torch.bfloat16:
        p, ds = _to_bf16(p, ds)
        dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    else:
        dk = torch.matmul(ds.transpose(-1, -2), q.float() * scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_plain(q, k, v, do, lse, di, causal, rounded=False):
    """Plain version of the dQ kernel (``rounded`` as for dK/dV: ds is
    rounded to bf16 before the product)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _recompute(q, k, v, do, lse, di, causal)
    if rounded and q.dtype == torch.bfloat16:
        ds, = _to_bf16(ds)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def _row_dot(do, o):
    """di = rowsum(do * o) in f32 over the true head dim (plain tensor code
    outside the kernels, as in the JAX package)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd_plain(q, k, v, o, lse, do, causal):
    """Plain version of the backward: the FlashAttention-2 math of the two
    kernels written out in PyTorch from (q, k, v, o, lse, do). Returns
    (dq, dk, dv) in the inputs' dtypes."""
    di = _row_dot(do, o)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, di, causal)
    return _flash_bwd_dq_plain(q, k, v, do, lse, di, causal), dk, dv


def _check(q, k, v):
    _cc.check_device(q)
    if not flash_supported(q, k, v):
        raise MXNetError(
            f"flash attention kernels take f32 or bf16 q/k/v in one dtype "
            f"with head dim in {KERNEL_HEAD_DIMS} and matching (B, H); got "
            f"q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} {k.dtype}, "
            f"v {tuple(v.shape)} {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise MXNetError(f"{name} is on {t.device}, q on {q.device}")


def _check_aligned(**tensors):
    """Raise unless every tensor's data starts on a 16-byte boundary: the
    kernels copy their operands 16 bytes at a time (a view at an odd
    offset, e.g. ``x[1:]`` of an f32 tensor, is contiguous but not
    aligned). The C launchers refuse such pointers too."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise MXNetError(f"flash attention kernels need 16-byte aligned "
                             f"tensors; {name} starts at {t.data_ptr():#x}")


def _flash_fwd(q, k, v, causal, return_lse=False):
    """The forward: the kernel for CUDA tensors, the plain version for CPU
    tensors. Returns ``out`` or ``(out, lse)`` with lse (B, H, Tq) f32."""
    if _audit.recording():
        b, h, tq, d = q.shape
        outs = [(q.shape, q.dtype)] + ([((b, h, tq), torch.float32)]
                                       if return_lse else [])
        # the plain composition's two products over the full Tq x Tk
        got = _audit.record_kernel(
            (__name__, "fwd"), "flash_fwd_tc_kernel", [q, k, v], outs,
            flops=4.0 * b * h * tq * k.shape[2] * d)
        return tuple(got) if return_lse else got[0]
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, causal)
        return (out, lse) if return_lse else out
    _check(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel():
        lib = _cc.load("flash_attention")
        rc = lib.mx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, b * h, tq, tk, d,
            int(causal), _cc.dtype_code(q.dtype), _cc.stream_ptr(q.device))
        _cc.check_launch(lib, rc, "flash_fwd")
        launches["fwd"] += 1
    return (out, lse) if return_lse else out


def _bwd_args(q, k, v, do, lse, di, causal):
    """Checked, contiguous kernel arguments shared by both backward kernels:
    the six input pointers and the trailing scalars."""
    _check(q, k, v)
    b, h, tq, d = q.shape
    for name, t, shape in (("do", do, q.shape), ("lse", lse, (b, h, tq)),
                           ("di", di, (b, h, tq))):
        if tuple(t.shape) != tuple(shape) or t.device != q.device \
                or not t.is_contiguous():
            raise MXNetError(f"flash backward: {name} must be a contiguous "
                             f"{tuple(shape)} tensor on {q.device}")
    if do.dtype != q.dtype or lse.dtype != torch.float32 \
            or di.dtype != torch.float32:
        raise MXNetError("flash backward: do in q's dtype, lse and di f32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise MXNetError(f"flash backward kernels need a contiguous {name}")
    _check_aligned(q=q, k=k, v=v, do=do)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr())
    tail = (b * h, tq, k.shape[2], d, int(causal), _cc.dtype_code(q.dtype),
            _cc.stream_ptr(q.device))
    return ptrs, tail


def _bwd_flops(q, k):
    """Two of the plain backward's four products over the full Tq x Tk:
    each backward kernel's share of the FLOPs of the function it
    computes."""
    b, h, tq, d = q.shape
    return 4.0 * b * h * tq * k.shape[2] * d


def _bwd_dkv(q, k, v, do, lse, di, causal):
    """The dK/dV kernel (CUDA tensors; contiguous, do in q's dtype, lse and
    di f32). Returns (dk, dv)."""
    if _audit.recording():  # dV = P^T dO and dK = dS^T Q
        return tuple(_audit.record_kernel(
            (__name__, "dkv"), "flash_bwd_dkv_tc_kernel",
            [q, k, v, do, lse, di], [(k.shape, k.dtype), (v.shape, v.dtype)],
            flops=_bwd_flops(q, k)))
    ptrs, tail = _bwd_args(q, k, v, do, lse, di, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _cc.load("flash_attention")
    rc = lib.mx_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    _cc.check_launch(lib, rc, "flash_bwd_dkv")
    launches["dkv"] += 1
    return dk, dv


def _bwd_dq(q, k, v, do, lse, di, causal):
    """The dQ kernel (same arguments as :func:`_bwd_dkv`). Returns dq."""
    if _audit.recording():  # dP = dO V^T and dQ = dS K
        return _audit.record_kernel(
            (__name__, "dq"), "flash_bwd_dq_tc_kernel", [q, k, v, do, lse, di],
            [(q.shape, q.dtype)], flops=_bwd_flops(q, k))[0]
    ptrs, tail = _bwd_args(q, k, v, do, lse, di, causal)
    dq = torch.empty_like(q)
    lib = _cc.load("flash_attention")
    rc = lib.mx_flash_bwd_dq(*ptrs, dq.data_ptr(), *tail)
    _cc.check_launch(lib, rc, "flash_bwd_dq")
    launches["dq"] += 1
    return dq


def _flash_bwd(q, k, v, o, lse, do, causal):
    """The backward, counterpart of ``_flash_bwd_pallas``: the dK/dV and dQ
    kernels for CUDA tensors, the plain version for CPU tensors. Returns
    (dq, dk, dv). A recording (``analysis.audit``) takes the kernels' path
    on either device."""
    if q.device.type == "cpu" and not _audit.recording():
        return flash_bwd_plain(q, k, v, o, lse, do, causal)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.to(q.dtype).contiguous()
    di = _row_dot(do, o).contiguous()
    lse = lse.contiguous()
    dk, dv = _bwd_dkv(q, k, v, do, lse, di, causal)
    return _bwd_dq(q, k, v, do, lse, di, causal), dk, dv


def _chunk_body(qf, ks, vs, m, l, acc, start, causal, offset):
    """One key chunk of :func:`chunked_attention`'s online softmax: the
    carry (m, l, acc) updated by keys ``start .. start + chunk``."""
    s = torch.matmul(qf, ks.float().transpose(-1, -2))
    if causal:
        tq, chunk = s.shape[-2], s.shape[-1]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = start + torch.arange(chunk, device=s.device)[None, :]
        s = s.masked_fill(~(rows + offset >= cols), float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe),
                    torch.zeros_like(s))
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.matmul(p, vs.float())
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, causal, chunk=1024):
    """Memory-efficient attention (Rabe & Staats), the counterpart of
    ``_chunked_attention``: an online softmax over key chunks of the
    largest size ``<= chunk`` that divides Tk, in f32, the causal mask
    aligned bottom-right (offset ``Tk - Tq``). Each chunk's body runs under
    ``torch.utils.checkpoint`` when a gradient is recorded, as the JAX body
    under ``jax.checkpoint``: its backward keeps the (B, H, Tq, D) carries
    and recomputes one (B, H, Tq, chunk) score block at a time, never the
    (B, H, Tq, Tk) matrix. The result is in q's dtype."""
    from torch.utils.checkpoint import checkpoint

    b, h, tq, d = q.shape
    tk = k.shape[2]
    chunk = min(int(chunk), tk)
    chunk = next(c for c in range(chunk, 0, -1) if tk % c == 0)
    qf = q.float() * (1.0 / d ** 0.5)
    m = torch.full((b, h, tq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, tq, 1), device=q.device)
    acc = torch.zeros((b, h, tq, d), device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for start in range(0, tk, chunk):
        args = (qf, k[:, :, start:start + chunk], v[:, :, start:start + chunk],
                m, l, acc, start, causal, tk - tq)
        m, l, acc = checkpoint(_chunk_body, *args, use_reentrant=False) \
            if remat else _chunk_body(*args)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)


def chunked_attention_vjp(q, k, v, do, causal):
    """``(dq, dk, dv)``: the VJP of :func:`chunked_attention` at cotangent
    ``do``, each in its input's dtype (the JAX escape hatch's backward)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = chunked_attention(*leaves, causal)
        return torch.autograd.grad(out, leaves, do.to(out.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention with the FlashAttention-2 backward. The forward saves
    (q, k, v, o, lse), as ``_flash_vjp_fwd``; the backward takes the kernels
    when the ``flash_pallas_bwd`` knob is on (the default) and, when it is
    off, the JAX escape hatch: the VJP of :func:`chunked_attention`, whose
    memory grows as Tq·chunk (``flash_bwd_plain``, the kernels' plain
    version, builds the (B, H, Tq, Tk) scores)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_fwd(q, k, v, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if _config.get("flash_pallas_bwd"):
            dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.causal)
        else:
            dq, dk, dv = chunked_attention_vjp(q, k, v, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, mask=None, causal=False):
    """Flash attention over (B, H, T, D) tensors; the result in q's dtype.
    ``mask`` is not taken (callers route masked attention elsewhere). The
    lse residual is computed only when a gradient will be asked for."""
    if mask is not None:
        raise ValueError("flash_attention does not take arbitrary masks; use "
                         "multi_head_attention, which routes them to the "
                         "plain einsum path")
    causal = bool(causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal)

"""Attention operators of the serving and training paths.

Counterpart of ``mxnet_tpu/ops/attention.py``: the cache allocators, the
dense and paged cached paths and the ``multi_head_attention`` dispatch
(flash kernels for unmasked full-sequence attention, the plain einsum path
for masked attention), and the interleaved-projection ops of GluonNLP's
BERT attention cell (``_contrib_div_sqrt_dim``,
``_contrib_interleaved_matmul_{selfatt,encdec}_{qk,valatt}``) with MXNet's
layouts: projections (T, B, H·3·Ch) or (T, B, H·2·Ch) interleaved per
head, scores (B·H, Tq, Tk), outputs (T, B, H·Ch). Their products are
``torch.matmul``, as the JAX package leaves them to XLA.
Tensors are (B, H, T, Ch) as in the JAX package. Caches are updated in
place (the analog of the JAX engine's donated carry) and returned.
"""
from __future__ import annotations

import math

import torch

from .. import config as _config
from ..base import dtype_torch, resolve_device
from ..contrib import amp as _amp
from . import flash_attention as fa
from . import paged_attention as pa

__all__ = ["alloc_kv_cache", "alloc_paged_kv_cache", "multi_head_attention",
           "attention_route", "div_sqrt_dim", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt", "interleaved_matmul_encdec_qk",
           "interleaved_matmul_encdec_valatt"]


def alloc_kv_cache(batch_size, num_heads, max_length, channels, num_layers,
                   dtype="float32", device="cuda"):
    """Per-layer ``(k_buf, v_buf)`` zero buffers of shape (B, H, Tmax, Ch)."""
    shape = (int(batch_size), int(num_heads), int(max_length), int(channels))
    dt, device = dtype_torch(dtype), resolve_device(device)
    return [(torch.zeros(shape, dtype=dt, device=device),
             torch.zeros(shape, dtype=dt, device=device))
            for _ in range(int(num_layers))]


def alloc_paged_kv_cache(num_pages, num_heads, page_size, channels,
                         num_layers, dtype="float32", device="cuda"):
    """Per-layer ``(k_pool, v_pool)`` page pools of shape
    (num_pages + 1, H, page_size, Ch). Page 0 is the reserved trash page:
    table entries of released and past-capacity rows are 0, so their writes
    land there instead of in live pages."""
    shape = (int(num_pages) + 1, int(num_heads), int(page_size), int(channels))
    dt, device = dtype_torch(dtype), resolve_device(device)
    return [(torch.zeros(shape, dtype=dt, device=device),
             torch.zeros(shape, dtype=dt, device=device))
            for _ in range(int(num_layers))]


def _identity_table(batch, device):
    return torch.arange(batch, dtype=torch.int32, device=device)[:, None]


def _read(q, k_pool, v_pool, page_table, position):
    """The cached read: the kernel wrapper, or the plain version when the
    ``paged_attention_kernel`` knob is off."""
    q = q.contiguous()
    if _config.get("paged_attention_kernel"):
        return pa.paged_attention_read(q, k_pool, v_pool, page_table, position)
    return pa.paged_attention_read_plain(q, k_pool, v_pool, page_table,
                                         position)


def _frontier_masked_attention(q, k_hist, v_hist, position):
    """Every query at row position ``position + i`` attends to history
    entries ``<= position + i``: the plain version over contiguous
    (B, H, T, Ch) histories, viewed as one page per row."""
    return pa.paged_attention_read_plain(
        q, k_hist, v_hist, _identity_table(q.shape[0], q.device), position)


def _cached_mha(q, k_new, v_new, k_buf, v_buf, position):
    """Incremental attention against static (B, H, Tmax, Ch) buffers.

    The new K/V land in the buffers first, at each row's own offset. As
    with ``jax.lax.dynamic_update_slice``, the offset is clamped so that
    the chunk fits: a finished row decoding at ``position == Tmax`` writes
    its (discarded) token into slot ``Tmax - 1`` of its own row instead of
    failing. The read is the paged read over the buffers viewed as a pool
    of B pages of Tmax slots (identity table), so dense and paged caches
    share one kernel and one op order."""
    b, h, tq, ch = k_new.shape
    tmax = k_buf.shape[2]
    start = position.long().clamp(0, tmax - tq)
    tidx = start[:, None] + torch.arange(tq, device=k_new.device)
    bidx = torch.arange(b, device=k_new.device)[:, None]
    k_buf[bidx, :, tidx] = k_new.transpose(1, 2).to(k_buf.dtype)
    v_buf[bidx, :, tidx] = v_new.transpose(1, 2).to(v_buf.dtype)
    out = _read(q, k_buf, v_buf, _identity_table(b, q.device), position)
    return out, k_buf, v_buf


def _paged_cached_mha(q, k_new, v_new, k_pool, v_pool, page_table, position):
    """Incremental attention against a paged KV pool (P+1, H, ps, Ch) with
    per-row page tables (B, n_pages): scatter the new tokens (overflow to
    the trash page), then read only the pages each row's table names."""
    pa.scatter_tokens(k_new, v_new, k_pool, v_pool, page_table, position)
    out = _read(q, k_pool, v_pool, page_table, position)
    return out, k_pool, v_pool


def _reference_mha(q, k, v, mask=None, causal=False):
    """Plain O(L^2) attention; q, k, v (B, H, T, Ch); f32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqc,bhkc->bhqk", q, k).float() * scale
    if causal:
        t_q, t_k = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((t_q, t_k), dtype=torch.bool,
                        device=q.device).tril(t_k - t_q)
        scores = scores.masked_fill(~cm, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(), float("-inf"))
    att = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkc->bhqc", att, v)


def attention_route(q, k, v, mask=None, use_flash="auto") -> str:
    """``"flash"`` or ``"plain"``: the path a full-sequence
    :func:`multi_head_attention` call takes for these (already AMP-cast)
    inputs. ``"auto"`` sends a call to the flash kernels when there is no
    mask, the ``flash_attention`` knob is on, q is f32 or bf16 and its head
    dim is one the kernels are built for (``KERNEL_HEAD_DIMS``). float16 or
    a head dim of 32 takes the plain path by rule, as the JAX gate sends
    ``d % 64 != 0`` to its einsum path. Nothing else is asked here: inputs
    the kernels cannot launch on (mixed dtypes, too many B·H) go to flash
    and raise there, as does an explicit ``use_flash=True`` on a CUDA
    tensor the kernels do not take."""
    if use_flash == "auto":
        # no sequence-length crossover here: see ops/flash_attention.py
        use_flash = mask is None and _config.get("flash_attention") \
            and q.dtype in (torch.float32, torch.bfloat16) \
            and q.shape[-1] in fa.KERNEL_HEAD_DIMS
    return "flash" if use_flash else "plain"


def multi_head_attention(q, k, v, mask=None, causal=False, cache=None,
                         position=None, page_table=None, use_flash="auto"):
    """Scaled-dot-product attention over (B, H, T, Ch) tensors.

    ``cache=(k_buf, v_buf), position=`` switches to the cached path: k/v
    carry only the new positions, and the call returns ``(out, k_buf,
    v_buf)``. With ``page_table=`` the cache entries are page pools.
    A full-sequence call takes the flash kernels when ``use_flash`` says
    so (:func:`attention_route`: ``"auto"`` takes the kernels for unmasked
    inputs they are built for). An explicit ``use_flash=True`` on a CUDA
    tensor the kernels do not take raises. Under a global ``amp.init`` dtype every call casts f32 q,
    k and v to it before it branches, as the JAX package does: a cached
    call then reads with low-precision q and writes the new K/V into the
    cache in the cache's dtype (a bf16 value widened into an f32 pool is
    exact). Scores and softmax are f32 on every path; the result is the
    caller's q dtype."""
    orig_dtype = q.dtype
    q, k, v = _amp.cast_inputs(q, k, v)
    if cache is not None:
        if position is None:
            raise ValueError("multi_head_attention(cache=...) needs position=")
        k_buf, v_buf = cache
        position = torch.as_tensor(position, dtype=torch.int32,
                                   device=q.device)
        if position.dim() == 0:
            position = position.expand(q.shape[0])
        position = position.contiguous()
        if page_table is not None:
            table = page_table.to(dtype=torch.int32).contiguous()
            out, k_buf, v_buf = _paged_cached_mha(q, k, v, k_buf, v_buf,
                                                  table, position)
        else:
            out, k_buf, v_buf = _cached_mha(q, k, v, k_buf, v_buf, position)
        return out.to(orig_dtype), k_buf, v_buf
    if attention_route(q, k, v, mask, use_flash) == "flash":
        out = fa.flash_attention(q, k, v, mask=mask, causal=causal)
    else:
        out = _reference_mha(q, k, v, mask=mask, causal=causal)
    return out.to(orig_dtype)


from ..registry import register  # noqa: E402

register("multi_head_attention",
         aliases=("_contrib_multi_head_attention",))(multi_head_attention)


# -- the interleaved-projection ops (the JAX ops/attention.py:25-93) ----
def _inv_sqrt(ch, dtype):
    """``1 / sqrt(ch)`` computed in f32 and rounded to ``dtype``, as the JAX
    ops scale."""
    return torch.tensor(1.0 / math.sqrt(ch), dtype=torch.float32).to(dtype)


def _promoted_matmul(a, b):
    """``a @ b`` in the promoted dtype of the two, as ``jnp.einsum``."""
    ct = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(ct), b.to(ct))


def div_sqrt_dim(data):
    """``data / sqrt(data.shape[-1])``."""
    return data / torch.tensor(math.sqrt(data.shape[-1]),
                               dtype=torch.float32).to(data.dtype)


def _split_interleaved_qkv(qkv, heads):
    """(T, B, H·3·Ch) interleaved per head -> q, k, v, each (B, H, T, Ch)."""
    t, b, hc3 = qkv.shape
    x = qkv.reshape(t, b, heads, 3, hc3 // (heads * 3)).permute(3, 1, 2, 0, 4)
    return x[0], x[1], x[2]


def interleaved_matmul_selfatt_qk(qkv, heads=1):
    """Scores ``(q / sqrt(Ch)) k^T``, (B·H, T, T), in the caller's dtype;
    the product in the AMP compute dtype when ``amp.init`` set one (the JAX
    op's ``cast_inputs``)."""
    orig = qkv.dtype
    qkv, = _amp.cast_inputs(qkv)
    q, k, _ = _split_interleaved_qkv(qkv, int(heads))
    scores = torch.matmul(q * _inv_sqrt(q.shape[-1], q.dtype),
                          k.transpose(-1, -2))
    b, h, t, _ = scores.shape
    return scores.reshape(b * h, t, t).to(orig)


def interleaved_matmul_selfatt_valatt(qkv, att, heads=1):
    """``att @ v`` as (T, B, H·Ch), with att (B·H, T, T)."""
    _, _, v = _split_interleaved_qkv(qkv, int(heads))
    b, h, t, ch = v.shape
    out = _promoted_matmul(att.reshape(b, h, t, t), v)
    return out.permute(2, 0, 1, 3).reshape(t, b, h * ch)


def _kv_heads(kv_proj, heads):
    """(Tk, B, H·2·Ch) interleaved per head -> k, v, each (B, H, Tk, Ch)."""
    tk, b, hc2 = kv_proj.shape
    x = kv_proj.reshape(tk, b, heads, 2, hc2 // (2 * heads))
    return x.permute(3, 1, 2, 0, 4).unbind(0)


def interleaved_matmul_encdec_qk(q_proj, kv_proj, heads=1):
    """Cross-attention scores ``(q / sqrt(Ch)) k^T``, (B·H, Tq, Tk), from
    q (Tq, B, H·Ch) and the interleaved (Tk, B, H·2·Ch) projection."""
    heads = int(heads)
    tq, b, hc = q_proj.shape
    ch = hc // heads
    q = q_proj.reshape(tq, b, heads, ch).permute(1, 2, 0, 3)
    k, _ = _kv_heads(kv_proj, heads)
    scores = _promoted_matmul(q * _inv_sqrt(ch, q.dtype), k.transpose(-1, -2))
    return scores.reshape(b * heads, tq, k.shape[2])


def interleaved_matmul_encdec_valatt(kv_proj, att, heads=1):
    """``att @ v`` as (Tq, B, H·Ch), with att (B·H, Tq, Tk)."""
    heads = int(heads)
    _, v = _kv_heads(kv_proj, heads)
    b, _, tk, ch = v.shape
    tq = att.shape[1]
    out = _promoted_matmul(att.reshape(b, heads, tq, tk), v)
    return out.permute(2, 0, 1, 3).reshape(tq, b, heads * ch)


register("_contrib_div_sqrt_dim")(div_sqrt_dim)
register("_contrib_interleaved_matmul_selfatt_qk")(
    interleaved_matmul_selfatt_qk)
register("_contrib_interleaved_matmul_selfatt_valatt")(
    interleaved_matmul_selfatt_valatt)
register("_contrib_interleaved_matmul_encdec_qk")(
    interleaved_matmul_encdec_qk)
register("_contrib_interleaved_matmul_encdec_valatt")(
    interleaved_matmul_encdec_valatt)

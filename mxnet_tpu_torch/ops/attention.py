"""Attention operators of the serving and training paths.

Counterpart of ``mxnet_tpu/ops/attention.py``: the cache allocators, the
dense and paged cached paths and the ``multi_head_attention`` dispatch
(flash kernels for unmasked full-sequence attention, the plain einsum path
for masked attention).
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

__all__ = ["alloc_kv_cache", "alloc_paged_kv_cache", "multi_head_attention"]


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


def multi_head_attention(q, k, v, mask=None, causal=False, cache=None,
                         position=None, page_table=None, use_flash="auto"):
    """Scaled-dot-product attention over (B, H, T, Ch) tensors.

    ``cache=(k_buf, v_buf), position=`` switches to the cached path: k/v
    carry only the new positions, and the call returns ``(out, k_buf,
    v_buf)``. With ``page_table=`` the cache entries are page pools.
    A full-sequence call takes the flash kernels when ``use_flash`` says
    so; ``"auto"`` means: no mask, the ``flash_attention`` knob on and f32
    or bf16 inputs (float16 takes the einsum path, as the JAX gate sends
    it there). On a CUDA tensor the flash path raises for what the kernels
    do not take (:func:`flash_attention.flash_supported`) instead of
    falling back. Under a global ``amp.init`` dtype every call casts f32 q,
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
    if use_flash == "auto":
        # no sequence-length crossover here: see ops/flash_attention.py
        use_flash = mask is None and _config.get("flash_attention") \
            and q.dtype in (torch.float32, torch.bfloat16)
    if use_flash:
        out = fa.flash_attention(q, k, v, mask=mask, causal=causal)
    else:
        out = _reference_mha(q, k, v, mask=mask, causal=causal)
    return out.to(orig_dtype)

"""Paged cached attention: the CUDA kernel ``csrc/paged_attention.cu`` and
its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_paged_attention.py``
(``_paged_kernel``). The token scatter into the pools is plain PyTorch, as
in the JAX wrapper; only the read (page lookup + frontier-masked f32
softmax attention) is the kernel. :func:`paged_attention_read` launches the
kernel for CUDA tensors and takes :func:`paged_attention_read_plain` only
for CPU tensors.

The read serves the dense cache too: a contiguous (B, H, Tmax, Ch) buffer
is a pool of B pages of ``Tmax`` slots under the identity table
``arange(B)[:, None]``. The kernel walks keys in fixed tiles of logical key
index, and the plain version cuts each row's history at its frontier, so
neither depends on the page size: dense and paged logits are bit-identical
by construction, on the card and on the CPU.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import cuda_common as _cc

__all__ = ["paged_attention", "paged_attention_read",
           "paged_attention_read_plain", "scatter_tokens"]

#: head widths the kernel is instantiated for
KERNEL_CHANNELS = (16, 32, 64, 128)

#: kernel launches since the last reset (read by chip_smoke.py)
launches = 0


def scatter_tokens(k_new, v_new, k_pool, v_pool, page_table, position):
    """Write the Tq new K/V of each row into ``pool[table[pos // ps], :,
    pos % ps]`` in place. Positions past the table's capacity go to the
    trash page 0; several such tokens may land on the same trash slot,
    which is harmless (its content is never read unmasked)."""
    b, h, tq, ch = k_new.shape
    ps = k_pool.shape[2]
    n_pages = page_table.shape[1]
    cap = n_pages * ps
    pos = position.long()[:, None] + torch.arange(tq, device=k_new.device)
    slot = (pos // ps).clamp(0, n_pages - 1)
    pid = torch.gather(page_table.long(), 1, slot)
    pid = torch.where(pos < cap, pid, torch.zeros_like(pid))  # overflow -> trash
    pid_f, off_f = pid.reshape(-1), (pos % ps).reshape(-1)
    # (B, H, Tq, Ch) -> (B*Tq, H, Ch) token-major values
    k_pool[pid_f, :, off_f] = k_new.transpose(1, 2).reshape(b * tq, h, ch) \
        .to(k_pool.dtype)
    v_pool[pid_f, :, off_f] = v_new.transpose(1, 2).reshape(b * tq, h, ch) \
        .to(v_pool.dtype)


def paged_attention_read_plain(q, k_pool, v_pool, page_table, position):
    """Plain version of the kernel: per row, gather only the pages up to
    the row's furthest frontier, cut the history there, and run the
    frontier-masked f32 softmax attention (the JAX
    ``_frontier_masked_attention`` math). Returns (B, H, Tq, Ch) in the
    promoted dtype of q and the pool."""
    b, h, tq, ch = q.shape
    ps = k_pool.shape[2]
    cap = page_table.shape[1] * ps
    scale = 1.0 / math.sqrt(ch)
    ct = torch.promote_types(q.dtype, k_pool.dtype)
    out_dt = torch.promote_types(q.dtype, v_pool.dtype)
    table = page_table.long().cpu()
    outs = []
    for row, p in enumerate(position.tolist()):
        n_keys = max(1, min(int(p) + tq, cap))
        pages = table[row, :-(-n_keys // ps)].clamp(0, k_pool.shape[0] - 1) \
            .to(k_pool.device)
        # (n, H, ps, Ch) -> (H, n*ps, Ch), cut at the frontier
        k = k_pool[pages].transpose(0, 1).reshape(h, -1, ch)[:, :n_keys]
        v = v_pool[pages].transpose(0, 1).reshape(h, -1, ch)[:, :n_keys]
        scores = torch.einsum("hqc,hkc->hqk", q[row].to(ct),
                              k.to(ct).contiguous()).float() * scale
        key_idx = torch.arange(n_keys, device=q.device)[None, :]
        q_pos = int(p) + torch.arange(tq, device=q.device)[:, None]
        scores = scores.masked_fill(key_idx > q_pos, float("-inf"))
        att = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("hqk,hkc->hqc", att.to(out_dt),
                                 v.to(out_dt).contiguous()))
    return torch.stack(outs)


def _check(q, k_pool, v_pool, page_table, position):
    _cc.check_device(q)
    b, h, tq, ch = q.shape
    if ch not in KERNEL_CHANNELS:
        raise MXNetError(f"paged_attention kernel takes head width in "
                         f"{KERNEL_CHANNELS}, got {ch}")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4 \
            or k_pool.shape[1] != h or k_pool.shape[3] != ch:
        raise MXNetError(f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_pool.dtype != v_pool.dtype:
        raise MXNetError("k_pool and v_pool dtypes differ")
    if (q.dtype, k_pool.dtype) not in ((torch.float32, torch.float32),
                                       (torch.float32, torch.bfloat16),
                                       (torch.bfloat16, torch.bfloat16)):
        raise MXNetError(f"paged_attention kernel takes (q, pool) dtypes "
                         f"f32/f32, f32/bf16 or bf16/bf16, got {q.dtype}/"
                         f"{k_pool.dtype}")
    if page_table.dtype != torch.int32 or position.dtype != torch.int32:
        raise MXNetError("page_table and position must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or tuple(position.shape) != (b,):
        raise MXNetError(f"page_table {tuple(page_table.shape)} / position "
                         f"{tuple(position.shape)} do not match batch {b}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("position", position)):
        if t.device != q.device:
            raise MXNetError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise MXNetError(f"paged_attention kernel needs a contiguous {name}")


def paged_attention_read(q, k_pool, v_pool, page_table, position):
    """Frontier-masked attention of ``q`` (B, H, Tq, Ch) over the keys each
    row's ``page_table`` (B, n_pages) names in the pools (P+1, H, ps, Ch).
    Query i of row b attends keys ``<= position[b] + i``. Returns
    (B, H, Tq, Ch) in ``q.dtype`` (the kernel) or the promoted dtype (the
    plain version, CPU tensors only).

    The read has no backward: the cached paths serve, under no_grad or
    inference mode. With grad mode on and an input that requires grad it
    raises, on either device, rather than return a result cut off from
    the graph."""
    global launches
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        raise MXNetError("paged_attention_read has no backward; run the "
                         "cached paths under torch.no_grad() or "
                         "torch.inference_mode()")
    if q.device.type == "cpu":
        return paged_attention_read_plain(q, k_pool, v_pool, page_table,
                                          position)
    _check(q, k_pool, v_pool, page_table, position)
    b, h, tq, ch = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _cc.load("paged_attention")
    rc = lib.mx_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), position.data_ptr(), out.data_ptr(),
        b, h, tq, ch, k_pool.shape[2], page_table.shape[1], k_pool.shape[0],
        _cc.dtype_code(q.dtype), _cc.dtype_code(k_pool.dtype),
        _cc.stream_ptr(q.device))
    _cc.check_launch(lib, rc, "paged_attention")
    launches += 1
    return out


def paged_attention(q, k_new, v_new, k_pool, v_pool, page_table, position):
    """Scatter the new K/V into the pools (in place), then read. Returns
    ``(out, k_pool, v_pool)``, the pools being the updated inputs."""
    scatter_tokens(k_new, v_new, k_pool, v_pool, page_table, position)
    out = paged_attention_read(q, k_pool, v_pool, page_table, position)
    return out, k_pool, v_pool

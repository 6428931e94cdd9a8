"""Paged cached attention: the CUDA kernel ``csrc/paged_attention.cu`` and
its plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_paged_attention.py``
(``_paged_kernel``). The token scatter into the pools is plain PyTorch, as
in the JAX wrapper; only the read (page lookup + frontier-masked f32
softmax attention) is the kernel. :func:`paged_attention_read` launches the
kernel for CUDA tensors and takes :func:`paged_attention_read_plain` only
for CPU tensors. The kernel reads a decode step (one query a row) on the
CUDA cores, split over the key range when the batch is small, and a
prefill chunk on the tensor cores in 3xTF32 (f32-accurate), 64 queries a
block.

The read serves the dense cache too: a contiguous (B, H, Tmax, Ch) buffer
is a pool of B pages of ``Tmax`` slots under the identity table
``arange(B)[:, None]``. The kernel walks keys in fixed tiles of logical key
index, cut into splits whose boundaries :func:`_split_plan` sets from the
query count and the batch alone, and the plain version cuts each row's
history at its frontier, so neither depends on the page size: dense and
paged logits are bit-identical by construction, on the card and on the CPU.
"""
from __future__ import annotations

import math

import torch

from ..analysis import audit as _audit
from ..base import MXNetError
from . import cuda_common as _cc
from . import cuda_graph as _cg

__all__ = ["paged_attention", "paged_attention_read",
           "paged_attention_read_plain", "scatter_tokens"]

#: head widths the kernel is instantiated for
KERNEL_CHANNELS = (16, 32, 64, 128)

#: kernel launches since the last reset, decode reads (Tq = 1) and prefill
#: reads (Tq > 1) apart (read by chip_smoke.py)
launches = {"decode": 0, "prefill": 0}

#: logical keys of one split of the key range (flash-decoding): 4 tiles of
#: 32 keys, one a warp. At gpt2_345m's serve shape (B=8, 16 heads, 512 live
#: keys) that is 4 live splits for each of the 128 (row, head) pairs, 512
#: blocks of 4 warps over the H100's 132 SMs
SPLIT_KEYS = 128
#: one split covering every key (a multiple of 128 past any capacity)
_WHOLE = 1 << 30
#: (row, head) decode blocks from which the read does not split: a few per
#: SM of the H100's 132
_SPLIT_BELOW = 4 * 132

# per (device, stream): int32 arrival counters of the split combine, all
# zero between reads (the kernel sets each back to 0), so reads in stream
# order share them; grown on demand
_arrivals = {}


def _split_plan(cap, tq, bh):
    """``(split_keys, n_splits)`` of a read of ``tq`` queries for ``bh``
    (row, head) pairs over a table of ``cap`` = n_pages * ps keys. Split s
    covers logical keys [s * split_keys, (s + 1) * split_keys); the kernel
    works only on the splits up to each block's frontier, so the
    boundaries depend on ``tq`` and ``bh`` only, not on the page size: a
    larger ``cap`` adds only splits past every frontier. A decode read
    (``tq`` 1) splits when its (row, head) blocks are too few to fill the
    card. A prefill read (the tensor-core kernel, 64 queries a block) never
    splits: on the H100 one split was as fast as 128- or 256-key splits or
    faster at every shape measured, one to eight rows of 128 to 512
    queries (PERF.md)."""
    if tq > 1 or bh >= _SPLIT_BELOW:
        return _WHOLE, 1
    return SPLIT_KEYS, max(1, -(-cap // SPLIT_KEYS))


def _arrival_counters(device, stream, n):
    """At least ``n`` zeroed int32 counters for the split merge of a read
    on ``stream`` of ``device``. Eager reads share one cached buffer per
    stream (stream order keeps them apart). A step graph's capture takes
    counters of its own (``cuda_graph.owned``), allocated outside its memory
    pool, held as long as the graph and zeroed after the capture, so that
    graphs replayed on different streams, or beside an eager read, never
    share counters."""
    cache, key = _arrivals, (device, stream)
    if _cg.capturing():
        cache, key = _cg.owned(), "arrivals"
    buf = cache.get(key)
    if buf is None or buf.numel() < n:
        if _cg.capturing():
            buf = _cg.persistent_empty((max(n, 1024),), torch.int32)
            _cg.after_capture(buf.zero_)
        else:
            buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        cache[key] = buf
    return buf


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
    ``_frontier_masked_attention`` math): scores in the promoted dtype of q
    and the pool, softmax in f32, the weights rounded to q's dtype, the
    weighted sum in the promoted dtype of q and the pool. Returns
    (B, H, Tq, Ch) in q's dtype, as the kernel and the TPU kernel's
    ``out_shape``."""
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
    return torch.stack(outs).to(q.dtype)


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
    lp = (torch.float32, torch.bfloat16)
    if not (q.dtype in lp and k_pool.dtype in lp
            or (q.dtype, k_pool.dtype) == (torch.float16, torch.float32)):
        raise MXNetError(f"paged_attention kernel takes f32 or bf16 q and "
                         f"pools in any pair, or f16 q over f32 pools, got "
                         f"{q.dtype}/{k_pool.dtype}")
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
    Query i of row b attends keys ``<= position[b] + i``. q and the pools
    are f32 or bf16 in any pair, or f16 q over f32 pools: an f32 model's
    cached read under ``amp.init("bfloat16")`` or ``amp.init("float16")``
    gives low-precision q over f32 pools. Returns (B, H, Tq, Ch) in
    ``q.dtype``.

    The read has no backward: the cached paths serve, under no_grad or
    inference mode. With grad mode on and an input that requires grad it
    raises, on either device, rather than return a result cut off from
    the graph."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_pool, v_pool)):
        raise MXNetError("paged_attention_read has no backward; run the "
                         "cached paths under torch.no_grad() or "
                         "torch.inference_mode()")
    if _audit.recording():
        b, h, tq, ch = q.shape
        if q.numel() == 0:
            return torch.empty_like(q)
        # the plain read's two products over every key the table names,
        # and the split merge's partials, as the launch allocates them
        keys = page_table.shape[1] * k_pool.shape[2]
        n_splits = _split_plan(keys, tq, b * h)[1]
        return _audit.record_kernel(
            (__name__, "decode" if tq == 1 else "prefill"),
            "paged_attention_kernel" if tq == 1 else "paged_prefill_tc_kernel",
            [q, k_pool, v_pool, page_table, position], [(q.shape, q.dtype)],
            flops=4.0 * b * h * tq * keys * ch,
            scratch=[((b * h * tq, n_splits, ch + 2), torch.float32)]
            if n_splits > 1 else [])[0]
    if q.device.type == "cpu":
        return paged_attention_read_plain(q, k_pool, v_pool, page_table,
                                          position)
    _check(q, k_pool, v_pool, page_table, position)
    b, h, tq, ch = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ps, n_pages = k_pool.shape[2], page_table.shape[1]
    split_keys, n_splits = _split_plan(n_pages * ps, tq, b * h)
    stream = _cc.stream_ptr(q.device)
    part = arrivals = None
    if n_splits > 1:
        part = torch.empty((b * h * tq, n_splits, ch + 2), dtype=torch.float32,
                           device=q.device)
        arrivals = _arrival_counters(q.device, stream, b * h)
    lib = _cc.load("paged_attention")
    rc = lib.mx_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), position.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(),
        b, h, tq, ch, ps, n_pages, k_pool.shape[0], split_keys, n_splits,
        _cc.dtype_code(q.dtype), _cc.dtype_code(k_pool.dtype), stream)
    _cc.check_launch(lib, rc, "paged_attention")
    launches["decode" if tq == 1 else "prefill"] += 1
    return out


def paged_attention(q, k_new, v_new, k_pool, v_pool, page_table, position):
    """Scatter the new K/V into the pools (in place), then read. Returns
    ``(out, k_pool, v_pool)``, the pools being the updated inputs."""
    scatter_tokens(k_new, v_new, k_pool, v_pool, page_table, position)
    out = paged_attention_read(q, k_pool, v_pool, page_table, position)
    return out, k_pool, v_pool

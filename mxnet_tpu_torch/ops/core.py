"""Creation, slicing and indexing operators of the BERT path.

Counterpart of the subset of ``mxnet_tpu/ops/core.py`` that BERT uses:
``arange``, ``slice_axis``, ``stack``, ``gather_nd``, ``one_hot`` and
``pick``. The index semantics are the JAX package's: ``gather_nd`` wraps a
negative index once and clamps the rest into range, dropping their
gradient (``jnp`` indexing), ``one_hot`` gives an all-zero row for an
index outside ``[0, depth)`` (``jax.nn.one_hot``) and ``pick`` clips. On
the card an out-of-range index in torch indexing is a device-side assert,
so every index is brought into range before it is used.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch, resolve_device

__all__ = ["arange", "slice_axis", "stack", "gather_nd", "one_hot", "pick"]


def arange(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
           device="cuda"):
    """``[start, stop)`` in steps of ``step`` (``arange(n)`` is
    ``[0, n)``), each value ``repeat`` times, on ``device``."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                       device=resolve_device(device))
    if repeat != 1:
        out = out.repeat_interleave(int(repeat))
    return out


def slice_axis(x, axis, begin, end):
    """``x[..., begin:end, ...]`` along ``axis`` (``end`` None: to the end;
    negative bounds count from the end), a view."""
    axis = int(axis) % x.dim()
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


def stack(*xs, axis=0):
    """Join equally shaped tensors along a new ``axis``."""
    return torch.stack(xs, dim=int(axis))


def gather_nd(data, indices):
    """``data[indices[0], ..., indices[K-1]]``: ``indices`` (K, ...) index
    the first K axes of ``data``, and the result has the shape of
    ``indices.shape[1:]`` followed by ``data.shape[K:]``.

    As ``jnp`` indexing: a negative index counts from the end once, and an
    index still outside the axis reads the nearest end, while its gradient
    is dropped (the forward gather clamps, its transpose, a scatter-add,
    drops out-of-range updates)."""
    idx, inside = [], None
    for k, ix in enumerate(indices.unbind(0)):
        n = data.shape[k]
        ix = ix.long()
        ix = torch.where(ix < 0, ix + n, ix)
        ok = (ix >= 0) & (ix < n)
        inside = ok if inside is None else inside & ok
        idx.append(ix.clamp(0, n - 1))
    out = data[tuple(idx)]
    if inside is None:
        return out
    inside = inside.reshape(inside.shape + (1,) * (out.dim() - inside.dim()))
    return torch.where(inside, out, out.detach())


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """A trailing axis of ``depth``: ``on_value`` at each index,
    ``off_value`` elsewhere; a row whose index lies outside ``[0, depth)``
    is all ``off_value``."""
    depth = int(depth)
    idx = indices.long()
    inside = (idx >= 0) & (idx < depth)
    oh = torch.nn.functional.one_hot(idx.clamp(0, depth - 1), depth)
    oh = (oh * inside.unsqueeze(-1)).to(dtype_torch(dtype))
    return oh * (on_value - off_value) + off_value


def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s element at ``index`` along ``axis``; the index is clipped
    into range (``mode="clip"``, the only mode the JAX package has)."""
    if mode != "clip":
        raise ValueError(f"pick: mode {mode!r} is not supported, only 'clip'")
    ax = int(axis) % data.dim()
    idx = index.long().unsqueeze(ax).clamp(0, data.shape[ax] - 1)
    out = torch.gather(data, ax, idx)
    return out if keepdims else out.squeeze(ax)

"""``gluon.utils``: ``split_data``, ``split_and_load``,
``clip_global_norm`` and ``check_sha1``.

Counterpart of ``mxnet_tpu/gluon/utils.py``. The port runs on one device,
so ``split_and_load`` given one context returns a list of one array on it;
given several it splits along ``batch_axis`` and places each slice on its
context. ``download`` is not ported: the port fetches nothing."""
from __future__ import annotations

import hashlib
import math
import warnings

import torch

from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last takes
    the remainder unless ``even_split``, which demands none)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"batch size {size} not divisible by {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(i * step, (i + 1) * step
                                if i < num_slice - 1 else size)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split over the contexts of ``ctx_list``, one slice on each
    (one context: the whole array, in a list). Host data is placed on the
    first context before the split."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    return [s.as_in_context(c) for s, c in zip(
        split_data(data, len(ctx_list), batch_axis, even_split), ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place by ``min(max_norm / (norm + 1e-8), 1)``,
    ``norm`` the 2-norm of all of them together (in f32); returns that norm
    (a float: one host read). With ``check_isfinite`` a norm that is not
    finite also warns, as MXNet's does."""
    raws = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        total = torch.sqrt(sum(r.float().square().sum() for r in raws))
        scale = torch.clamp(max_norm / (total + 1e-8), max=1.0)
        for r in raws:
            r.copy_(r.float() * scale)
    norm = float(total)
    if check_isfinite and not math.isfinite(norm):
        warnings.warn(UserWarning("nan or inf is detected; clipping results "
                                  "will be undefined"), stacklevel=2)
    return norm


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 of the file ``filename`` is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash

"""``mx.np`` / ``mx.npx``: the numpy-compatible namespace.

Counterpart of ``mxnet_tpu/numpy_api.py`` (MXNet's late-1.x
``python/mxnet/numpy`` and ``numpy_extension``). Every name takes
NDArrays, tensors, numpy arrays or Python scalars and returns NDArrays on
the device of its array arguments (the current context for creation
functions), computed by PyTorch with numpy's semantics where PyTorch's
differ:

- ``var``/``std`` take numpy's ``ddof=0``;
- ``median`` averages the two middle values;
- ``meshgrid`` indexes ``"xy"``;
- ``split``/``array_split`` take sections or split indices;
- ``pad`` takes a per-axis ``pad_width``;
- ``mod`` takes the divisor's sign;
- ``cross`` works on the last axis;
- ``digitize`` follows numpy's ``right``;
- ``tril_indices``/``triu_indices`` return a tuple;
- ``empty``/``empty_like`` are zeros, as in the JAX package;
- ``histogram`` counts with a scatter-add on the array's device;
- ``cbrt``, ``ptp``, ``average``, ``interp`` and ``ediff1d`` are written
  here.

Floating dtypes follow the JAX package's (float32 by default). Integer
results that PyTorch gives as int64 (indices, counts, integer sums) stay
int64 where the JAX package, with 64-bit types off, gives int32.
``mx.np.random`` draws from the port's generators (``mx.nd.random``): the
JAX package's distributions, not its streams. ``npx.<name>`` reaches any
registered op as ``nd.<name>``.
"""
from __future__ import annotations

import math
import sys
import types

import numpy as _np
import torch
import torch.nn.functional as F

from . import ndarray as nd
from .base import MXNetError, dtype_torch
from .context import as_device
from .ndarray import NDArray, _from_host

__all__ = ["np", "npx"]

np = types.ModuleType(__name__.rsplit(".", 1)[0] + ".np")
npx = types.ModuleType(__name__.rsplit(".", 1)[0] + ".npx")


# -- arguments in, NDArrays out ----------------------------------------------
def _device(args):
    """The device of the first array among ``args`` (nested), else the
    current context's."""
    for a in args:
        if isinstance(a, NDArray):
            return a._data.device
        if torch.is_tensor(a):
            return a.device
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, (NDArray, torch.Tensor)):
                    return _device([x])
    return as_device(None)


def _t(x, dev):
    """``x`` as a tensor on ``dev``: an NDArray's or tensor's own, host
    data by MXNet's rules (float64 to float32, int64 to int32)."""
    if isinstance(x, NDArray):
        return x._data
    if torch.is_tensor(x):
        return x
    if isinstance(x, (bool, int, float)):
        return torch.as_tensor(x, device=dev)
    return _from_host(x).to(dev)


def _wrap(out):
    if torch.is_tensor(out):
        return NDArray(out)
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return out


def _api(fn):
    """``fn(dev, *args, **kwargs)`` (on tensors) as an ``mx.np`` function."""
    def f(*args, **kwargs):
        return _wrap(fn(_device(list(args) + list(kwargs.values())),
                        *args, **kwargs))

    f.__name__ = fn.__name__.lstrip("_")
    return f


def _dims(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def _unary(torch_fn):
    return _api(lambda dev, x, **kw: torch_fn(_t(x, dev), **kw))


def _binary(torch_fn):
    return _api(lambda dev, a, b: torch_fn(_t(a, dev), _t(b, dev)))


def _float(t):
    return t if t.is_floating_point() else t.to(torch.float32)


# -- elementwise ---------------------------------------------------------------
for _name, _fn in {
        "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
        "tanh": torch.tanh, "sin": torch.sin, "cos": torch.cos,
        "abs": torch.abs, "sign": torch.sign, "floor": torch.floor,
        "ceil": torch.ceil, "log2": torch.log2, "log10": torch.log10,
        "log1p": torch.log1p, "expm1": torch.expm1, "square": torch.square,
        "trunc": torch.trunc, "isnan": torch.isnan, "isinf": torch.isinf,
        "isfinite": torch.isfinite, "logical_not": torch.logical_not,
        "sinh": torch.sinh, "cosh": torch.cosh, "arcsin": torch.asin,
        "arccos": torch.acos, "arctan": torch.atan, "arcsinh": torch.asinh,
        "arccosh": torch.acosh, "arctanh": torch.atanh, "exp2": torch.exp2,
        "reciprocal": torch.reciprocal, "positive": torch.positive,
        "negative": torch.negative, "tan": torch.tan}.items():
    setattr(np, _name, _unary(_fn))

for _name, _fn in {
        "add": torch.add, "subtract": torch.subtract,
        "multiply": torch.multiply, "divide": torch.true_divide,
        "power": torch.pow, "maximum": torch.maximum,
        "minimum": torch.minimum, "floor_divide": torch.floor_divide,
        "mod": torch.remainder, "arctan2": torch.atan2,
        "hypot": torch.hypot, "logical_and": torch.logical_and,
        "logical_or": torch.logical_or, "logical_xor": torch.logical_xor,
        "equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
        "greater_equal": torch.ge, "less": torch.lt,
        "less_equal": torch.le, "gcd": torch.gcd, "lcm": torch.lcm}.items():
    setattr(np, _name, _binary(_fn))
del _name, _fn

np.absolute = np.abs


@_api
def _cbrt(dev, x):
    t = _float(_t(x, dev))
    return torch.sign(t) * torch.abs(t).pow(1.0 / 3.0)


@_api
def _round(dev, a, decimals=0):
    return torch.round(_t(a, dev), decimals=decimals)


@_api
def _clip(dev, a, a_min=None, a_max=None):
    return torch.clamp(_t(a, dev), a_min, a_max)


@_api
def _nan_to_num(dev, x, copy=True, nan=0.0, posinf=None, neginf=None):
    return torch.nan_to_num(_t(x, dev), nan=nan, posinf=posinf,
                            neginf=neginf)


@_api
def _where(dev, condition, x=None, y=None):
    c = _t(condition, dev)
    if x is None and y is None:
        return torch.nonzero(c, as_tuple=True)
    return torch.where(c.bool(), _t(x, dev), _t(y, dev))


np.cbrt, np.round, np.clip = _cbrt, _round, _clip
np.nan_to_num, np.where = _nan_to_num, _where


# -- reductions ----------------------------------------------------------------
def _reduce(t, axis, keepdims, fn):
    """``fn(t, dim, keepdim)`` over ``axis`` (None: every axis)."""
    if axis is None:
        out = fn(t.reshape(-1), 0, False)
        return out.reshape((1,) * t.dim()) if keepdims else out
    return fn(t, _dims(axis), keepdims)


@_api
def _sum(dev, a, axis=None, dtype=None, keepdims=False):
    t = _t(a, dev)
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    return _reduce(t, axis, keepdims, lambda x, d, k: torch.sum(x, d, k))


@_api
def _mean(dev, a, axis=None, keepdims=False):
    return _reduce(_float(_t(a, dev)), axis, keepdims,
                   lambda x, d, k: torch.mean(x, d, k))


@_api
def _max(dev, a, axis=None, keepdims=False):
    return _reduce(_t(a, dev), axis, keepdims,
                   lambda x, d, k: torch.amax(x, d, k))


@_api
def _min(dev, a, axis=None, keepdims=False):
    return _reduce(_t(a, dev), axis, keepdims,
                   lambda x, d, k: torch.amin(x, d, k))


def _prod_dims(x, d, k):
    for ax in sorted((d,) if isinstance(d, int) else d, reverse=True):
        x = torch.prod(x, ax, keepdim=k)
    return x


@_api
def _prod(dev, a, axis=None, keepdims=False):
    return _reduce(_t(a, dev), axis, keepdims, _prod_dims)


@_api
def _var(dev, a, axis=None, ddof=0, keepdims=False):
    return _reduce(_float(_t(a, dev)), axis, keepdims,
                   lambda x, d, k: torch.var(x, d, correction=ddof,
                                             keepdim=k))


@_api
def _std(dev, a, axis=None, ddof=0, keepdims=False):
    return _reduce(_float(_t(a, dev)), axis, keepdims,
                   lambda x, d, k: torch.std(x, d, correction=ddof,
                                             keepdim=k))


@_api
def _argmax(dev, a, axis=None):
    return torch.argmax(_t(a, dev), dim=axis)


@_api
def _argmin(dev, a, axis=None):
    return torch.argmin(_t(a, dev), dim=axis)


@_api
def _count_nonzero(dev, a, axis=None):
    return torch.count_nonzero(_t(a, dev), dim=_dims(axis))


@_api
def _nanmean(dev, a, axis=None, keepdims=False):
    return torch.nanmean(_float(_t(a, dev)), dim=_dims(axis), keepdim=keepdims)


@_api
def _nansum(dev, a, axis=None, keepdims=False):
    return torch.nansum(_t(a, dev), dim=_dims(axis), keepdim=keepdims)


def _quantile(t, q, axis, keepdims):
    """numpy's linear quantile (``median`` is the 0.5 one: the mean of the
    two middle values)."""
    t = _float(t)
    qt = torch.as_tensor(q, dtype=t.dtype, device=t.device)
    if axis is None:
        out = torch.quantile(t.reshape(-1), qt)
        return out.reshape(qt.shape + (1,) * t.dim()) if keepdims else out
    return torch.quantile(t, qt, dim=axis, keepdim=keepdims)


@_api
def _median(dev, a, axis=None, keepdims=False):
    return _quantile(_t(a, dev), 0.5, axis, keepdims)


@_api
def _percentile(dev, a, q, axis=None, keepdims=False):
    return _quantile(_t(a, dev), _np.asarray(q, _np.float64) / 100.0, axis,
                     keepdims)


@_api
def _quantile_fn(dev, a, q, axis=None, keepdims=False):
    return _quantile(_t(a, dev), _np.asarray(q, _np.float64), axis, keepdims)


@_api
def _ptp(dev, a, axis=None, keepdims=False):
    t = _t(a, dev)
    return (_reduce(t, axis, keepdims, lambda x, d, k: torch.amax(x, d, k)) -
            _reduce(t, axis, keepdims, lambda x, d, k: torch.amin(x, d, k)))


@_api
def _average(dev, a, axis=None, weights=None):
    t = _float(_t(a, dev))
    if weights is None:
        return t.mean() if axis is None else t.mean(dim=axis)
    w = _t(weights, dev).to(t.dtype)
    if axis is not None and w.dim() == 1 and t.dim() > 1:
        shape = [1] * t.dim()
        shape[axis] = -1
        w = w.reshape(shape)
    w = w.expand_as(t)
    if axis is None:
        return (t * w).sum() / w.sum()
    return (t * w).sum(dim=axis) / w.sum(dim=axis)


@_api
def _all(dev, a, axis=None, keepdims=False):
    return _reduce(_t(a, dev).bool(), axis, keepdims,
                   lambda x, d, k: torch.all(x, d, k))


@_api
def _any(dev, a, axis=None, keepdims=False):
    return _reduce(_t(a, dev).bool(), axis, keepdims,
                   lambda x, d, k: torch.any(x, d, k))


def _scan(torch_fn):
    def f(dev, a, axis=None, dtype=None):
        t = _t(a, dev)
        if dtype is not None:
            t = t.to(dtype_torch(dtype))
        return torch_fn(t.reshape(-1) if axis is None else t,
                        0 if axis is None else axis)
    f.__name__ = torch_fn.__name__
    return _api(f)


np.sum, np.mean, np.max, np.min, np.prod = _sum, _mean, _max, _min, _prod
np.var, np.std, np.argmax, np.argmin = _var, _std, _argmax, _argmin
np.count_nonzero, np.nanmean, np.nansum = _count_nonzero, _nanmean, _nansum
np.median, np.percentile, np.quantile = _median, _percentile, _quantile_fn
np.ptp, np.average, np.all, np.any = _ptp, _average, _all, _any
np.cumsum, np.cumprod = _scan(torch.cumsum), _scan(torch.cumprod)


@_api
def _allclose(dev, a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    x, y = _t(a, dev), _t(b, dev)
    dt = torch.promote_types(_float(x).dtype, _float(y).dtype)
    return torch.isclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


@_api
def _array_equal(dev, a1, a2):
    x, y = _t(a1, dev), _t(a2, dev)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=dev)
    return torch.eq(x, y).all()


np.allclose, np.array_equal = _allclose, _array_equal


# -- shapes ----------------------------------------------------------------------
@_api
def _reshape(dev, a, newshape, order="C"):
    return _t(a, dev).reshape(newshape)


@_api
def _transpose(dev, a, axes=None):
    t = _t(a, dev)
    return t.permute(*(axes if axes is not None
                       else reversed(range(t.dim()))))


@_api
def _concatenate(dev, arrays, axis=0):
    ts = [_t(x, dev) for x in arrays]
    if axis is None:
        return torch.cat([t.reshape(-1) for t in ts])
    return torch.cat(ts, dim=axis)


@_api
def _stack(dev, arrays, axis=0):
    return torch.stack([_t(x, dev) for x in arrays], dim=axis)


def _split_fn(strict):
    def f(dev, ary, indices_or_sections, axis=0):
        t = _t(ary, dev)
        if isinstance(indices_or_sections, int):
            if strict and t.shape[axis] % indices_or_sections:
                raise MXNetError("array split does not result in an equal "
                                 "division")
            return torch.tensor_split(t, indices_or_sections, dim=axis)
        return torch.tensor_split(t, list(indices_or_sections), dim=axis)
    f.__name__ = "split" if strict else "array_split"
    return _api(f)


@_api
def _expand_dims(dev, a, axis):
    return torch.unsqueeze(_t(a, dev), axis)


@_api
def _squeeze(dev, a, axis=None):
    t = _t(a, dev)
    return t.squeeze() if axis is None else t.squeeze(_dims(axis))


@_api
def _broadcast_to(dev, array, shape):
    return _t(array, dev).expand(*shape)


@_api
def _tile(dev, A, reps):
    return torch.tile(_t(A, dev), (reps,) if isinstance(reps, int)
                      else tuple(reps))


@_api
def _repeat(dev, a, repeats, axis=None):
    t = _t(a, dev)
    if axis is None:
        t, axis = t.reshape(-1), 0
    r = repeats if isinstance(repeats, int) else _t(repeats, dev)
    return torch.repeat_interleave(t, r, dim=axis)


@_api
def _flip(dev, m, axis=None):
    t = _t(m, dev)
    dims = tuple(range(t.dim())) if axis is None else \
        ((axis,) if isinstance(axis, int) else tuple(axis))
    return torch.flip(t, dims)


@_api
def _ravel(dev, a):
    return _t(a, dev).reshape(-1)


@_api
def _moveaxis(dev, a, source, destination):
    return torch.movedim(_t(a, dev), source, destination)


@_api
def _swapaxes(dev, a, axis1, axis2):
    return torch.swapaxes(_t(a, dev), axis1, axis2)


@_api
def _roll(dev, a, shift, axis=None):
    t = _t(a, dev)
    if axis is None:
        return torch.roll(t.reshape(-1), shift).reshape(t.shape)
    return torch.roll(t, shift, axis)


_PAD_MODES = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect", "wrap": "circular"}


@_api
def _pad(dev, array, pad_width, mode="constant", constant_values=0):
    """numpy's per-axis ``pad_width`` (``n``, ``(before, after)`` or one
    pair an axis) as ``F.pad``'s flat list from the last axis."""
    t = _t(array, dev)
    pw = _np.broadcast_to(_np.asarray(pad_width, _np.int64),
                          (t.dim(), 2)).tolist()
    flat = [p for pair in reversed(pw) for p in pair]
    if mode not in _PAD_MODES:
        raise MXNetError(f"mx.np.pad: mode {mode!r} is not supported")
    if mode == "constant":
        return F.pad(t, flat, value=constant_values)
    # F.pad pads the last dims of a batched input: pad dims with a width only
    lead = next((i for i, p in enumerate(pw) if any(p)), t.dim())
    x = t.reshape((1, -1) + t.shape[lead:]) if lead else t[None, None]
    out = F.pad(x, [p for pair in reversed(pw[lead:]) for p in pair],
                mode=_PAD_MODES[mode])
    return out.reshape(t.shape[:lead] + out.shape[2:])


@_api
def _atleast_1d(dev, *arys):
    out = [torch.atleast_1d(_t(a, dev)) for a in arys]
    return out[0] if len(out) == 1 else out


@_api
def _atleast_2d(dev, *arys):
    out = [torch.atleast_2d(_t(a, dev)) for a in arys]
    return out[0] if len(out) == 1 else out


def _seq(torch_fn):
    f = _api(lambda dev, tup: torch_fn([_t(x, dev) for x in tup]))
    f.__name__ = torch_fn.__name__
    return f


@_api
def _rot90(dev, m, k=1, axes=(0, 1)):
    return torch.rot90(_t(m, dev), k, list(axes))


np.reshape, np.transpose, np.concatenate = _reshape, _transpose, _concatenate
np.stack, np.split, np.array_split = _stack, _split_fn(True), _split_fn(False)
np.expand_dims, np.squeeze, np.broadcast_to = _expand_dims, _squeeze, \
    _broadcast_to
np.tile, np.repeat, np.flip, np.ravel = _tile, _repeat, _flip, _ravel
np.moveaxis, np.swapaxes, np.roll, np.pad = _moveaxis, _swapaxes, _roll, _pad
np.atleast_1d, np.atleast_2d, np.rot90 = _atleast_1d, _atleast_2d, _rot90
np.vstack, np.hstack = _seq(torch.vstack), _seq(torch.hstack)
np.dstack, np.column_stack = _seq(torch.dstack), _seq(torch.column_stack)


# -- products, sorting, indexing --------------------------------------------------
@_api
def _dot(dev, a, b):
    x, y = _t(a, dev), _t(b, dev)
    if x.dim() == 0 or y.dim() == 0:
        return x * y
    return torch.tensordot(x, y, ([x.dim() - 1], [max(y.dim() - 2, 0)]))


@_api
def _outer(dev, a, b):
    return torch.outer(_t(a, dev).reshape(-1), _t(b, dev).reshape(-1))


@_api
def _vdot(dev, a, b):
    return torch.dot(_t(a, dev).reshape(-1), _t(b, dev).reshape(-1))


@_api
def _tensordot(dev, a, b, axes=2):
    return torch.tensordot(_t(a, dev), _t(b, dev), dims=axes)


@_api
def _einsum(dev, subscripts, *operands):
    return torch.einsum(subscripts, *[_t(o, dev) for o in operands])


@_api
def _sort(dev, a, axis=-1):
    t = _t(a, dev)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return torch.sort(t, dim=axis, stable=True).values


@_api
def _argsort(dev, a, axis=-1):
    t = _t(a, dev)
    if axis is None:
        t, axis = t.reshape(-1), 0
    return torch.argsort(t, dim=axis, stable=True)


@_api
def _unique(dev, ar, return_inverse=False, return_counts=False, axis=None):
    return torch.unique(_t(ar, dev), sorted=True,
                        return_inverse=return_inverse,
                        return_counts=return_counts, dim=axis)


@_api
def _take(dev, a, indices, axis=None):
    t, idx = _t(a, dev), _t(indices, dev).long()
    if axis is None:
        return t.reshape(-1)[idx]
    return torch.index_select(t, axis, idx.reshape(-1)).reshape(
        t.shape[:axis] + idx.shape + t.shape[axis + 1:] if axis >= 0
        else t.shape[:t.dim() + axis] + idx.shape +
        t.shape[t.dim() + axis + 1:])


@_api
def _diag(dev, v, k=0):
    return torch.diag(_t(v, dev), k)


@_api
def _tril(dev, m, k=0):
    return torch.tril(_t(m, dev), k)


@_api
def _triu(dev, m, k=0):
    return torch.triu(_t(m, dev), k)


@_api
def _trace(dev, a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(_t(a, dev), offset, axis1, axis2).sum(-1)


@_api
def _diff(dev, a, n=1, axis=-1):
    return torch.diff(_t(a, dev), n=n, dim=axis)


@_api
def _ediff1d(dev, ary):
    return torch.diff(_t(ary, dev).reshape(-1))


@_api
def _cross(dev, a, b, axis=-1):
    return torch.linalg.cross(_t(a, dev), _t(b, dev), dim=axis)


@_api
def _searchsorted(dev, a, v, side="left"):
    return torch.searchsorted(_t(a, dev), _t(v, dev), right=side == "right")


@_api
def _digitize(dev, x, bins, right=False):
    """numpy's ``right`` is ``bucketize``'s inverted (increasing bins)."""
    return torch.bucketize(_t(x, dev), _t(bins, dev), right=not right)


@_api
def _interp(dev, x, xp, fp, left=None, right=None):
    xv, xs, fs = _float(_t(x, dev)), _float(_t(xp, dev)), _float(_t(fp, dev))
    i = torch.searchsorted(xs, xv, right=True).clamp(1, xs.shape[0] - 1)
    x0, x1, f0, f1 = xs[i - 1], xs[i], fs[i - 1], fs[i]
    out = f0 + (xv - x0) * (f1 - f0) / (x1 - x0)
    lo = fs[0] if left is None else torch.as_tensor(left, dtype=fs.dtype)
    hi = fs[-1] if right is None else torch.as_tensor(right, dtype=fs.dtype)
    out = torch.where(xv < xs[0], lo, out)
    return torch.where(xv > xs[-1], hi, out)


@_api
def _histogram(dev, a, bins=10, range=None):
    """Counts in ``bins`` equal bins over ``range`` (the data's extremes by
    default), the last bin closed, as floats (the JAX package's dtype; a
    sum of ones is exact in any order below 2^24): a scatter-add of ones
    on the array's device, and the bin edges."""
    t = _float(_t(a, dev)).reshape(-1)
    if range is None:
        lo, hi = t.min(), t.max()
    else:
        lo, hi = (torch.as_tensor(v, dtype=t.dtype, device=t.device)
                  for v in range)
    hi = torch.where(hi > lo, hi, lo + 1.0) if range is None else hi
    edges = lo + (hi - lo) * torch.linspace(0, 1, bins + 1, device=t.device,
                                            dtype=t.dtype)
    idx = torch.searchsorted(edges, t, right=True) - 1
    idx = torch.where(t == edges[-1], bins - 1, idx)
    inside = (idx >= 0) & (idx < bins)
    counts = torch.zeros(bins, dtype=t.dtype, device=t.device)
    counts.scatter_add_(0, idx.clamp(0, bins - 1), inside.to(t.dtype))
    return counts, edges


@_api
def _bincount(dev, x, weights=None, minlength=0):
    w = None if weights is None else _t(weights, dev)
    return torch.bincount(_t(x, dev).reshape(-1), w, minlength)


np.dot, np.outer, np.vdot, np.tensordot = _dot, _outer, _vdot, _tensordot
np.einsum, np.sort, np.argsort, np.unique = _einsum, _sort, _argsort, _unique
np.take, np.diag, np.tril, np.triu, np.trace = _take, _diag, _tril, _triu, \
    _trace
np.diff, np.ediff1d, np.cross = _diff, _ediff1d, _cross
np.searchsorted, np.digitize, np.interp = _searchsorted, _digitize, _interp
np.histogram, np.bincount = _histogram, _bincount
np.matmul = _binary(torch.matmul)
np.inner = _binary(torch.inner)
np.kron = _binary(torch.kron)


@_api
def _nonzero(dev, a):
    return torch.nonzero(_t(a, dev), as_tuple=True)


np.nonzero = _nonzero


# -- creation ---------------------------------------------------------------------
def _dt(dtype, default=torch.float32):
    return default if dtype is None else dtype_torch(dtype)


def _int_or_float(*values):
    """int32 when every value is an int (the JAX package's dtype), else
    float32."""
    return torch.int32 if all(isinstance(v, (int, _np.integer))
                              for v in values if v is not None) \
        else torch.float32


def _arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    dt = _dt(dtype, _int_or_float(start, stop, step))
    if stop is None:
        start, stop = 0, start
    return NDArray(torch.arange(start, stop, step, dtype=dt,
                                device=as_device(ctx or device)))


def _linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None,
              device=None):
    dev = as_device(ctx or device)
    if endpoint:
        t = torch.linspace(start, stop, num, dtype=torch.float32, device=dev)
    else:
        t = torch.linspace(start, stop, num + 1, dtype=torch.float32,
                           device=dev)[:-1]
    return NDArray(t.to(_dt(dtype)))


def _eye(N, M=None, k=0, dtype="float32", ctx=None, device=None):
    t = torch.zeros(N, N if M is None else M, dtype=_dt(dtype),
                    device=as_device(ctx or device))
    t.diagonal(k).fill_(1)
    return NDArray(t)


@_api
def _zeros_like(dev, a, dtype=None):
    t = _t(a, dev)
    return torch.zeros_like(t, dtype=None if dtype is None
                            else dtype_torch(dtype))


@_api
def _ones_like(dev, a, dtype=None):
    t = _t(a, dev)
    return torch.ones_like(t, dtype=None if dtype is None
                           else dtype_torch(dtype))


@_api
def _full_like(dev, a, fill_value, dtype=None):
    t = _t(a, dev)
    return torch.full_like(t, fill_value, dtype=None if dtype is None
                           else dtype_torch(dtype))


def _indices(torch_fn):
    def f(n, k=0, m=None, ctx=None, device=None):
        rc = torch_fn(n, n if m is None else m, k,
                      device=as_device(ctx or device))
        return NDArray(rc[0]), NDArray(rc[1])
    f.__name__ = torch_fn.__name__
    return f


@_api
def _meshgrid(dev, *xi, indexing="xy"):
    return torch.meshgrid(*[_t(x, dev) for x in xi], indexing=indexing)


def _array(obj, dtype=None, ctx=None, device=None):
    return nd.array(obj, ctx=ctx or device, dtype=dtype)


def _creation(fill):
    def f(shape, dtype="float32", ctx=None, device=None):
        return fill(shape, ctx or device, dtype)
    return f


np.arange, np.linspace, np.eye = _arange, _linspace, _eye
np.zeros_like, np.ones_like, np.full_like = _zeros_like, _ones_like, \
    _full_like
np.empty_like = _zeros_like  # the JAX package's: no uninitialised buffer
np.triu_indices = _indices(torch.triu_indices)
np.tril_indices = _indices(torch.tril_indices)
np.meshgrid = _meshgrid
np.array = _array
np.ndarray = NDArray
np.zeros = _creation(nd.zeros)
np.ones = _creation(nd.ones)
np.empty = np.zeros  # the JAX package's: no uninitialised buffer
np.full = lambda shape, fill_value, dtype="float32", ctx=None: nd.full(
    shape, fill_value, ctx, dtype)
np.identity = lambda n, dtype="float32": _eye(n, dtype=dtype)
np.float32 = "float32"
np.float16 = "float16"
np.float64 = "float64"
np.int32 = "int32"
np.int64 = "int64"
np.bool_ = "bool"
np.pi = math.pi
np.e = math.e
np.inf = math.inf
np.nan = math.nan
np.newaxis = None


# -- np.random over the port's generators -----------------------------------------
random = types.ModuleType(np.__name__ + ".random")


def _size(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


random.uniform = lambda low=0.0, high=1.0, size=None: nd.random.uniform(
    low, high, shape=_size(size))
random.normal = lambda loc=0.0, scale=1.0, size=None: nd.random.normal(
    loc, scale, shape=_size(size))
random.randint = lambda low, high=None, size=None, dtype="int32": \
    nd.random.randint(low if high is not None else 0,
                      high if high is not None else low, shape=_size(size),
                      dtype=dtype)
random.rand = lambda *shape: random.uniform(0.0, 1.0, size=shape)
random.randn = lambda *shape: random.normal(0.0, 1.0, size=shape)
random.seed = nd.random.seed


def _shuffle(x):
    """numpy's contract: in place, returns None."""
    x._data.copy_(nd.random.shuffle(x)._data)


random.shuffle = _shuffle
random.permutation = lambda x: nd.random.shuffle(x)
np.random = random


# -- np.linalg ----------------------------------------------------------------------
linalg = types.ModuleType(np.__name__ + ".linalg")


@_api
def _norm(dev, x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_float(_t(x, dev)), ord=ord, dim=_dims(axis),
                             keepdim=keepdims)


linalg.norm = _norm
linalg.inv = lambda a: nd.linalg_inverse(a)
linalg.det = lambda a: nd.linalg_det(a)
linalg.slogdet = lambda a: nd.linalg_slogdet(a)
linalg.cholesky = lambda a: nd.linalg_potrf(a)
linalg.svd = _api(lambda dev, a: tuple(torch.linalg.svd(
    _t(a, dev), full_matrices=False)))
linalg.eigh = _api(lambda dev, a: tuple(torch.linalg.eigh(_t(a, dev))))
linalg.solve = _api(lambda dev, a, b: torch.linalg.solve(_t(a, dev),
                                                         _t(b, dev)))
np.linalg = linalg

# -- npx -----------------------------------------------------------------------------
npx.softmax = lambda x, axis=-1: nd.softmax(x, axis=axis)
npx.log_softmax = lambda x, axis=-1: nd.log_softmax(x, axis=axis)
npx.relu = nd.relu
npx.sigmoid = nd.sigmoid
npx.activation = lambda x, act_type="relu": nd.Activation(x, act_type=act_type)
npx.fully_connected = nd.FullyConnected
npx.convolution = nd.Convolution
npx.pooling = nd.Pooling
npx.batch_norm = nd.BatchNorm
npx.layer_norm = nd.LayerNorm
npx.embedding = nd.Embedding
npx.one_hot = nd.one_hot
npx.pick = nd.pick
npx.topk = nd.topk
npx.reshape_like = nd.reshape_like
npx.set_np = lambda shape=True, array=True: None  # numpy semantics always
npx.reset_np = lambda: None
npx.is_np_array = lambda: True


def _npx_getattr(name):
    """Any registered op as ``npx.<name>`` (MXNet's generated
    ``numpy_extension`` surface over the same registry)."""
    return getattr(nd, name)


npx.__getattr__ = _npx_getattr

sys.modules[np.__name__] = np
sys.modules[random.__name__] = random
sys.modules[linalg.__name__] = linalg
sys.modules[npx.__name__] = npx

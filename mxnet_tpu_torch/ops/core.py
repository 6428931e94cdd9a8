"""Tensor, elementwise, reduction and indexing operators.

Counterpart of ``mxnet_tpu/ops/core.py``. The functions at the top
(``arange``, ``slice_axis``, ``stack``, ``gather_nd``, ``one_hot``,
``pick``) are the ones the models call; every operator the JAX module
registers is registered here under the same names and aliases, over
torch, with MXNet's semantics (``reshape``'s special codes, ``dot``'s
``transpose_a/b`` and the AMP pair rule, reductions with ``axis`` and
``keepdims`` that accumulate bf16/f16 in f32), so that ``mx.nd.*`` and
``F`` reach them. The index semantics are the JAX package's: ``gather_nd`` wraps a
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


# --------------------------------------------------------------------------
# The registered operators (the names and aliases of mxnet_tpu/ops/core.py)
# --------------------------------------------------------------------------
import functools  # noqa: E402
import math  # noqa: E402

from ..registry import alias, register  # noqa: E402


def _axis_tuple(axis):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def _dims(x, axis):
    """``axis`` as a tuple of dims; None is every dim."""
    ax = _axis_tuple(axis)
    return tuple(range(x.dim())) if ax is None else ax


def _same(fn):
    """A comparison or logical result in the first operand's dtype."""
    return lambda a, b: fn(a, b).to(a.dtype)


for _name, _fn, _al in [
    ("add", torch.add, ("elemwise_add", "broadcast_add", "broadcast_plus",
                        "_plus", "_add")),
    ("subtract", torch.sub, ("elemwise_sub", "broadcast_sub",
                             "broadcast_minus", "_sub", "_minus")),
    ("multiply", torch.mul, ("elemwise_mul", "broadcast_mul", "_mul")),
    ("divide", torch.true_divide, ("elemwise_div", "broadcast_div", "_div")),
    ("mod", torch.remainder, ("broadcast_mod",)),
    ("power", torch.pow, ("broadcast_power", "_power", "pow")),
    ("maximum", torch.maximum, ("broadcast_maximum", "_maximum")),
    ("minimum", torch.minimum, ("broadcast_minimum", "_minimum")),
    ("hypot", torch.hypot, ("broadcast_hypot",)),
    ("equal", _same(torch.eq), ("broadcast_equal",)),
    ("not_equal", _same(torch.ne), ("broadcast_not_equal",)),
    ("greater", _same(torch.gt), ("broadcast_greater",)),
    ("greater_equal", _same(torch.ge), ("broadcast_greater_equal",)),
    ("lesser", _same(torch.lt), ("broadcast_lesser",)),
    ("lesser_equal", _same(torch.le), ("broadcast_lesser_equal",)),
    ("logical_and", _same(torch.logical_and), ("broadcast_logical_and",)),
    ("logical_or", _same(torch.logical_or), ("broadcast_logical_or",)),
    ("logical_xor", _same(torch.logical_xor), ("broadcast_logical_xor",)),
]:
    register(_name, aliases=_al)(_fn)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


for _name, _fn, _al in [
    ("abs", torch.abs, ()),
    ("sign", torch.sign, ()),
    ("rint", torch.round, ()),
    ("ceil", torch.ceil, ()),
    ("floor", torch.floor, ()),
    ("trunc", torch.trunc, ()),
    ("round", torch.round, ()),
    ("fix", torch.trunc, ()),
    ("square", torch.square, ()),
    ("sqrt", torch.sqrt, ()),
    ("rsqrt", torch.rsqrt, ()),
    ("cbrt", _cbrt, ()),
    ("rcbrt", lambda x: 1.0 / _cbrt(x), ()),
    ("exp", torch.exp, ()),
    ("expm1", torch.expm1, ()),
    ("log", torch.log, ()),
    ("log10", torch.log10, ()),
    ("log2", torch.log2, ()),
    ("log1p", torch.log1p, ()),
    ("sin", torch.sin, ()),
    ("cos", torch.cos, ()),
    ("tan", torch.tan, ()),
    ("arcsin", torch.asin, ()),
    ("arccos", torch.acos, ()),
    ("arctan", torch.atan, ()),
    ("sinh", torch.sinh, ()),
    ("cosh", torch.cosh, ()),
    ("tanh", torch.tanh, ()),
    ("arcsinh", torch.asinh, ()),
    ("arccosh", torch.acosh, ()),
    ("arctanh", torch.atanh, ()),
    ("erf", torch.erf, ()),
    ("erfinv", torch.erfinv, ()),
    ("gamma", lambda x: torch.exp(torch.lgamma(x)), ()),
    ("gammaln", torch.lgamma, ()),
    ("digamma", torch.digamma, ()),
    ("logical_not", lambda x: torch.logical_not(x).to(x.dtype), ()),
    ("negative", torch.neg, ("_np_negative",)),
    ("reciprocal", torch.reciprocal, ()),
    ("relu", torch.relu, ()),
    ("sigmoid", torch.sigmoid, ()),
    ("softsign", lambda x: x / (1 + torch.abs(x)), ()),
    ("identity", lambda x: x, ("_copy", "stop_gradient_identity")),
]:
    register(_name, aliases=_al)(_fn)

register("BlockGrad", aliases=("stop_gradient",))(lambda x: x.detach())


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


# scalar ops (a python scalar keeps the tensor's float dtype, as a weakly
# typed JAX scalar does)
register("_plus_scalar")(lambda x, scalar=0.0: x + scalar)
register("_minus_scalar")(lambda x, scalar=0.0: x - scalar)
register("_rminus_scalar")(lambda x, scalar=0.0: scalar - x)
register("_mul_scalar")(lambda x, scalar=1.0: x * scalar)
register("_div_scalar")(lambda x, scalar=1.0: x / scalar)
register("_rdiv_scalar")(lambda x, scalar=1.0: scalar / x)
register("_power_scalar")(lambda x, scalar=1.0: torch.pow(x, scalar))
register("_rpower_scalar")(lambda x, scalar=1.0: torch.pow(scalar, x))
register("_mod_scalar")(lambda x, scalar=1.0: torch.remainder(x, scalar))
register("_maximum_scalar")(lambda x, scalar=0.0: torch.clamp(x, min=scalar))
register("_minimum_scalar")(lambda x, scalar=0.0: torch.clamp(x, max=scalar))
register("_equal_scalar")(lambda x, scalar=0.0: (x == scalar).to(x.dtype))
register("_not_equal_scalar")(lambda x, scalar=0.0: (x != scalar).to(x.dtype))
register("_greater_scalar")(lambda x, scalar=0.0: (x > scalar).to(x.dtype))
register("_greater_equal_scalar")(
    lambda x, scalar=0.0: (x >= scalar).to(x.dtype))
register("_lesser_scalar")(lambda x, scalar=0.0: (x < scalar).to(x.dtype))
register("_lesser_equal_scalar")(
    lambda x, scalar=0.0: (x <= scalar).to(x.dtype))


# reductions: bf16/f16 accumulate in f32 and come back in their dtype
# (MXNET_SAFE_ACCUMULATION), integer means are f32, as jnp's
_LOW = (torch.float16, torch.bfloat16)


def _reduce(fn, x, axis, keepdims):
    if x.dtype in _LOW:
        return fn(x.float(), _dims(x, axis), bool(keepdims)).to(x.dtype)
    return fn(x, _dims(x, axis), bool(keepdims))


def _sum(x, dims, keep):
    return torch.sum(x, dim=dims, keepdim=keep)


def _mean(x, dims, keep):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    return torch.mean(x, dim=dims, keepdim=keep)


def _prod(x, dims, keep):
    for d in sorted((d % max(x.dim(), 1) for d in dims), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x


register("sum", aliases=("sum_axis",))(
    lambda x, axis=None, keepdims=False: _reduce(_sum, x, axis, keepdims))
register("mean")(
    lambda x, axis=None, keepdims=False: _reduce(_mean, x, axis, keepdims))
register("prod")(
    lambda x, axis=None, keepdims=False: _reduce(_prod, x, axis, keepdims))
register("max", aliases=("max_axis",))(
    lambda x, axis=None, keepdims=False: torch.amax(
        x, dim=_dims(x, axis), keepdim=bool(keepdims)))
register("min", aliases=("min_axis",))(
    lambda x, axis=None, keepdims=False: torch.amin(
        x, dim=_dims(x, axis), keepdim=bool(keepdims)))
register("nansum")(
    lambda x, axis=None, keepdims=False: torch.nansum(
        x, dim=_dims(x, axis), keepdim=bool(keepdims)))
register("nanprod")(
    lambda x, axis=None, keepdims=False: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), _dims(x, axis),
        bool(keepdims)))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    xf = x.float() if x.dtype in _LOW else x
    dims, keep = _dims(x, axis), bool(keepdims)
    if ord == 1:
        out = torch.sum(torch.abs(xf), dim=dims, keepdim=keep)
    else:
        out = torch.sqrt(torch.sum(torch.square(xf), dim=dims, keepdim=keep))
    return out.to(x.dtype)


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1), dim=0)
        if keepdims:
            out = out.reshape((1,) * x.dim())
        return out.to(torch.float32)
    return fn(x, dim=int(axis), keepdim=bool(keepdims)).to(torch.float32)


register("argmax")(lambda x, axis=None, keepdims=False:
                   _arg(torch.argmax, x, axis, keepdims))
register("argmin")(lambda x, axis=None, keepdims=False:
                   _arg(torch.argmin, x, axis, keepdims))


@register("topk")
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    ax = int(axis) % x.dim()
    xm = torch.movedim(x, ax, -1)
    vals, idx = torch.topk(xm, int(k), dim=-1, largest=not is_ascend,
                           sorted=True)
    vals = torch.movedim(vals, -1, ax)
    idx = torch.movedim(idx, -1, ax).to(dtype_torch(dtype))
    if ret_typ == "indices":
        return idx
    if ret_typ == "value":
        return vals
    return idx, vals


@register("sort")
def sort(x, axis=-1, is_ascend=True):
    if axis is None:
        x, axis = x.reshape(-1), -1
    out = torch.sort(x, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, dims=(int(axis),))


@register("argsort")
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    if axis is None:
        x, axis = x.reshape(-1), -1
    idx = torch.argsort(x, dim=int(axis), stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(int(axis),))
    return idx.to(dtype_torch(dtype))


# matmul family
def _amp_pair(a, b):
    """The AMP rule of matmul-class ops: under a global ``amp.init`` dtype
    two f32 operands are rounded to it and multiplied with f32 sums and an
    f32 result (the products of the rounded values are exact in f32);
    otherwise the operands pass as they are."""
    from ..contrib.amp import compute_dtype

    adt = compute_dtype()
    if adt is not None and a.dtype == torch.float32 and \
            b.dtype == torch.float32:
        return a.to(adt).float(), b.to(adt).float()
    return a, b


@register("dot")
def dot(a, b, transpose_a=False, transpose_b=False):
    """MXNet dot: contracts the last axis of a with the first of b (after
    the transposes, which move a's first axis last and b's last first)."""
    if transpose_a and a.dim() > 1:
        a = torch.movedim(a, 0, -1)
    if transpose_b and b.dim() > 1:
        b = torch.movedim(b, -1, 0)
    a, b = _amp_pair(a, b)
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    a, b = _amp_pair(a, b)
    return torch.matmul(a, b)


# shape manipulation
def _resolve_reshape(shape, in_shape):
    """MXNet's reshape codes against ``in_shape``, as the JAX package
    resolves them: 0 copies an input dim, -1 is inferred, -2 copies the
    rest, -3 merges two; any other value is taken as it is (so -4, which
    the JAX package does not resolve either, is refused by the reshape)."""
    out, i, si = [], 0, 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(in_shape[si])
            si += 1
        elif s == -1:
            out.append(-1)
            si += 1
        elif s == -2:
            out.extend(in_shape[si:])
            si = len(in_shape)
        elif s == -3:
            out.append(in_shape[si] * in_shape[si + 1])
            si += 2
        else:
            out.append(s)
            si += 1
        i += 1
    return out


@register("reshape", aliases=("Reshape",))
def reshape(x, shape=None, reverse=False):
    shape = tuple(int(s) for s in shape)
    in_shape = tuple(x.shape)
    if reverse:
        out = _resolve_reshape(shape[::-1], in_shape[::-1])[::-1]
    else:
        out = _resolve_reshape(shape, in_shape)
    if any(s < -1 for s in out):
        raise ValueError(f"reshape: unresolved code in {tuple(out)} "
                         f"(shape {shape} of input {in_shape})")
    return torch.reshape(x, tuple(out))


def _transpose(x, axes=None):
    axes = tuple(axes) if axes else tuple(reversed(range(x.dim())))
    return x.permute(*axes)


register("reshape_like")(lambda x, y: torch.reshape(x, tuple(y.shape)))
register("flatten", aliases=("Flatten",))(
    lambda x: torch.reshape(x, (x.shape[0], -1)))
register("transpose")(_transpose)
register("swapaxes", aliases=("SwapAxis",))(
    lambda x, dim1=0, dim2=0: torch.swapaxes(x, int(dim1), int(dim2)))
register("expand_dims")(lambda x, axis: torch.unsqueeze(x, int(axis)))


@register("squeeze")
def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=_axis_tuple(axis))


register("broadcast_to")(lambda x, shape: x.expand(*tuple(
    int(s) if s != 0 else xs for s, xs in zip(shape, x.shape))))
register("broadcast_like")(lambda x, y: x.expand(*y.shape))
register("repeat")(lambda x, repeats, axis=None: torch.repeat_interleave(
    x, int(repeats), dim=None if axis is None else int(axis)))
register("tile")(lambda x, reps: torch.tile(x, tuple(int(r) for r in reps)))
register("reverse", aliases=("flip",))(
    lambda x, axis: torch.flip(x, dims=_axis_tuple(axis)))


@register("depth_to_space")
def depth_to_space(x, block_size):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(x, block_size):
    b = int(block_size)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 5, 3, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("concat", aliases=("Concat",))
def concat(*xs, dim=1):
    return torch.cat(xs, dim=int(dim))


register("stack")(stack)


@register("split", aliases=("SliceChannel",), nout=-1)
def split(x, num_outputs, axis=1, squeeze_axis=False):
    ax = int(axis)
    parts = torch.tensor_split(x, int(num_outputs), dim=ax)
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=ax) for p in parts]
    return tuple(parts)


def _take_slice(x, dim, sl):
    """``x[..., sl, ...]`` along ``dim``; a negative step is an index
    gather (torch slicing takes only positive steps)."""
    n = x.shape[dim]
    if sl.step is None or sl.step > 0:
        idx = [slice(None)] * x.dim()
        idx[dim] = sl
        return x[tuple(idx)]
    rows = torch.arange(*sl.indices(n), device=x.device)
    return torch.index_select(x, dim, rows)


@register("slice")
def slice_op(x, begin, end, step=None):
    nd = x.dim()
    begin = list(begin) + [None] * (nd - len(begin))
    end = list(end) + [None] * (nd - len(end))
    step = list(step or []) + [None] * (nd - len(step or []))
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        if (b, e, s) != (None, None, None):
            x = _take_slice(x, d, slice(b, e, s))
    return x


@register("arange_like", aliases=("_contrib_arange_like",))
def arange_like(data, start=0.0, step=1.0, axis=None, dtype="float32"):
    n = int(data.numel() if axis is None else data.shape[int(axis)])
    out = torch.arange(n, device=data.device) * step + start
    return out.to(dtype_torch(dtype))


register("slice_axis")(slice_axis)


@register("slice_like")
def slice_like(x, y, axes=()):
    axes = _axis_tuple(axes) or tuple(range(min(x.dim(), y.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, y.shape[a % x.dim()])
    return x[tuple(idx)]


def _pad_index(n, left, right, mode, device):
    """Source rows of an edge- or reflect-padded axis of length n."""
    i = torch.arange(-left, n + right, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period) if period > 0 else torch.zeros_like(i)
    return torch.where(i >= n, period - i, i)


@register("pad", aliases=("Pad",))
def pad(x, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode not in ("constant", "edge", "reflect"):
        raise KeyError(mode)
    if mode == "constant":
        flat = []
        for left, right in reversed(pw):
            flat += [left, right]
        return torch.nn.functional.pad(x, flat, value=constant_value)
    for d, (left, right) in enumerate(pw):
        if left or right:
            x = torch.index_select(x, d, _pad_index(x.shape[d], left, right,
                                                    mode, x.device))
    return x


# indexing
@register("take")
def take(a, indices, axis=0, mode="clip"):
    ax = int(axis) % a.dim()
    n = a.shape[ax]
    idx = indices.long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    out = torch.index_select(a, ax, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:ax]) + tuple(indices.shape) +
                       tuple(a.shape[ax + 1:]))


@register("Embedding", aliases=("embedding",))
def _embedding_op(data, weight, input_dim=None, output_dim=None, dtype=None,
                  sparse_grad=False):
    from . import nn as _nn

    return _nn.embedding(data, weight)


register("one_hot")(one_hot)
register("pick")(pick)
register("gather_nd")(gather_nd)


@register("scatter_nd")
def scatter_nd(data, indices, shape):
    out = torch.zeros(tuple(int(s) for s in shape), dtype=data.dtype,
                      device=data.device)
    return out.index_put(tuple(indices.long()), data)


@register("where")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


@register("boolean_mask")
def boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero. Its
    shape depends on the data, so it reads the mask's count on the host: it
    cannot run inside a captured step (``StepGraph`` raises on the sync)."""
    rows = torch.nonzero(index.reshape(-1).bool()).reshape(-1)
    return torch.index_select(data, int(axis), rows.to(data.device))


alias("boolean_mask", "_contrib_boolean_mask")


@register("SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    axis = int(axis)
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :].long()  # (T, B)
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


# dtype, casting, creation
register("cast", aliases=("Cast", "astype"))(
    lambda x, dtype="float32": x.to(dtype_torch(dtype)))
register("zeros_like")(torch.zeros_like)
register("ones_like")(torch.ones_like)


def _device(ctx):
    from ..context import as_device

    return as_device(ctx)


@register("_full", aliases=("full",))
def full(shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(tuple(shape), value, dtype=dtype_torch(dtype),
                      device=_device(ctx))


@register("_arange", aliases=("arange",))
def _arange_op(start=0, stop=None, step=1.0, repeat=1, dtype="float32",
               ctx=None):
    return arange(start, stop, step, repeat, dtype, device=_device(ctx))


@register("_eye", aliases=("eye",))
def eye(N, M=0, k=0, dtype="float32", ctx=None):
    n, m = int(N), int(M) or int(N)
    dev = _device(ctx)
    i = torch.arange(n, device=dev)[:, None]
    j = torch.arange(m, device=dev)[None, :]
    return (j - i == int(k)).to(dtype_torch(dtype))


@register("diag")
def diag(x, k=0):
    if x.dim() <= 1:
        return torch.diag(x, int(k))
    return torch.diagonal(x, int(k), -2, -1)


register("tril")(lambda x, k=0: torch.tril(x, int(k)))


@register("cumsum")
def cumsum(x, axis=None, dtype=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.cumsum(x, dim=int(axis),
                        dtype=None if dtype is None else dtype_torch(dtype))


register("isnan")(lambda x: torch.isnan(x).to(torch.float32))
register("isinf")(lambda x: torch.isinf(x).to(torch.float32))
register("isfinite")(lambda x: torch.isfinite(x).to(torch.float32))


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    """Broadcast size-1 axes to the given sizes (one (axis, size) pair or
    parallel tuples)."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    if len(axes) != len(sizes):
        raise ValueError(f"broadcast_axis: axis {axes} and size {sizes} must "
                         "have the same length")
    shape = list(data.shape)
    for a, s in zip(axes, sizes):
        if shape[a] != 1:
            raise ValueError(f"broadcast_axis: axis {a} has size {shape[a]}, "
                             "expected 1")
        shape[a] = int(s)
    return data.expand(*shape)


register("degrees")(lambda x: x * (180.0 / math.pi))
register("radians")(lambda x: x * (math.pi / 180.0))


@functools.lru_cache(maxsize=None)
def _make_loss_fn(grad_scale, valid_thresh, normalization):
    class _MakeLoss(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            scale = grad_scale
            if normalization == "batch":
                scale = scale / x.shape[0]
            elif normalization == "valid":
                n = torch.clamp((x > valid_thresh).float().sum(), min=1.0)
                return (g * scale / n).to(x.dtype)
            return (g * scale).to(x.dtype)

    return _MakeLoss.apply


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Mark an output as a loss head: the forward is the identity;
    ``grad_scale`` and ``normalization`` ('batch': over the batch size,
    'valid': over the count of entries above ``valid_thresh``, 'null')
    shape only the gradient."""
    return _make_loss_fn(float(grad_scale), float(valid_thresh),
                         str(normalization))(data)


@register("SVMOutput", aliases=("svm_output",))
def svm_output(data, label=None, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Forward = the scores (the hinge loss lives in gluon.loss)."""
    return data

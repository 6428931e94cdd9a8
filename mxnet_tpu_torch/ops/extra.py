"""The operator long tail: extra activations, the sequence ops, GroupNorm
and LRN, the spatial-transformer family, index and shape ops, FlowNet's
correlation, the AMP graph ops, ``im2col``/``col2im``, the quantize trio
and ``bincount``.

Counterpart of ``mxnet_tpu/ops/extra.py``: every name, alias, parameter
and ``nout`` it registers, over torch, with gradients from autograd. None
of them is a hand-written kernel in the JAX package (each is a jnp/lax
composition there), so each is a plain composition here:
``BilinearSampler`` is ``F.grid_sample`` (bilinear, zero padding, corners
aligned), ``LRN`` ``F.local_response_norm``, ``im2col``/``col2im``
``F.unfold``/``F.fold`` (the reference's channel-major (c, kh, kw) patch
order). Index semantics are the JAX package's: a gather wraps a negative
index once and clamps the rest into range (``choose_element_0index``),
``batch_take`` reads NaN past either end (``take_along_axis``'s fill), a
scatter drops an index outside its row (``fill_element_0index``), and
every index is brought into range before it reaches torch indexing, where
an out-of-range index is a device-side assert on the card. Index outputs
are int32 (``shape_array``, ``size_array``, ``unravel_index``,
``ravel_multi_index``, ``bincount``), as the JAX package gives them with
x64 off. ``bincount``'s length depends on the data, so it reads the
largest value on the host and refuses to run inside a captured step
(``StepGraph``), as ``boolean_mask`` does. ``_sharding_constraint`` is
the identity: the port has one device and no mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_torch
from ..registry import register
from .core import one_hot

# --------------------------------------------------------------------------
# activations and a reduction
# --------------------------------------------------------------------------
register("hard_sigmoid")(
    lambda data, alpha=0.2, beta=0.5: torch.clamp(alpha * data + beta, 0.0,
                                                  1.0))
register("softmin")(lambda data, axis=-1: torch.softmax(-data, dim=int(axis)))
register("relu6")(lambda data: torch.clamp(data, 0.0, 6.0))
register("selu")(lambda data: F.selu(data))
register("gelu")(lambda data: F.gelu(data))
register("softrelu")(lambda data: F.softplus(data))
register("log_sigmoid")(lambda data: F.logsigmoid(data))


@register("logsumexp")
def logsumexp(data, axis=None, keepdims=False):
    if axis is None:
        dims = tuple(range(data.dim()))
    elif isinstance(axis, (list, tuple)):
        dims = tuple(int(a) for a in axis)
    else:
        dims = (int(axis),)
    return torch.logsumexp(data, dim=dims, keepdim=bool(keepdims))


# --------------------------------------------------------------------------
# sequence ops (time-major by default, as SequenceMask)
# --------------------------------------------------------------------------
@register("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """The last valid step of each sequence along ``axis``; without lengths
    the last step."""
    axis = int(axis)
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    dm = torch.movedim(data, axis, 0)  # (T, B, ...)
    idx = (sequence_length.long() - 1).clamp(0, dm.shape[0] - 1)
    idx = idx.reshape((1, -1) + (1,) * (dm.dim() - 2)).expand(
        (1,) + tuple(dm.shape[1:]))
    return torch.gather(dm, 0, idx)[0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Reverse each sequence along ``axis``; with lengths only its first
    ``length`` steps, the padding after them staying in place."""
    axis = int(axis)
    dm = torch.movedim(data, axis, 0)  # (T, B, ...)
    if not use_sequence_length or sequence_length is None:
        out = torch.flip(dm, dims=(0,))
    else:
        steps = torch.arange(dm.shape[0], device=data.device)[:, None]
        lens = sequence_length.long().to(data.device)[None, :]
        src = torch.where(steps < lens, lens - 1 - steps, steps)
        src = src.clamp(0, dm.shape[0] - 1)
        src = src.reshape(tuple(src.shape) + (1,) * (dm.dim() - 2)).expand(
            dm.shape)
        out = torch.gather(dm, 0, src)
    return torch.movedim(out, 0, axis)


# --------------------------------------------------------------------------
# normalizations
# --------------------------------------------------------------------------
@register("GroupNorm", aliases=("group_norm",))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Group normalization over NCHW (or any N, C, ...): gamma and beta of
    shape (num_groups,), MXNet's layout, scale each group; of shape (C,),
    PyTorch's, each channel."""
    n, c = data.shape[0], data.shape[1]
    g = int(num_groups)
    x = data.reshape((n, g, c // g) + tuple(data.shape[2:]))
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    if gamma.shape[0] == g and g != c:
        expand = (1, g, 1) + (1,) * (data.dim() - 2)
        x = x * gamma.reshape(expand) + beta.reshape(expand)
        return x.reshape(data.shape)
    x = x.reshape(data.shape)
    expand = (1, c) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(expand) + beta.reshape(expand)


@register("LRN", aliases=("lrn",))
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Across-channel local response normalization: ``x / (knorm +
    alpha / nsize * sum of x^2 over nsize channels) ** beta``, the window
    running from ``nsize // 2`` channels before to ``(nsize - 1) // 2``
    after."""
    return F.local_response_norm(data, int(nsize), alpha=alpha, beta=beta,
                                 k=knorm)


# --------------------------------------------------------------------------
# spatial transformer family
# --------------------------------------------------------------------------
def _identity_grid(h, w, device):
    ys = torch.linspace(-1.0, 1.0, h, device=device)
    xs = torch.linspace(-1.0, 1.0, w, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """Sampling grids (N, 2, H, W) in xy order: ``affine`` maps the
    identity grid through each (2, 3) matrix of ``data`` (N, 6); ``warp``
    adds the pixel flow ``data`` (N, 2, H, W) to it."""
    if transform_type == "affine":
        h, w = int(target_shape[0]), int(target_shape[1])
        gx, gy = _identity_grid(h, w, data.device)
        base = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, h * w)
        theta = data.reshape(-1, 2, 3).float()
        return torch.matmul(theta, base).reshape(-1, 2, h, w)
    if transform_type == "warp":
        _, _, h, w = data.shape
        gx, gy = _identity_grid(h, w, data.device)
        fx = data[:, 0] * (2.0 / max(w - 1, 1))
        fy = data[:, 1] * (2.0 / max(h - 1, 1))
        return torch.stack([gx[None] + fx, gy[None] + fy], 1)
    raise ValueError(f"GridGenerator: unknown transform_type "
                     f"{transform_type!r}")


@register("BilinearSampler")
def bilinear_sampler(data, grid):
    """Sample NCHW ``data`` at the normalized grid (N, 2, Ho, Wo), xy in
    [-1, 1] at the corner pixels; a corner outside the image reads 0."""
    out = F.grid_sample(data, grid.permute(0, 2, 3, 1).to(data.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.to(data.dtype)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear"):
    """``BilinearSampler(data, GridGenerator(loc, "affine",
    target_shape))``."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("SpatialTransformer supports affine + bilinear")
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


# --------------------------------------------------------------------------
# index and shape ops
# --------------------------------------------------------------------------
def _wrapped(idx, n):
    """``idx`` (int64) with a negative index counted from the end once, and
    whether it then lies inside ``[0, n)``."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx, (idx >= 0) & (idx < n)


@register("batch_take")
def batch_take(a, indices):
    """``out[i] = a[i, indices[i]]``; an index outside the row reads NaN
    (an integer ``a`` reads its lowest value), as ``take_along_axis``."""
    idx, inside = _wrapped(indices.long().reshape(-1), a.shape[1])
    out = torch.gather(a, 1, idx.clamp(0, a.shape[1] - 1)[:, None])[:, 0]
    fill = float("nan") if a.is_floating_point() else \
        torch.iinfo(a.dtype).min
    return torch.where(inside, out, torch.full((), fill, dtype=a.dtype,
                                               device=a.device))


@register("khatri_rao")
def khatri_rao(*matrices):
    """The column-wise Kronecker product of (r_i, k) matrices."""
    out = matrices[0]
    for m in matrices[1:]:
        k = out.shape[1]
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, k)
    return out


@register("unravel_index", aliases=("_unravel_index",))
def unravel_index(data, shape=None):
    """Flat indices -> the (ndim, N) int32 coordinate matrix, row-major; an
    index is clipped into ``[-size, size)`` and a negative one counts from
    the end, as ``jnp.unravel_index``."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    idx = data.to(torch.int32).long().clamp(-size, size - 1)
    idx = torch.where(idx < 0, idx + size, idx)
    coords = []
    for s in reversed(shape):
        coords.append(torch.remainder(idx, s))
        idx = torch.div(idx, s, rounding_mode="floor")
    return torch.stack(coords[::-1], 0).to(torch.int32)


@register("ravel_multi_index", aliases=("_ravel_multi_index",))
def ravel_multi_index(data, shape=None):
    """The (ndim, N) coordinate matrix -> int32 flat indices, row-major."""
    shape = tuple(int(s) for s in shape)
    idx = torch.zeros(tuple(data.shape[1:]), dtype=torch.int32,
                      device=data.device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        idx = idx + data[d].to(torch.int32) * stride
        stride *= shape[d]
    return idx


@register("split_v2", aliases=("_split_v2",))
def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy's split: at the given indices, or into equal sections (which
    must divide the axis)."""
    axis = int(axis)
    if isinstance(indices_or_sections, (tuple, list)):
        pieces = torch.tensor_split(
            data, [int(i) for i in indices_or_sections], dim=axis)
    else:
        n = int(indices_or_sections)
        if data.shape[axis] % n:
            raise ValueError(f"split_v2: {n} sections do not divide axis "
                             f"{axis} of size {data.shape[axis]}")
        pieces = torch.split(data, data.shape[axis] // n, dim=axis)
    if squeeze_axis:
        pieces = [torch.squeeze(p, dim=axis) for p in pieces]
    return tuple(pieces)


@register("moments", nout=2)
def moments(data, axes=None, keepdims=False):
    """(mean, biased variance) over ``axes`` (every axis when None)."""
    if axes is None:
        dims = tuple(range(data.dim()))
    elif isinstance(axes, (tuple, list)):
        dims = tuple(int(a) for a in axes)
    else:
        dims = (int(axes),)
    mean = data.mean(dim=dims, keepdim=bool(keepdims))
    mk = data.mean(dim=dims, keepdim=True)
    var = (data - mk).square().mean(dim=dims, keepdim=bool(keepdims))
    return mean, var


@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's correlation layer at kernel_size 1: for each output centre
    (every ``stride1`` pixels, ceil rule for the count) and each
    displacement of the (2d+1)^2 grid (every ``stride2``), the channel mean
    of ``data1 * shifted data2`` (or of ``|data1 - shifted data2|``);
    output (N, displacements, out_h, out_w)."""
    if kernel_size != 1:
        raise ValueError("Correlation: native tier implements kernel_size=1 "
                         "(the FlowNet configuration)")
    _, _, h, w = data1.shape
    d, p, s1 = int(max_displacement), int(pad_size), int(stride1)
    a = F.pad(data1, (p, p, p, p))
    b = F.pad(data2, (p, p, p, p))
    hp, wp = h + 2 * p, w + 2 * p
    out_h = -(-(hp - 2 * d) // s1)
    out_w = -(-(wp - 2 * d) // s1)
    lim_h, lim_w = d + (out_h - 1) * s1 + 1, d + (out_w - 1) * s1 + 1
    a_c = a[:, :, d:lim_h:s1, d:lim_w:s1]
    rows = []
    for dy in range(-d, d + 1, int(stride2)):
        for dx in range(-d, d + 1, int(stride2)):
            b_c = b[:, :, d + dy:dy + lim_h:s1, d + dx:dx + lim_w:s1]
            if is_multiply:
                rows.append((a_c * b_c).mean(dim=1))
            else:
                rows.append((a_c - b_c).abs().mean(dim=1))
    return torch.stack(rows, dim=1)


# --------------------------------------------------------------------------
# the AMP graph ops (reference: amp_cast.cc, all_finite.cc), with the rules
# of contrib/amp.py: a float is cast, anything else passes; the widest float
# dtype of the inputs wins (bfloat16 and float16 together give float32)
# --------------------------------------------------------------------------
@register("amp_cast")
def amp_cast(data, dtype="float32"):
    """A float cast to ``dtype``; a non-float input passes unchanged."""
    if not data.is_floating_point():
        return data
    return data.to(dtype_torch(dtype))


@register("amp_multicast", nout=-1)
def amp_multicast(*data, num_outputs=None):
    """Every float input cast to the widest float dtype among them."""
    floats = [a.dtype for a in data if a.is_floating_point()]
    if not floats:
        return tuple(data)
    target = floats[0]
    for dt in floats[1:]:
        target = torch.promote_types(target, dt)
    return tuple(a.to(target) if a.is_floating_point() else a for a in data)


@register("all_finite")
def all_finite(data, init_output=True):
    """(1,) float32: 1 when every element is finite, else 0."""
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite", nout=1)
def multi_all_finite(*data, num_arrays=None, init_output=True):
    """(1,) float32: 1 when every element of every input is finite."""
    ok = torch.ones((), dtype=torch.bool, device=data[0].device)
    for a in data:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)


@register("_sharding_constraint")
def sharding_constraint(data, spec=()):
    """The identity: the port runs on one device, with no mesh to
    constrain a layout against (the JAX op is the identity without one)."""
    return data


@register("add_n", aliases=("ElementWiseSum",))
def add_n(*args, num_args=None):
    """The sum of the inputs, in their order."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("argmax_channel")
def argmax_channel(data):
    """argmax over axis 1, as float32."""
    return torch.argmax(data, dim=1).to(torch.float32)


def _int32_of(values, device):
    """A 1-D int32 tensor of host ints, made by fills on ``device`` (no
    copy from host memory, so a captured step may make it)."""
    return torch.stack([torch.full((), int(v), dtype=torch.int32,
                                   device=device) for v in values])


@register("shape_array")
def shape_array(data):
    """The shape as a 1-D int32 tensor on ``data``'s device."""
    return _int32_of(tuple(data.shape), data.device)


@register("size_array")
def size_array(data):
    """The element count as a (1,) int32 tensor on ``data``'s device."""
    return _int32_of((data.numel(),), data.device)


def _window(kernel, stride, dilate, pad):
    n = len(kernel)
    return (tuple(int(k) for k in kernel),
            tuple(int(s) for s in stride) if stride else (1,) * n,
            tuple(int(d) for d in dilate) if dilate else (1,) * n,
            tuple(int(p) for p in pad) if pad else (0,) * n)


def _as_2d(kernel, stride, dilate, pad):
    """A 1-D window as a 2-D one of height 1."""
    if len(kernel) == 1:
        return ((1,) + kernel, (1,) + stride, (1,) + dilate, (0,) + pad)
    return kernel, stride, dilate, pad


@register("im2col")
def im2col(data, kernel, stride=None, dilate=None, pad=None):
    """Sliding-window patches: (N, C, H, W) -> (N, C*kh*kw, L) (or the 1-D
    (N, C, W) form), each column one window in the channel-major (c, kh,
    kw) order of the reference's im2col.h."""
    kernel, stride, dilate, pad = _window(kernel, stride, dilate, pad)
    one_d = len(kernel) == 1
    k, s, d, p = _as_2d(kernel, stride, dilate, pad)
    x = data.unsqueeze(2) if one_d else data
    return F.unfold(x, k, dilation=d, padding=p, stride=s)


@register("col2im")
def col2im(data, output_size, kernel, stride=None, dilate=None, pad=None):
    """The adjoint of im2col: each column's patch summed back into (N, C,
    *output_size)."""
    kernel, stride, dilate, pad = _window(kernel, stride, dilate, pad)
    output_size = tuple(int(o) for o in output_size)
    one_d = len(kernel) == 1
    k, s, d, p = _as_2d(kernel, stride, dilate, pad)
    size = (1,) + output_size if one_d else output_size
    out = F.fold(data, size, k, dilation=d, padding=p, stride=s)
    return out.squeeze(2) if one_d else out


# -- the quantize trio (reference: quantize.cc, quantize_v2.cc,
# dequantize.cc); rounding is half to even, as jnp.round --
def _scalar(v, device):
    """``v`` (a number or a tensor) as a 0-d f32 tensor on ``device``; a
    number is a fill, not a copy from host memory."""
    if torch.is_tensor(v):
        return v.to(device, torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


@register("quantize", nout=3)
def quantize(data, min_range, max_range, out_type="uint8"):
    """uint8: affine over [min, max]; int8: symmetric over
    max(|min|, |max|). Returns (q, min (1,), max (1,))."""
    mn, mx_ = _scalar(min_range, data.device), _scalar(max_range, data.device)
    xf = data.float()
    if out_type == "uint8":
        scale = 255.0 / torch.clamp(mx_ - mn, min=1e-12)
        q = torch.clamp(torch.round((xf - mn) * scale), 0, 255).to(
            torch.uint8)
    else:
        amax = torch.maximum(mn.abs(), mx_.abs())
        scale = 127.0 / torch.clamp(amax, min=1e-12)
        q = torch.clamp(torch.round(xf * scale), -127, 127).to(torch.int8)
    return q, mn.reshape(1), mx_.reshape(1)


@register("quantize_v2", nout=3)
def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """quantize with the calibrated range when given, else the data's."""
    xf = data.float()
    mn = xf.min() if min_calib_range is None else min_calib_range
    mx_ = xf.max() if max_calib_range is None else max_calib_range
    return quantize(data, mn, mx_, out_type=out_type)


@register("dequantize")
def dequantize(data, min_range, max_range, out_type="float32"):
    """The inverse of quantize, by the stored integer dtype."""
    mn, mx_ = _scalar(min_range, data.device), _scalar(max_range, data.device)
    if data.dtype == torch.uint8:
        out = data.float() * (torch.clamp(mx_ - mn, min=1e-12) / 255.0) + mn
    else:
        amax = torch.maximum(mn.abs(), mx_.abs())
        out = data.float() * (torch.clamp(amax, min=1e-12) / 127.0)
    return out.to(dtype_torch(out_type))


def _capturing():
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


@register("bincount")
def bincount(data, weights=None, minlength=0):
    """Counts (int32), or summed ``weights``, of each non-negative id; the
    length is ``max(max(data) + 1, minlength)``. It reads the largest id on
    the host, so it cannot run inside a captured step: it raises there."""
    if _capturing():
        raise MXNetError("bincount: its length depends on the data, which "
                         "a captured step cannot read; compute it outside "
                         "the step")
    d = data.to(torch.int32).reshape(-1)
    length = max(int(d.max()) + 1 if d.numel() else 1, int(minlength))
    if weights is None:
        return torch.bincount(d, minlength=length).to(torch.int32)
    w = weights.reshape(-1)
    return torch.zeros(length, dtype=w.dtype, device=w.device).index_add_(
        0, d.long(), w)


@register("onehot_encode")
def onehot_encode(indices, out):
    """One-hot rows of ``indices`` in ``out``'s shape (n, k) and dtype."""
    return one_hot(indices, out.shape[-1], dtype=out.dtype)


@register("choose_element_0index")
def choose_element_0index(lhs, rhs):
    """``out[i] = lhs[i, rhs[i]]``; a negative index counts from the end,
    any other outside the row reads the nearest end, with no gradient."""
    idx, inside = _wrapped(rhs.long().reshape(-1), lhs.shape[1])
    out = torch.gather(lhs, 1, idx.clamp(0, lhs.shape[1] - 1)[:, None])[:, 0]
    return torch.where(inside, out, out.detach())


@register("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """A copy of ``lhs`` with ``out[i, rhs[i]] = mhs[i]``; an index outside
    the row writes nothing."""
    idx, inside = _wrapped(rhs.long().reshape(-1), lhs.shape[1])
    cols = torch.arange(lhs.shape[1], device=lhs.device)
    hit = (cols[None, :] == idx[:, None]) & inside[:, None]
    return torch.where(hit, mhs.reshape(-1, 1).to(lhs.dtype), lhs)

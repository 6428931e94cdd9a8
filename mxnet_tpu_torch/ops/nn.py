"""The NN ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``fully_connected``, the
``layer_norm`` dispatch, ``tanh_gelu``, ``activation``, ``softmax``,
``log_softmax``, and the vision ops: ``convolution``, ``deconvolution``,
``pooling``, ``adaptive_avg_pooling``, ``leaky_relu``, ``batch_norm``,
``instance_norm``) and ``mxnet_tpu/ops/core.py`` (``embedding``). Matrix
products stay ``torch.matmul`` and convolutions cuDNN's, as the JAX package
leaves both to XLA; pooling and the normalizations are plain compositions,
as there.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .. import config as _config
from ..contrib import amp as _amp
from . import layernorm as _ln

__all__ = ["fully_connected", "layer_norm", "tanh_gelu", "embedding",
           "activation", "softmax", "log_softmax", "convolution",
           "deconvolution", "pooling", "adaptive_avg_pooling", "leaky_relu",
           "batch_norm", "instance_norm"]


def fully_connected(data, weight, bias=None, flatten=True):
    """``data @ weight.T + bias``; weight is (out, in) as in MXNet and
    ``torch.nn.Linear``. The product follows the AMP rule of the JAX
    ``fully_connected`` (:func:`contrib.amp.matmul` with ``data_decides``):
    under a global ``amp.init`` dtype an f32 ``data`` and the weight are
    multiplied in that dtype with an f32 sum and result."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = _amp.matmul(data, weight.t(), data_decides=True)
    if bias is not None:
        out = out + bias
    return out


def layer_norm(data, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis: the kernel when ``fused_layernorm`` is
    on (the default) and the input is f32 or bf16, else the plain
    composition. Float16 takes the composition, as the JAX gate sends it
    there (a dispatch rule: the kernel is built for f32 and bf16)."""
    if _config.get("fused_layernorm") and data.dtype in (torch.float32,
                                                          torch.bfloat16):
        return _ln.layer_norm(data, gamma, beta, eps)
    return _ln.layer_norm_plain(data, gamma, beta, eps)


def tanh_gelu(x):
    """GELU with the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def embedding(data, weight):
    """Row lookup ``weight[data]`` with the semantics of ``jnp.take``:
    an index in ``[-V, 0)`` counts from the end, and any index outside
    ``[-V, V)`` gives a NaN row whose gradient is dropped. The index is
    wrapped and clamped before the gather, so an out-of-range id never
    reaches ``F.embedding`` (a device-side assert on the card), and the
    NaN rows are a ``torch.where``: no host sync, so the lookup may run
    inside a captured step."""
    v = weight.shape[0]
    idx = data.long()
    idx = torch.where(idx < 0, idx + v, idx)
    inside = (idx >= 0) & (idx < v)
    rows = F.embedding(idx.clamp(0, v - 1), weight)
    return torch.where(inside[..., None], rows, float("nan"))


# the act_type table of the JAX ``Activation`` op; "gelu" is the erf form
_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "gelu": F.gelu,
    "erf_gelu": F.gelu,
    "tanh_gelu": tanh_gelu,
    "silu": F.silu,
}


def activation(data, act_type="relu"):
    """The elementwise activation ``act_type`` (a key of the JAX table:
    relu, sigmoid, tanh, softrelu, softsign, gelu, erf_gelu, tanh_gelu,
    silu)."""
    if act_type not in _ACTS:
        raise ValueError(f"unknown act_type {act_type!r}")
    return _ACTS[act_type](data)


def _f32_policy(fn, data, axis):
    """``fn`` over ``axis`` with the AMP f32 rule of the JAX softmax
    family: bf16 or f16 input is normalised in f32 and returned in its own
    dtype."""
    if data.dtype in (torch.float16, torch.bfloat16):
        return fn(data.float(), dim=int(axis)).to(data.dtype)
    return fn(data, dim=int(axis))


def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax over ``axis``. With ``length`` (B,), only the first
    ``length[b]`` entries of row b along ``axis`` take part (the others are
    -inf before the softmax, so they come out 0)."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is not None:
        ax = int(axis) % data.dim()
        steps = torch.arange(data.shape[ax], device=data.device)
        mask = steps[None, :] < length.long()[:, None]
        shape = [1] * data.dim()
        shape[0], shape[ax] = mask.shape
        data = data.masked_fill(~mask.reshape(shape), float("-inf"))
    return _f32_policy(torch.softmax, data, axis)


def log_softmax(data, axis=-1, temperature=None):
    """Log-softmax over ``axis``, under the same f32 rule as
    :func:`softmax`."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return _f32_policy(torch.log_softmax, data, axis)



# -- convolution (the JAX ops/nn.py:67-134) -----------------------------------
def _pair(v, n=2):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


# cuDNN's deterministic algorithms for every convolution on the card, so
# that a captured step and the eager one give the same bits.
# tools/torch_train_profile.py turns this off only to time what it costs.
DETERMINISTIC = True


@contextlib.contextmanager
def _conv_precision(x):
    """cuDNN's flags for one convolution on the card: no TF32 (PyTorch's
    own default lets f32 convolutions take it; the port's f32 rule is
    f32-accurate products) and the algorithms :data:`DETERMINISTIC` says.
    Restored afterwards; on the CPU nothing is touched."""
    if x.device.type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = False
    cudnn.deterministic = DETERMINISTIC
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved


class _ConvFn(torch.autograd.Function):
    """A 2-D convolution (``transposed``: its transpose), forward and
    backward under :func:`_conv_precision`. The backward runs on the
    autograd engine's thread, outside any caller's flags, which is why the
    convolution is a Function of its own."""

    @staticmethod
    def forward(ctx, x, w, stride, pad, dilate, transposed, adj, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pad, dilate, transposed, adj, groups)
        with _conv_precision(x):
            return torch.ops.aten.convolution(x, w, None, stride, pad, dilate,
                                              transposed, adj, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _conv_precision(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, *ctx.conf, mask)
        return gx, gw, None, None, None, None, None, None


def _conv_operands(data, weight):
    """The JAX precision rule of both convolutions (``ops/nn.py:78-89``):
    under a global bfloat16 ``amp.init`` an f32 input and its weight are
    cast to bf16; a float16 input is computed in f32 (a large fan-in
    overflows f16). The caller casts the output back to the input's
    dtype."""
    if _amp.compute_dtype() == torch.bfloat16 and \
            data.dtype == torch.float32:
        return data.to(torch.bfloat16), weight.to(torch.bfloat16)
    if data.dtype == torch.float16:
        return data.float(), weight.float()
    return data, weight


def _check_spatial(data, what):
    if data.dim() != 4:
        raise ValueError(f"{what}: NCHW input expected (the JAX op takes "
                         f"1-D and 2-D only), got shape {tuple(data.shape)}")


def convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout="NCHW"):
    """Convolution, NCHW/OIHW (an NCW input as H=1), ``num_group`` groups;
    the bias is added after the product, in the output's dtype."""
    conv_1d = data.dim() == 3
    if conv_1d:
        data, weight = data.unsqueeze(2), weight.unsqueeze(2)
        stride, dilate, pad = ((1, _pair(stride, 1)[0]),
                               (1, _pair(dilate, 1)[0]),
                               (0, _pair(pad, 1)[0]))
    _check_spatial(data, "Convolution")
    orig = data.dtype
    x, w = _conv_operands(data, weight)
    out = _ConvFn.apply(x, w, _pair(stride), _pair(pad), _pair(dilate),
                        False, (0, 0), int(num_group)).to(orig)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out[:, :, 0, :] if conv_1d else out


def deconvolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                  dilate=(1, 1), pad=(0, 0), adj=(0, 0), num_filter=None,
                  num_group=1, no_bias=False):
    """Transposed convolution with an (in, out / groups, kh, kw) weight;
    ``adj`` adds rows and columns at the bottom and right. ``dilate`` is
    ignored, as in the JAX op."""
    _check_spatial(data, "Deconvolution")
    orig = data.dtype
    x, w = _conv_operands(data, weight)
    out = _ConvFn.apply(x, w, _pair(stride), _pair(pad), (1, 1), True,
                        _pair(adj), int(num_group)).to(orig)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -- pooling (the JAX ops/nn.py:138-166) --------------------------------------
def _windows(x, kernel, stride, pad, fill):
    """The (N, C, OH, OW, kh, kw) windows of ``x`` padded with ``fill``."""
    x = F.pad(x, (pad[1], pad[1], pad[0], pad[0]), value=fill)
    return x.unfold(2, kernel[0], stride[0]).unfold(3, kernel[1], stride[1])


def pooling(data, kernel=(2, 2), pool_type="max", stride=None, pad=(0, 0),
            global_pool=False, count_include_pad=True,
            pooling_convention="valid"):
    """Max or average pooling over the last two axes ("valid" windows;
    any ``pool_type`` but "max" averages, as in the JAX op). Max pads with
    -inf (an integer input with its dtype's least value); the average
    divides by the window's size, or with ``count_include_pad=False`` by
    the number of its cells inside the input. Where ``F.max_pool2d`` /
    ``F.avg_pool2d`` take the case (a pad at most half the kernel, a
    float input) they compute it; otherwise the windows are reduced as a
    plain composition."""
    if pooling_convention != "valid":
        raise ValueError(f"pooling_convention={pooling_convention!r}: only "
                         "'valid' windows are computed (the JAX op computes "
                         "'valid' whatever it is given)")
    if global_pool:
        if pool_type == "max":
            return data.amax(dim=(-2, -1), keepdim=True)
        return data.mean(dim=(-2, -1), keepdim=True)
    _check_spatial(data, "Pooling")
    kernel = _pair(kernel)
    stride = _pair(stride) if stride is not None else kernel
    pad = _pair(pad)
    library = data.is_floating_point() and \
        all(2 * p <= k for p, k in zip(pad, kernel))
    if pool_type == "max":
        if library:
            return F.max_pool2d(data, kernel, stride, pad)
        fill = float("-inf") if data.is_floating_point() else \
            torch.iinfo(data.dtype).min
        return _windows(data, kernel, stride, pad, fill).amax(dim=(-2, -1))
    whole = count_include_pad or pad == (0, 0)
    if library:
        return F.avg_pool2d(data, kernel, stride, pad,
                            count_include_pad=whole)
    s = _windows(data, kernel, stride, pad, 0.0).sum(dim=(-2, -1))
    if whole:
        return s / (kernel[0] * kernel[1])
    ones = torch.ones((1, 1) + tuple(data.shape[-2:]), dtype=data.dtype,
                      device=data.device)
    return s / _windows(ones, kernel, stride, pad, 0.0).sum(dim=(-2, -1))


def adaptive_avg_pooling(data, output_size=1):
    """Average pooling to ``output_size`` cells (H and W divisible by it)."""
    oh, ow = _pair(output_size)
    n, c, h, w = data.shape
    return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))


# -- LeakyReLU (the JAX ops/nn.py:191-211) ------------------------------------
_SELU = (1.6732632423543772, 1.0507009873554805)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky (``slope``), prelu (the learned per-channel ``gamma``), elu,
    selu, gelu (erf) and rrelu (its deterministic midpoint slope)."""
    pos = data >= 0
    if act_type == "leaky":
        return torch.where(pos, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(pos, data, g * data)
    if act_type == "elu":
        return torch.where(pos, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = _SELU
        return scale * torch.where(pos, data, alpha * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        return torch.where(pos, data, (lower_bound + upper_bound) / 2 * data)
    raise ValueError(f"unknown LeakyReLU act_type {act_type!r}")


# -- normalization (the JAX ops/nn.py:383-432) --------------------------------
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False, axis=1,
               training=False):
    """``(out, mean, var)`` over every axis but ``axis``, in f32 whatever
    the input's dtype; ``out`` in the input's dtype. In training (and not
    ``use_global_stats``) the statistics are the batch's, the variance the
    biased one (``jnp.var``); else the moving ones. The moving statistics
    are updated by the layer (``gluon.nn.BatchNorm``), not here. The plain
    composition of the JAX op: ``F.batch_norm`` would hand back unbiased
    variances."""
    ax = int(axis) % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    xf = data.float()
    if training and not use_global_stats:
        mean = xf.mean(dim=red)
        d = xf - mean.reshape(shape)
        var = torch.var(d, dim=red, correction=0)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        d = xf - mean.reshape(shape)
    # (x - mean) · (rsqrt(var + eps) · gamma) + beta in one pass over the
    # activations; its backward keeps only the centred f32 input
    scale = torch.rsqrt(var + eps) * gamma.float()
    out = torch.addcmul(beta.float().reshape(shape), d, scale.reshape(shape))
    return out.to(data.dtype), mean, var


def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalize each (sample, channel) over its spatial axes, in the
    input's dtype."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = (data - mean).square().mean(dim=red, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) + \
        beta.reshape(shape)


# -- the registered operators (the names of mxnet_tpu/ops/nn.py) -------------
from ..registry import register  # noqa: E402


@register("FullyConnected", aliases=("fully_connected",))
def _fully_connected_op(data, weight, bias=None, num_hidden=None,
                        no_bias=False, flatten=True):
    return fully_connected(data, weight, None if no_bias else bias,
                           flatten=flatten)


register("Activation", aliases=("activation",))(activation)
register("softmax")(softmax)
register("log_softmax")(log_softmax)


@register("LayerNorm", aliases=("layer_norm",))
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm over ``axis``: the last axis takes :func:`layer_norm` (the
    kernel's dispatch); another axis is moved last and back."""
    ax = int(axis) % data.dim()
    if ax == data.dim() - 1:
        return layer_norm(data, gamma, beta, eps)
    moved = torch.movedim(data, ax, -1)
    return torch.movedim(layer_norm(moved.contiguous(), gamma, beta, eps),
                         -1, ax)


@register("Dropout", aliases=("dropout",), stochastic=True)
def dropout(data, p=0.5, mode="training", axes=(), training=False, key=None):
    """Inverted dropout when ``training``: the mask is drawn from the
    generator of ``data``'s device (``mxnet_tpu_torch.random``); ``axes``
    share one draw along each named axis. ``key`` (a ``torch.Generator``)
    overrides the generator."""
    from .. import random as _random

    if not training or p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    gen = key if key is not None else _random.generator(data.device)
    mask = torch.empty(shape, device=data.device).bernoulli_(keep,
                                                             generator=gen)
    return torch.where(mask.bool(), data / keep,
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device)).to(data.dtype)


register("Convolution", aliases=("convolution",))(convolution)
register("Deconvolution", aliases=("deconvolution",))(deconvolution)
register("Pooling", aliases=("pooling",))(pooling)
register("_contrib_AdaptiveAvgPooling2D")(adaptive_avg_pooling)
register("LeakyReLU")(leaky_relu)
register("BatchNorm", aliases=("batch_norm",), nout=3)(batch_norm)
register("InstanceNorm")(instance_norm)

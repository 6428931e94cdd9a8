"""The NN ops.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``fully_connected``, the
``layer_norm`` dispatch, ``tanh_gelu``, ``activation``, ``softmax``,
``log_softmax``, and the vision ops: ``convolution``, ``deconvolution``,
``pooling``, ``adaptive_avg_pooling``, ``leaky_relu``, ``batch_norm``,
``instance_norm``; the heads and losses ``softmax_cross_entropy``,
``SoftmaxOutput``, the three regression outputs, ``smooth_l1`` and
``CTCLoss``; ``L2Normalization``, ``RMSNorm``, ``UpSampling`` and
``BilinearResize2D``; the fused ``RNN``) and ``mxnet_tpu/ops/core.py``
(``embedding``).
Matrix products stay ``torch.matmul`` and convolutions cuDNN's, as the JAX
package leaves both to XLA; pooling, the normalizations, the heads and CTC
are plain compositions, as there (none of them is a Pallas kernel in the
JAX package).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .. import config as _config
from ..analysis import audit as _audit
from ..contrib import amp as _amp
from . import layernorm as _ln

__all__ = ["fully_connected", "layer_norm", "tanh_gelu", "embedding",
           "activation", "softmax", "log_softmax", "convolution",
           "deconvolution", "pooling", "adaptive_avg_pooling", "leaky_relu",
           "batch_norm", "instance_norm", "softmax_cross_entropy",
           "softmax_output", "linear_regression_output",
           "logistic_regression_output", "mae_regression_output",
           "smooth_l1", "ctc_loss", "l2_normalization", "rms_norm",
           "upsampling", "bilinear_resize", "rnn", "rnn_param_size"]


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
    idx = idx.clamp(0, v - 1)
    rows = _Lookup.apply(idx, weight) if v <= ONE_HOT_ROWS else \
        F.embedding(idx, weight)
    return torch.where(inside[..., None], rows, float("nan"))


#: tables of at most this many rows (BERT's two token types) take the
#: one-hot product for their gradient; larger ones ``F.embedding``'s own
#: backward, which gave the same bits from call to call at BERT's 30,522
#: words on the card (chip_smoke.py ``[nn_ops]``, PERF.md §6)
ONE_HOT_ROWS = 64


class _Lookup(torch.autograd.Function):
    """``F.embedding`` whose gradient is the product ``one_hot(ids)^T @ g``
    in f32 (TF32 only where the caller turned it on for every matmul),
    summed in a fixed order. ``F.embedding``'s own CUDA backward
    summed the two long runs of one index of BERT's token types (two types
    over 8,192 positions, f32) in an order that changed from call to call,
    so two runs of one step differed in their low bits."""

    @staticmethod
    def forward(ctx, idx, weight):
        ctx.save_for_backward(idx)
        ctx.shape = tuple(weight.shape)
        return F.embedding(idx, weight)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rows, width = ctx.shape
        flat = g.reshape(-1, width).float()
        with _audit.not_a_product("the lookup's scatter-add, summed as a "
                                  "one-hot product"):
            acc = _onehot(idx.reshape(-1), rows, torch.float32).t() @ flat
        return None, acc.to(g.dtype)


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


# -- heads and losses (the JAX ops/nn.py:246-425, :614-685) ------------
def softmax_cross_entropy(data, label):
    """The summed cross entropy of the rows of ``data`` against the class
    ids ``label``."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.long()[:, None]).sum()


def _onehot(idx, k, dtype):
    """One-hot rows of ``idx`` over ``k`` classes; an id outside ``[0, k)``
    gives a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).to(dtype)


class _SoftmaxOutputFn(torch.autograd.Function):
    """Softmax whose gradient is MXNet's fused ``(softmax - smoothed
    one-hot(label)) · grad_scale``: it ignores the incoming gradient unless
    ``out_grad``, as the JAX custom VJP (``_softmax_output_fn``)."""

    @staticmethod
    def forward(ctx, data, label, opts):
        p = torch.softmax(data, dim=-1)
        ctx.save_for_backward(p, label)
        ctx.opts = opts
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, normalization, out_grad,
         smooth_alpha) = ctx.opts
        idx = label.long()
        k = p.shape[-1]
        onehot = _onehot(idx, k, p.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) \
                + (1.0 - onehot) * (smooth_alpha / max(k - 1, 1))
        ds = (p - onehot) * grad_scale
        if out_grad:
            ds = ds * g.to(p.dtype)
        keep = idx != int(ignore_label)
        if use_ignore:
            ds = ds * keep.to(p.dtype)[..., None]
        if normalization == "batch":
            ds = ds / p.shape[0]
        elif normalization == "valid" and use_ignore:
            ds = ds / torch.clamp(keep.float().sum(), min=1.0)
        elif normalization == "valid":
            ds = ds / p.shape[0]
        return ds.to(p.dtype), None, None


def softmax_output(data, label=None, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis. With a label its gradient is the fused
    ``p - smoothed_one_hot(label)`` (:class:`_SoftmaxOutputFn`); without
    one, the plain differentiable softmax. ``multi_output`` raises, as in
    the JAX package."""
    if label is None:
        return torch.softmax(data, dim=-1)
    if multi_output:
        raise NotImplementedError(
            "SoftmaxOutput(multi_output=True) (the (n, c, d...) layout) is "
            "not supported; reshape to (n*d, c) instead")
    opts = (float(grad_scale), int(ignore_label), bool(use_ignore),
            str(normalization), bool(out_grad), float(smooth_alpha))
    return _SoftmaxOutputFn.apply(data, label, opts)


class _RegressionFn(torch.autograd.Function):
    """``link(data)`` with MXNet's fused gradient ``dlink(out, label) ·
    grad_scale / num_output``, independent of the incoming gradient."""

    @staticmethod
    def forward(ctx, data, label, link, dlink, grad_scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.dlink, ctx.grad_scale = dlink, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num_out = max(out.numel() // out.shape[0], 1) if out.dim() else 1
        ds = ctx.dlink(out, label.reshape(out.shape)) * \
            (ctx.grad_scale / num_out)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return ds.to(out.dtype), dlabel, None, None, None


def _regression_head(link, dlink, doc):
    def head(data, label=None, grad_scale=1.0):
        if label is None:
            return link(data)
        return _RegressionFn.apply(data, label, link, dlink, float(grad_scale))

    head.__doc__ = doc
    return head


linear_regression_output = _regression_head(
    lambda x: x, lambda out, lbl: out - lbl,
    "Identity link; backward (out - label) * grad_scale / num_output.")
logistic_regression_output = _regression_head(
    torch.sigmoid, lambda out, lbl: out - lbl,
    "Sigmoid link; backward (p - label) * grad_scale / num_output, the "
    "exact gradient of the implied cross entropy.")
mae_regression_output = _regression_head(
    lambda x: x, lambda out, lbl: torch.sign(out - lbl),
    "Identity link; backward sign(out - label) * grad_scale / num_output.")


def smooth_l1(data, scalar=1.0):
    """Huber-style smooth L1 with its transition at 1 / scalar^2."""
    sigma2 = float(scalar) ** 2
    a = data.abs()
    return torch.where(a < 1.0 / sigma2, 0.5 * sigma2 * data * data,
                       a - 0.5 / sigma2)


_NEG = -1e30  # the JAX recursion's stand-in for log(0)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss, (B,) f32.

    ``data`` (T, B, C) activations (log-softmax taken inside), ``label``
    (B, L) class ids, padded with 0 (``blank_label="first"``: blank is 0
    and labels are 1-based) or -1 (``"last"``: blank is C - 1) when
    ``label_lengths`` is not used. The JAX op's alpha recursion in the log
    semiring, one step a frame over (B, 2L + 1) states, with log(0) as
    -1e30: an alignment that cannot exist (a label longer than its data)
    costs about 1e30, and a frame at or past a row's ``data_lengths``
    leaves its lattice as it was. Differentiated by autograd; no step reads
    a value on the host, so the loss can run inside a captured step."""
    t_len, b, c = data.shape
    n_lab = label.shape[1]
    dev = data.device
    logp = torch.log_softmax(data.float(), dim=-1)
    label = label.long()
    blank = 0 if blank_label == "first" else c - 1
    if label_lengths is not None and use_label_lengths:
        lab_len = label_lengths.long()
    else:
        pad = 0 if blank_label == "first" else -1
        lab_len = (label != pad).long().sum(dim=1)
    if data_lengths is not None and use_data_lengths:
        seq_len = data_lengths.long()
    else:
        seq_len = torch.full((b,), t_len, dtype=torch.long, device=dev)
    n_s = 2 * n_lab + 1
    pos = torch.arange(n_s, device=dev)
    # ext[b, s]: blank on even s, label[(s - 1) // 2] on odd s
    if n_lab:
        at = ((pos - 1) // 2).clamp(0, n_lab - 1).expand(b, n_s)
        lab_at = torch.gather(label, 1, at)
    else:
        lab_at = torch.zeros((b, n_s), dtype=torch.long, device=dev)
    ext = torch.where(pos[None, :] % 2 == 1, lab_at,
                      torch.full_like(lab_at, blank)).clamp(0, c - 1)
    ext_m2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long, device=dev),
                        ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    valid_s = pos[None, :] < (2 * lab_len[:, None] + 1)
    emit = torch.gather(logp, 2, ext[None].expand(t_len, b, n_s))
    live = torch.arange(t_len, device=dev)[:, None] < seq_len[None, :]
    neg = torch.full((), _NEG, device=dev)
    alpha = torch.where((pos[None, :] < 2) & valid_s, emit[0], neg)
    for t in range(1, t_len):
        a1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG)
        a2 = torch.where(can_skip, F.pad(alpha[:, :-2], (2, 0), value=_NEG),
                         neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        new = torch.where(valid_s, merged + emit[t], neg)
        alpha = torch.where(live[t][:, None], new, alpha)
    send = 2 * lab_len
    last_blank = torch.gather(alpha, 1, send[:, None])[:, 0]
    last_label = torch.gather(alpha, 1, (send - 1).clamp(min=0)[:, None])[:, 0]
    ll = torch.logaddexp(last_blank, torch.where(lab_len > 0, last_label, neg))
    return -ll


# -- normalization and resizing (the JAX ops/nn.py:435-457, :596-611) --
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data^2) + eps)`` over each instance (all axes but
    the first), each channel (axis 1) or each spatial position (axes 2 on)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=red, keepdim=True) + eps)


def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """``x · rsqrt(mean(x^2) + eps) · gamma`` over ``axis`` in f32, the
    result in data's dtype."""
    xf = data.float()
    ms = xf.square().mean(dim=int(axis), keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(data.dtype)


def upsampling(data, scale=2, sample_type="nearest", num_args=1):
    """Nearest-neighbour upsampling of the last two axes by ``scale``.
    ``sample_type="bilinear"`` (MXNet's learned deconvolution) raises: the
    JAX op computes nearest whatever it is given."""
    if sample_type != "nearest":
        raise NotImplementedError(
            f"UpSampling(sample_type={sample_type!r}) is not ported; the JAX "
            "op computes nearest whatever it is given")
    s = int(scale)
    return data.repeat_interleave(s, dim=-2).repeat_interleave(s, dim=-1)


def bilinear_resize(data, height=None, width=None, scale_height=None,
                    scale_width=None):
    """(N, C, H, W) resized to (height, width) (or H and W times the scales)
    as ``jax.image.resize(method="linear")``: half-pixel centres and, on a
    downscale, a triangle filter widened by the scale (antialiased). Low
    precision is resized in f32 and cast back."""
    n, c, h, w = data.shape
    oh = int(height) if height else int(h * scale_height)
    ow = int(width) if width else int(w * scale_width)
    x = data.float() if data.dtype in (torch.float16, torch.bfloat16) \
        else data
    out = F.interpolate(x, size=(oh, ow), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.to(data.dtype)


register("softmax_cross_entropy")(softmax_cross_entropy)
register("SoftmaxOutput", aliases=("softmax_output",))(softmax_output)
register("LinearRegressionOutput", aliases=("linear_regression_output",))(
    linear_regression_output)
register("LogisticRegressionOutput", aliases=("logistic_regression_output",))(
    logistic_regression_output)
register("MAERegressionOutput", aliases=("mae_regression_output",))(
    mae_regression_output)
register("smooth_l1")(smooth_l1)
register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                             "_contrib_ctc_loss"))(ctc_loss)
register("L2Normalization")(l2_normalization)
register("RMSNorm", aliases=("_contrib_rms_norm",))(rms_norm)
register("UpSampling")(upsampling)
register("BilinearResize2D", aliases=("_contrib_BilinearResize2D",))(
    bilinear_resize)


# -- the fused RNN (the JAX ops/nn.py:475-591; reference: rnn.cc, cuDNN's
# fused op) --
_RNN_GATES = {"lstm": 4, "gru": 3, "rnn_tanh": 1, "rnn_relu": 1}


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False):
    """The length of the flat parameter vector: per layer and direction
    W_x (gates·H, in) and W_h (gates·H, H), then a b_x and a b_h
    (gates·H) for each."""
    ng, h = _RNN_GATES[mode], int(state_size)
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(int(num_layers)):
        in_dim = int(input_size) if layer == 0 else h * d
        size += d * (ng * h * in_dim + ng * h * h)
    return size + int(num_layers) * d * 2 * ng * h


def _rnn_unflatten(params, ng, num_layers, d, c, h):
    """Views of the flat vector in cuDNN's order: every layer's and
    direction's (W_x, W_h), then every (b_x, b_h)."""
    off = 0

    def take(*shape):
        nonlocal off
        n = math.prod(shape)
        out = params[off:off + n].reshape(shape)
        off += n
        return out

    ws = [[(take(ng * h, c if layer == 0 else h * d), take(ng * h, h))
           for _ in range(d)] for layer in range(num_layers)]
    bs = [[(take(ng * h), take(ng * h)) for _ in range(d)]
          for _ in range(num_layers)]
    return ws, bs


def _rnn_direction(xp, h, c, wh, bh, mode, reverse):
    """One layer and direction over time. ``xp`` (T, B, gates·H) is the
    input projection with its bias (for the GRU only b_x; b_h stays with
    the recurrent product, MXNet's ``n = tanh(x W_n + b_xn + r * (h W_hn +
    b_hn))``). Returns the outputs (T, B, H) and the last (h, c)."""
    hs = h.shape[-1]
    wt = wh.t()
    ys = [None] * xp.shape[0]
    for t in (range(xp.shape[0] - 1, -1, -1) if reverse else
              range(xp.shape[0])):
        if mode == "lstm":
            gates = torch.addmm(xp[t], h, wt)
            s = torch.sigmoid(gates)
            g = torch.tanh(gates[:, 2 * hs:3 * hs])
            c = torch.addcmul(s[:, hs:2 * hs] * c, s[:, :hs], g)
            h = s[:, 3 * hs:] * torch.tanh(c)
        elif mode == "gru":
            hz = torch.addmm(bh, h, wt)
            x_t = xp[t]
            ru = torch.sigmoid(x_t[:, :2 * hs] + hz[:, :2 * hs])
            r, u = ru[:, :hs], ru[:, hs:]
            n = torch.tanh(x_t[:, 2 * hs:] + r * hz[:, 2 * hs:])
            h = (1 - u) * n + u * h
        else:
            pre = torch.addmm(xp[t], h, wt)
            h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
        ys[t] = h
    return torch.stack(ys), h, c


def rnn(data, params, state, state_cell=None, state_size=None, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, projection_size=None,
        training=False, key=None):
    """The fused multi-layer RNN over ``data`` (T, B, C) with cuDNN's flat
    parameter layout (:func:`rnn_param_size`) and the initial states
    ``state`` (and ``state_cell`` for the LSTM; zeros when None), (L·D, B,
    H). Returns (output (T, B, D·H), h_n, c_n), c_n zeros but for the LSTM.

    Each layer and direction makes one input-projection product over all
    T·B rows, then runs the recurrence one step at a time (the recurrent
    product and the gate math), all differentiated by autograd and with no
    host read, so a captured step may hold it. With ``training`` and
    ``p`` > 0 the output of every layer but the last is dropped out,
    drawn from ``key`` (a ``torch.Generator``; None: the port's generator
    of the device, as ``Dropout``)."""
    if mode not in _RNN_GATES:
        raise ValueError(f"RNN: unknown mode {mode!r}")
    if projection_size is not None:
        raise NotImplementedError("RNN: projection_size (LSTMP) is not "
                                  "ported")
    ng = _RNN_GATES[mode]
    t_len, b, c = data.shape
    h, n_layers = int(state_size), int(num_layers)
    d = 2 if bidirectional else 1
    want = rnn_param_size(mode, c, h, n_layers, bidirectional)
    if params.numel() != want:
        raise ValueError(f"RNN: {params.numel()} parameters, {want} "
                         f"expected for {mode} L={n_layers} D={d} C={c} "
                         f"H={h}")
    ws, bs = _rnn_unflatten(params, ng, n_layers, d, c, h)
    h_n, c_n = [], []
    x = data
    for layer in range(n_layers):
        outs = []
        rows = x.reshape(t_len * b, x.shape[-1])
        for direction in range(d):
            idx = layer * d + direction
            (wx, wh), (bx, bh) = ws[layer][direction], bs[layer][direction]
            bias = bx if mode == "gru" else bx + bh
            xp = torch.addmm(bias, rows, wx.t()).reshape(t_len, b, ng * h)
            c0 = state_cell[idx] if state_cell is not None else \
                torch.zeros_like(state[idx])
            ys, hl, cl = _rnn_direction(xp, state[idx], c0, wh, bh, mode,
                                        reverse=direction == 1)
            outs.append(ys)
            h_n.append(hl)
            c_n.append(cl if mode == "lstm" else torch.zeros_like(hl))
        x = torch.cat(outs, dim=-1) if d == 2 else outs[0]
        if training and p > 0 and layer < n_layers - 1:
            x = dropout(x, p=p, training=True, key=key)
    return x, torch.stack(h_n), torch.stack(c_n)


register("RNN", nout=3, stochastic=True)(rnn)

"""The NN ops of the serving path.

Counterpart of ``mxnet_tpu/ops/nn.py`` (``fully_connected``, the
``layer_norm`` dispatch, ``tanh_gelu``, ``activation``, ``softmax``,
``log_softmax``) and ``mxnet_tpu/ops/core.py`` (``embedding``). Matrix
products stay ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import config as _config
from ..contrib import amp as _amp
from . import layernorm as _ln

__all__ = ["fully_connected", "layer_norm", "tanh_gelu", "embedding",
           "activation", "softmax", "log_softmax"]


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

"""Random sampling operators.

Counterpart of ``mxnet_tpu/ops/random_ops.py``: the same registered names,
aliases and parameters. Each op draws from the generator of the device it
samples on (``mxnet_tpu_torch.random.generator``: Philox on the card,
Mersenne Twister on the CPU), so ``mx.random.seed`` reproduces a run; the
JAX package splits a threefry key instead, so the two packages' draws agree
in distribution, never value for value. ``key`` (a ``torch.Generator``)
overrides the generator, as for ``Dropout``.

The ``_random_*`` ops and ``_sample_unique_zipfian`` take no tensor: they
draw on the current context (the card unless the caller names the CPU),
or on ``ctx`` (the port's extra parameter, as the creation ops'
``ctx=``). The ``_sample_*`` ops draw one value per element of their
parameter arrays (then a trailing ``shape``) on those arrays' device.
Gamma draws go through ``torch._standard_gamma`` and Poisson draws through
``torch.poisson``, each in f32, then cast to ``dtype``. Categorical draws
(``_sample_multinomial``, the LM samplers) take the Gumbel-max of the
logits, as ``jax.random.categorical`` does.
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from ..base import MXNetError, dtype_torch
from ..registry import register

__all__ = ["random_uniform", "random_normal", "random_gamma",
           "random_exponential", "random_poisson", "random_randint",
           "random_negative_binomial", "random_generalized_negative_binomial",
           "sample_uniform", "sample_normal", "sample_gamma",
           "sample_exponential", "sample_poisson", "sample_multinomial",
           "sample_negative_binomial", "sample_generalized_negative_binomial",
           "sample_unique_zipfian", "shuffle", "temperature_sampling",
           "top_k_sampling"]


def _device(ctx):
    from ..context import as_device

    return as_device(ctx)


def _gen(key, device):
    return key if key is not None else _random.generator(device)


def _shape(shape):
    if isinstance(shape, (tuple, list)):
        return tuple(int(s) for s in shape)
    return (int(shape),) if shape else ()


def _uniform(shape, dtype, device, gen):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(
        generator=gen)


def _normal(shape, dtype, device, gen):
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        generator=gen)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws, one per element of the f32 tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _poisson(rate, gen):
    return torch.poisson(rate, generator=gen)


def _exponential(shape, device, gen):
    return torch.empty(shape, dtype=torch.float32,
                       device=device).exponential_(1.0, generator=gen)


# -- the scalar-parameter samplers ------------------------------------------
@register("_random_uniform", aliases=("random_uniform", "uniform_sample"),
          stochastic=True)
def random_uniform(low=0.0, high=1.0, shape=(), dtype="float32", key=None,
                   ctx=None):
    dev = _device(ctx)
    u = _uniform(_shape(shape), dtype_torch(dtype), dev, _gen(key, dev))
    return u * (high - low) + low


@register("_random_normal", aliases=("random_normal", "normal_sample"),
          stochastic=True)
def random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32", key=None,
                  ctx=None):
    dev = _device(ctx)
    return _normal(_shape(shape), dtype_torch(dtype), dev,
                   _gen(key, dev)) * scale + loc


@register("_random_gamma", aliases=("random_gamma",), stochastic=True)
def random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32", key=None,
                 ctx=None):
    dev = _device(ctx)
    a = torch.full(_shape(shape), float(alpha), device=dev)
    return (_gamma(a, _gen(key, dev)) * beta).to(dtype_torch(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          stochastic=True)
def random_exponential(lam=1.0, shape=(), dtype="float32", key=None,
                       ctx=None):
    dev = _device(ctx)
    e = _exponential(_shape(shape), dev, _gen(key, dev))
    return (e / lam).to(dtype_torch(dtype))


@register("_random_poisson", aliases=("random_poisson",), stochastic=True)
def random_poisson(lam=1.0, shape=(), dtype="float32", key=None, ctx=None):
    dev = _device(ctx)
    rate = torch.full(_shape(shape), float(lam), device=dev)
    return _poisson(rate, _gen(key, dev)).to(dtype_torch(dtype))


@register("_random_randint", aliases=("random_randint",), stochastic=True)
def random_randint(low=0, high=None, shape=(), dtype="int32", key=None,
                   ctx=None):
    if high is None:
        raise MXNetError("_random_randint needs high")
    dev = _device(ctx)
    return torch.randint(int(low), int(high), _shape(shape),
                         dtype=dtype_torch(dtype), device=dev,
                         generator=_gen(key, dev))


@register("_random_negative_binomial", aliases=("random_negative_binomial",),
          stochastic=True)
def random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32", key=None,
                             ctx=None):
    """NB(k, p) = Poisson(Gamma(k, (1 - p) / p)), MXNet's definition."""
    dev = _device(ctx)
    gen = _gen(key, dev)
    a = torch.full(_shape(shape), float(k), device=dev)
    rate = _gamma(a, gen) * (1.0 - p) / p
    return _poisson(rate, gen).to(dtype_torch(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",), stochastic=True)
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                         dtype="float32", key=None, ctx=None):
    """GNB(mu, alpha) = Poisson(Gamma(1 / alpha, mu · alpha))."""
    dev = _device(ctx)
    gen = _gen(key, dev)
    a = torch.full(_shape(shape), 1.0 / alpha, device=dev)
    rate = _gamma(a, gen) * (mu * alpha)
    return _poisson(rate, gen).to(dtype_torch(dtype))


# -- the per-element samplers (parameters given as arrays) --------------------
def _param(x, like=None):
    """A parameter array as an f32 tensor, on ``like``'s device for a
    number."""
    if torch.is_tensor(x):
        return x.float()
    dev = like.device if torch.is_tensor(like) else _device(None)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _per_elem(param, shape):
    """(the output shape, the parameter reshaped to broadcast against it)."""
    extra = _shape(shape)
    return tuple(param.shape) + extra, \
        param.reshape(tuple(param.shape) + (1,) * len(extra))


@register("_sample_uniform", aliases=("sample_uniform",), stochastic=True)
def sample_uniform(low, high, shape=(), dtype="float32", key=None):
    low = _param(low, high)
    out_shape, lo = _per_elem(low, shape)
    hi = _param(high, low).reshape(lo.shape)
    u = _uniform(out_shape, dtype_torch(dtype), low.device,
                 _gen(key, low.device))
    return (lo + u * (hi - lo)).to(dtype_torch(dtype))


@register("_sample_normal", aliases=("sample_normal",), stochastic=True)
def sample_normal(mu, sigma, shape=(), dtype="float32", key=None):
    mu = _param(mu, sigma)
    out_shape, m = _per_elem(mu, shape)
    s = _param(sigma, mu).reshape(m.shape)
    z = _normal(out_shape, dtype_torch(dtype), mu.device,
                _gen(key, mu.device))
    return (m + z * s).to(dtype_torch(dtype))


@register("_sample_gamma", aliases=("sample_gamma",), stochastic=True)
def sample_gamma(alpha, beta, shape=(), dtype="float32", key=None):
    alpha = _param(alpha, beta)
    out_shape, a = _per_elem(alpha, shape)
    b = _param(beta, alpha).reshape(a.shape)
    g = _gamma(a.expand(out_shape).contiguous(), _gen(key, alpha.device))
    return (g * b).to(dtype_torch(dtype))


@register("_sample_exponential", aliases=("sample_exponential",),
          stochastic=True)
def sample_exponential(lam, shape=(), dtype="float32", key=None):
    lam = _param(lam)
    out_shape, l = _per_elem(lam, shape)
    e = _exponential(out_shape, lam.device, _gen(key, lam.device))
    return (e / l).to(dtype_torch(dtype))


@register("_sample_poisson", aliases=("sample_poisson",), stochastic=True)
def sample_poisson(lam, shape=(), dtype="float32", key=None):
    lam = _param(lam)
    out_shape, l = _per_elem(lam, shape)
    return _poisson(l.expand(out_shape).contiguous(),
                    _gen(key, lam.device)).to(dtype_torch(dtype))


@register("_sample_negative_binomial", aliases=("sample_negative_binomial",),
          stochastic=True)
def sample_negative_binomial(k, p, shape=(), dtype="float32", key=None):
    k = _param(k, p)
    out_shape, kk = _per_elem(k, shape)
    pp = _param(p, k).reshape(kk.shape).expand(out_shape)
    gen = _gen(key, k.device)
    rate = _gamma(kk.expand(out_shape).contiguous(), gen) * (1.0 - pp) / pp
    return _poisson(rate, gen).to(dtype_torch(dtype))


@register("_sample_generalized_negative_binomial",
          aliases=("sample_generalized_negative_binomial",), stochastic=True)
def sample_generalized_negative_binomial(mu, alpha, shape=(), dtype="float32",
                                         key=None):
    mu = _param(mu, alpha)
    out_shape, mm = _per_elem(mu, shape)
    aa = _param(alpha, mu).reshape(mm.shape)
    gen = _gen(key, mu.device)
    rate = _gamma((1.0 / aa).expand(out_shape).contiguous(), gen) * \
        (mm * aa).expand(out_shape)
    return _poisson(rate, gen).to(dtype_torch(dtype))


def _categorical(logits, gen, extra=()):
    """Gumbel-max draws over the last axis of f32 ``logits``: one index per
    row, or ``extra`` more axes of draws per row."""
    lg = logits.reshape(tuple(logits.shape[:-1]) + (1,) * len(extra)
                        + (logits.shape[-1],))
    shape = tuple(logits.shape[:-1]) + tuple(extra) + (logits.shape[-1],)
    u = torch.empty(shape, dtype=torch.float32, device=logits.device)
    u.uniform_(torch.finfo(torch.float32).tiny, 1.0, generator=gen)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


@register("_sample_multinomial", aliases=("sample_multinomial",),
          stochastic=True)
def sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                       key=None):
    """Class ids drawn from the probabilities ``data`` (last axis), shape
    ``data.shape[:-1] + shape``; with ``get_prob`` also each draw's
    log-probability."""
    extra = _shape(shape)
    logits = torch.log(torch.clamp(data.float(), min=1e-37))
    idx = _categorical(logits, _gen(key, data.device), extra)
    out = idx.to(dtype_torch(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(logits, dim=-1)
    logp = logp.reshape(tuple(logp.shape[:-1]) + (1,) * len(extra)
                        + (logp.shape[-1],)).expand(idx.shape
                                                    + (logp.shape[-1],))
    return out, torch.gather(logp, -1, idx[..., None])[..., 0]


# -- LM decoding samplers ------------------------------------------------
@register("temperature_sampling", stochastic=True)
def temperature_sampling(logits, temperature=1.0, key=None):
    """Token ids drawn from ``softmax(logits / temperature)`` over the last
    axis (int32); ``temperature=0`` is the argmax and draws nothing."""
    if not temperature:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits.float() / float(temperature)
    return _categorical(scaled, _gen(key, logits.device)).to(torch.int32)


@register("top_k_sampling", stochastic=True)
def top_k_sampling(logits, k=40, temperature=1.0, key=None):
    """Temperature sampling over the ``k`` largest logits of each row
    (``k <= 0`` or ``k >= vocab``: all of them)."""
    k = int(k)
    if 0 < k < logits.shape[-1]:
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return temperature_sampling(logits, temperature=temperature, key=key)


@register("shuffle", aliases=("_shuffle",), stochastic=True)
def shuffle(data, key=None):
    """``data`` with its first axis permuted."""
    perm = torch.randperm(data.shape[0], generator=_gen(key, data.device),
                          device=data.device)
    return torch.index_select(data, 0, perm)


@register("_sample_unique_zipfian", stochastic=True)
def sample_unique_zipfian(range_max, shape=(), key=None, ctx=None):
    """Log-uniform ids in ``[0, range_max)`` (int32), without the removal of
    duplicates, as the JAX op."""
    dev = _device(ctx)
    u = _uniform(_shape(shape), torch.float32, dev, _gen(key, dev))
    out = torch.exp(u * math.log(float(range_max))).to(torch.int64) - 1
    return torch.clamp(out, 0, int(range_max) - 1).to(torch.int32)

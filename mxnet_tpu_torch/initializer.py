"""Parameter initializers drawn from an explicit ``torch.Generator``.

Counterpart of ``mxnet_tpu/initializer.py``: the same classes, registry
(``mx.init.*``, :func:`create`) and name dispatch (a parameter whose name
ends in ``bias``/``beta``/``running_mean`` starts at zeros, ``gamma``/
``running_var`` at ones, anything else takes :meth:`Initializer.init_array`).
Values are drawn in f32 on the CPU, so a seed gives the same weights
whatever the target device, then cast and moved by the caller. The
generator is the CPU one of ``mxnet_tpu_torch.random`` (seeded by
``mx.random.seed``) unless the caller passes one, as the model zoo's
``seed=`` does.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "Load", "registry", "create"]


def _gen(generator):
    if generator is not None:
        return generator
    from . import random as _random

    return _random.generator("cpu")


class Initializer:
    def init_array(self, shape, generator=None) -> torch.Tensor:
        """An f32 CPU tensor of ``shape``."""
        raise NotImplementedError

    def init_for_name(self, name, shape, generator=None) -> torch.Tensor:
        if name.endswith(("bias", "beta", "running_mean")):
            return torch.zeros(shape)
        if name.endswith(("gamma", "running_var")):
            return torch.ones(shape)
        return self.init_array(tuple(shape), _gen(generator))

    def __call__(self, desc, arr=None):
        """MXNet's ``init(name, arr)``: fill the NDArray ``arr`` in place."""
        name = desc if isinstance(desc, str) else getattr(desc, "name",
                                                          str(desc))
        data = self.init_for_name(name, tuple(arr.shape))
        with torch.no_grad():
            arr._data.copy_(data)


class Zero(Initializer):
    def init_array(self, shape, generator=None):
        return torch.zeros(shape)


class One(Initializer):
    def init_array(self, shape, generator=None):
        return torch.ones(shape)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def init_array(self, shape, generator=None):
        if torch.is_tensor(self.value) or isinstance(self.value, np.ndarray):
            return torch.as_tensor(np.asarray(self.value, np.float32)) \
                .expand(shape).clone()
        return torch.full(shape, float(self.value))


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def init_array(self, shape, generator=None):
        return torch.empty(shape).uniform_(-self.scale, self.scale,
                                           generator=_gen(generator))


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def init_array(self, shape, generator=None):
        return torch.empty(shape).normal_(0.0, self.sigma,
                                          generator=_gen(generator))


class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale

    def init_array(self, shape, generator=None):
        flat = (shape[0], int(np.prod(shape[1:]))) if len(shape) > 1 \
            else (shape[0], 1)
        a = torch.empty(flat).normal_(generator=_gen(generator))
        q, r = torch.linalg.qr(a if flat[0] >= flat[1] else a.T)
        q = q if flat[0] >= flat[1] else q.T
        q = q * torch.sign(torch.diagonal(r))[None, :q.shape[1]]
        return (self.scale * q.reshape(shape)).float()


def _fan(shape):
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type, self.factor_type = rnd_type, factor_type
        self.magnitude = float(magnitude)

    def init_array(self, shape, generator=None):
        fan_in, fan_out = _fan(shape)
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        out = torch.empty(shape)
        if self.rnd_type == "uniform":
            return out.uniform_(-scale, scale, generator=_gen(generator))
        return out.normal_(0.0, scale, generator=_gen(generator))


class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


class Bilinear(Initializer):
    def init_array(self, shape, generator=None):
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return torch.from_numpy(weight)


class LSTMBias(Initializer):
    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def init_array(self, shape, generator=None):
        b = torch.zeros(shape)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b


class Mixed(Initializer):
    """Patterns -> initializers; the first regex that matches wins."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("Mixed: len(patterns) != len(initializers)")
        self.map = [(re.compile(p), i) for p, i in zip(patterns,
                                                        initializers)]

    def init_for_name(self, name, shape, generator=None):
        for pat, ini in self.map:
            if pat.search(name):
                return ini.init_for_name(name, shape, generator)
        raise ValueError(f"Mixed: no pattern matched parameter {name!r}; "
                         "add a catch-all '.*' entry")


class Load(Initializer):
    """Values from a dict of arrays or a ``.params`` file, ``default_init``
    for names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .serialization import load_ndarrays

            param = load_ndarrays(param)
        if not hasattr(param, "items"):
            raise ValueError("Load: params must be a name->array dict (a "
                             "list-saved .params file carries no names to "
                             "match against)")
        self.param = {k.replace("arg:", "").replace("aux:", ""): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def init_for_name(self, name, shape, generator=None):
        if name in self.param:
            arr = self.param[name]
            arr = arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"Load: parameter {name!r} shape "
                                 f"{arr.shape} != {tuple(shape)}")
            return torch.from_numpy(np.array(arr, np.float32))
        if self.default_init is None:
            raise ValueError(f"Load: no value for {name!r} and no "
                             "default_init")
        return self.default_init.init_for_name(name, shape, generator)


registry = {
    "zeros": Zero, "zero": Zero, "ones": One, "one": One,
    "constant": Constant, "uniform": Uniform, "normal": Normal,
    "gaussian": Normal, "orthogonal": Orthogonal, "xavier": Xavier,
    "msra_prelu": MSRAPrelu, "bilinear": Bilinear, "lstmbias": LSTMBias,
    "mixed": Mixed, "load": Load,
}


def create(name, **kwargs) -> Initializer:
    """An initializer from an instance or its registered name."""
    if isinstance(name, Initializer):
        return name
    try:
        return registry[name.lower()](**kwargs)
    except KeyError:
        raise ValueError(f"unknown initializer {name!r}") from None

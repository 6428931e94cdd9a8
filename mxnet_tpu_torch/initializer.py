"""Parameter initializers drawn from an explicit ``torch.Generator``.

Counterpart of the ``Normal``/``Uniform``/``Zero``/``One`` initializers of
``mxnet_tpu/initializer.py``. Values are drawn in f32 on the CPU, so a
seed gives the same weights whatever the target device, then cast.
"""
from __future__ import annotations

import torch

__all__ = ["Initializer", "Normal", "Uniform", "Zero", "One", "create"]


class Initializer:
    def draw(self, shape, generator: torch.Generator) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, param: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            param.copy_(self.draw(tuple(param.shape), generator))


class Zero(Initializer):
    def draw(self, shape, generator):
        return torch.zeros(shape)


class One(Initializer):
    def draw(self, shape, generator):
        return torch.ones(shape)


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def draw(self, shape, generator):
        return torch.empty(shape).uniform_(-self.scale, self.scale,
                                           generator=generator)


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def draw(self, shape, generator):
        return torch.empty(shape).normal_(0.0, self.sigma, generator=generator)


def create(init) -> Initializer:
    """An initializer from an instance or its MXNet name."""
    if isinstance(init, Initializer):
        return init
    names = {"zeros": Zero, "ones": One, "uniform": Uniform, "normal": Normal}
    if init not in names:
        raise ValueError(f"unknown initializer {init!r}")
    return names[init]()

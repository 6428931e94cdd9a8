"""Basic Gluon layers as ``torch.nn.Module``s.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``. Parameter names are
the MXNet structural names (``weight``/``bias``, ``gamma``/``beta``), so a
model's ``state_dict`` keys equal the JAX package's
``_collect_params_with_prefix()`` keys. Each layer draws its initial values
in :meth:`reset_parameters` from an explicit generator.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import initializer as _init
from ...base import dtype_torch, resolve_device
from ...ops import nn as _ops

__all__ = ["Dense", "Embedding", "LayerNorm", "Dropout", "Activation",
           "HybridSequential", "initialize"]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype_torch(dtype),
                                    device=resolve_device(device)))


class Dense(nn.Module):
    """``y = act(x @ weight.T + bias)`` with weight (units, in_units);
    ``activation`` is None or an ``act_type`` of :func:`ops.nn.activation`."""

    def __init__(self, units, flatten=True, in_units=0, use_bias=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", device="cuda", activation=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense needs in_units (no deferred shapes)")
        self._flatten = flatten
        self._act = activation
        self._weight_init = _init.create(weight_initializer or "uniform")
        self._bias_init = _init.create(bias_initializer)
        self.weight = _param((units, in_units), dtype, device)
        self.bias = _param((units,), dtype, device) if use_bias else None

    def reset_parameters(self, generator):
        self._weight_init(self.weight, generator)
        if self.bias is not None:
            self._bias_init(self.bias, generator)

    def forward(self, x):
        out = _ops.fully_connected(x, self.weight, self.bias,
                                   flatten=self._flatten)
        return out if self._act is None else _ops.activation(out, self._act)


class Embedding(nn.Module):
    """Row lookup into a (input_dim, output_dim) weight."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, device="cuda"):
        super().__init__()
        self._input_dim = int(input_dim)
        self._weight_init = _init.create(weight_initializer or "uniform")
        self.weight = _param((input_dim, output_dim), dtype, device)

    def reset_parameters(self, generator):
        self._weight_init(self.weight, generator)

    def forward(self, x):
        return _ops.embedding(x, self.weight)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with ``gamma``/``beta``."""

    def __init__(self, epsilon=1e-5, in_channels=0, dtype="float32",
                 beta_initializer="zeros", gamma_initializer="ones",
                 device="cuda"):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm needs in_channels")
        self._eps = float(epsilon)
        self._gamma_init = _init.create(gamma_initializer)
        self._beta_init = _init.create(beta_initializer)
        self.gamma = _param((in_channels,), dtype, device)
        self.beta = _param((in_channels,), dtype, device)

    def reset_parameters(self, generator):
        self._gamma_init(self.gamma, generator)
        self._beta_init(self.beta, generator)

    def forward(self, x):
        return _ops.layer_norm(x, self.gamma, self.beta, self._eps)


class Dropout(nn.Module):
    """Inverted dropout, active only in training mode."""

    def __init__(self, rate):
        super().__init__()
        self._rate = float(rate)

    def forward(self, x):
        if not self.training or self._rate == 0.0:
            return x
        return torch.nn.functional.dropout(x, self._rate, training=True)


class Activation(nn.Module):
    """The elementwise activation ``activation`` (an ``act_type`` of
    :func:`ops.nn.activation`)."""

    def __init__(self, activation):
        super().__init__()
        self._act = activation

    def forward(self, x):
        return _ops.activation(x, self._act)


class HybridSequential(nn.Sequential):
    """Children named ``0``, ``1``, ... in the order they are added."""

    def add(self, *blocks):
        for blk in blocks:
            self.append(blk)


def initialize(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every layer's parameters, in registration order."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)

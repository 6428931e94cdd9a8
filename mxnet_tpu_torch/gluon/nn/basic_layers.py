"""Basic Gluon layers, rebased on ``HybridBlock``.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``. Each layer declares
its parameters by MXNet's structural names (``weight``/``bias``,
``gamma``/``beta``) and computes in ``hybrid_forward(F, x, **params)``
with ``F`` the port's ``nd``, whose ops reach the same kernel wrappers the
models call (LayerNorm's kernel, ...). A shape given in full is allocated
at construction on ``device`` (default: the current context, ``gpu(0)``,
so without a card it raises unless the caller names the CPU); a 0 in it
(``Dense(in_units=0)``, ``LayerNorm(in_channels=0)``) waits for the first
forward. Values come from ``initialize`` (or a load).
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _ag
from ..block import Block, HybridBlock, imperative

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "LayerNorm",
           "Embedding", "Activation"]


class _SequenceMixin:
    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def forward(self, x, *args):
        for b in self._modules.values():
            x = b(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_SequenceMixin, Block):
    """Children called in the order they were added (named ``0``, ``1``,
    ...); a child may be any ``torch.nn.Module``."""


class HybridSequential(_SequenceMixin, HybridBlock):
    """Children called in the order they were added (named ``0``, ``1``,
    ...); a child may be any ``torch.nn.Module``."""


class Dense(HybridBlock):
    """``y = act(x @ weight.T + bias)`` with weight (units, in_units);
    ``in_units=0`` is inferred at the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        self._act = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
        if in_units > 0:
            self._alloc_params(device)

    def infer_shape(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._reg_params["weight"].shape = (self._units, int(in_units))
        if "bias" in self._reg_params:
            self._reg_params["bias"].shape = (self._units,)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Dropout(HybridBlock):
    """Inverted dropout. Under an imperative (NDArray) call it is active
    when ``autograd.is_training()`` and draws from the port's generators
    (``F.Dropout``); under a call on tensors (``TrainStep``, the engine) it
    is active when the module is in training mode and draws from
    PyTorch's default generator, which a captured CUDA graph replays."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = float(rate)
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        if imperative():
            return F.Dropout(x, p=self._rate, axes=self._axes,
                             training=_ag.is_training())
        if not self.training or self._rate == 0.0:
            return x
        if not self._axes:
            return torch.nn.functional.dropout(x, self._rate, training=True)
        shape = list(x.shape)
        for a in self._axes:
            shape[a] = 1
        keep = 1.0 - self._rate
        mask = torch.empty(shape, device=x.device).bernoulli_(keep)
        return torch.where(mask.bool(), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(HybridBlock):
    """LayerNorm over ``axis`` with ``gamma``/``beta``; ``in_channels=0``
    is inferred at the first forward. Over the last axis it takes the
    kernel's dispatch (``ops.nn.layer_norm``)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, dtype="float32",
                 device=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._eps = float(epsilon)
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), dtype=dtype,
                init=gamma_initializer, allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), dtype=dtype,
                init=beta_initializer, allow_deferred_init=True)
        if in_channels > 0:
            self._alloc_params(device)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        self._reg_params["gamma"].shape = (c,)
        self._reg_params["beta"].shape = (c,)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class Embedding(HybridBlock):
    """Row lookup into a (input_dim, output_dim) weight."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise ValueError("Embedding(sparse_grad=True): row-sparse "
                             "gradients are not ported")
        self._input_dim, self._output_dim = input_dim, output_dim
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer)
        self._alloc_params(device)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)


class Activation(HybridBlock):
    """The elementwise activation ``activation`` (an ``act_type`` of
    ``ops.nn.activation``)."""

    def __init__(self, activation, prefix=None, params=None):
        self._act = activation  # before super().__init__: _alias needs it
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act if isinstance(self._act, str) else "activation"

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act)

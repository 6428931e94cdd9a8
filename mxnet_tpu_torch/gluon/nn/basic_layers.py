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
from ..block import (Block, HybridBlock, imperative, record_state_update,
                     symbolic)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "LayerNorm", "InstanceNorm", "Embedding", "Flatten", "Lambda",
           "HybridLambda", "Activation", "LeakyReLU", "PReLU", "ELU", "SELU",
           "Swish", "GELU"]



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
        if imperative() or symbolic():
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


class BatchNorm(HybridBlock):
    """Batch normalization over every axis but ``axis``; ``in_channels=0``
    is inferred at the first forward. In training (``autograd.is_training()``
    under an imperative call, as in the JAX package; the module's training
    flag under a call on tensors, which ``TrainStep`` sets; under a
    symbolic trace the node records ``autograd.is_training()`` and nothing
    is written) it
    normalizes with the batch's statistics and moves the moving ones to
    ``momentum * running + (1 - momentum) * batch``, the batch variance
    the biased one, as the JAX layer computes them; that write goes
    through :func:`~..block.record_state_update` into the f32 statistic,
    so ``TrainStep`` updates them as the imperative loop does (the JAX
    ``TrainStep`` leaves them as they were). Otherwise (or with
    ``use_global_stats``) it normalizes with the moving statistics.
    ``cast`` leaves gamma, beta and the statistics in f32."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._momentum = float(momentum)
        self._eps = float(epsilon)
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                "running_var", shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)
        for p in (self._reg_params["running_mean"],
                  self._reg_params["running_var"]):
            p.is_state = True
        if in_channels > 0:
            self._alloc_params(device)

    def infer_shape(self, x, *args):
        c = x.shape[self._axis]
        for p in self._reg_params.values():
            p.shape = (c,)

    def cast(self, dtype):
        for p in self._reg_params.values():
            p.cast("float32")
        return self

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        training = (_ag.is_training() if imperative() or symbolic()
                    else self.training) and not self._use_global_stats
        out, mean, var = F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self._eps,
            momentum=self._momentum, axis=self._axis, training=training,
            use_global_stats=self._use_global_stats)
        if training and not symbolic():
            m = self._momentum
            for name, batch in (("running_mean", mean), ("running_var", var)):
                p = self._reg_params[name]
                with torch.no_grad():
                    new = m * p.tensor() + (1 - m) * batch
                record_state_update(p, new)
        return out


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


class InstanceNorm(HybridBlock):
    """Normalize each (sample, channel) over its spatial axes, with
    per-channel ``gamma``/``beta``; ``in_channels=0`` is inferred at the
    first forward. ``axis``, ``center`` and ``scale`` are taken and
    ignored, as by the JAX layer."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._eps = float(epsilon)
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)
        if in_channels > 0:
            self._alloc_params(device)

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p.shape = (x.shape[1],)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class Embedding(HybridBlock):
    """Row lookup into a (input_dim, output_dim) weight.

    ``sparse_grad=True`` declares the weight's gradient row-sparse: the
    backward still writes a dense gradient, but each recorded forward
    notes the rows its ids touch, and ``gluon.Trainer`` hands the
    optimizer only those rows (a RowSparseNDArray, the lazy update)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim, self._output_dim = input_dim, output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer,
                grad_stype="row_sparse" if sparse_grad else "default")
        self._alloc_params(device)

    def hybrid_forward(self, F, x, weight):
        if self._sparse_grad:
            self._record_rows(x)
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim)

    def _record_rows(self, x):
        """Add the rows ``x`` touches to the weight's ``_sparse_rows`` (a
        sorted union until the Trainer's next update). Only a recorded
        forward on a tensor counts: not an inference forward (its rows are
        in no gradient), not a trace to a Symbol, and not a forward inside
        a CUDA graph capture (``TrainStep`` updates densely, and finding
        the unique ids reads their count on the host)."""
        from ... import autograd

        if not autograd.is_recording() or not torch.is_tensor(x):
            return
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            return
        param = self._reg_params["weight"]
        rows = torch.unique(x.detach().reshape(-1)).to(torch.int32)
        if param._sparse_rows is not None:
            rows = torch.unique(torch.cat([param._sparse_rows, rows]))
        param._sparse_rows = rows


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


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Lambda(Block):
    """Wraps a function of the inputs, or the name of an ``nd`` op."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = function

    def forward(self, *args):
        from ... import ndarray as nd

        fn = getattr(nd, self._fn) if isinstance(self._fn, str) else self._fn
        return fn(*args)


class HybridLambda(HybridBlock):
    """Wraps ``function(F, *inputs)``, or the name of an ``F`` op."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._fn = function

    def hybrid_forward(self, F, *args):
        if isinstance(self._fn, str):
            return getattr(F, self._fn)(*args)
        return self._fn(F, *args)


class LeakyReLU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha=0.01, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned per-channel slope ``alpha``."""

    def __init__(self, alpha_initializer=None, in_channels=1, prefix=None,
                 params=None, device=None):
        super().__init__(prefix=prefix, params=params)
        from ... import initializer

        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(in_channels,),
                init=alpha_initializer or initializer.Constant(0.25))
        self._alloc_params(device)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    """``x`` where ``x >= 0``, else ``alpha * (exp(x) - 1)``."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """Scaled ELU with the self-normalizing constants."""

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """GELU, the erf form or (``approximation="tanh"``) the tanh one."""

    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._approx = approximation

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type="gelu" if self._approx == "erf"
                            else "tanh_gelu")

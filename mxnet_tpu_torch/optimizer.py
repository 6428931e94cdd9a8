"""Optimizer registry and Adam.

Counterpart of the ``Optimizer``/``Adam`` subset of ``mxnet_tpu/optimizer.py``
that the single-device ``TrainStep`` uses: the hyperparameters, the
``lr_mult``/``wd_mult`` dicts, ``create_state`` and the pure-state update
``update_raw``. Updates run in place on the weight and state tensors (see
``ops/optimizer.py``). :meth:`Optimizer.update_raw_multi` applies one update
to a list of parameters; Adam's runs as one multi-tensor kernel launch on
the card when the ``fused_adam`` knob is on.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import config as _config
from .base import MXNetError
from .ops import optimizer as _oo

__all__ = ["Optimizer", "Adam", "create", "register"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(cls):
    _OPT_REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs):
    """An optimizer from its registered name (or the instance itself)."""
    if isinstance(name, Optimizer):
        return name
    try:
        cls = _OPT_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; available: "
                         f"{sorted(_OPT_REGISTRY)}") from None
    return cls(**kwargs)


class Optimizer:
    """Hyperparameters and the pure-state protocol. ``lr_scheduler`` and
    ``multi_precision`` are not ported yet and are refused."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, param_dict=None, lr_scheduler=None,
                 multi_precision=False):
        if lr_scheduler is not None or multi_precision:
            raise MXNetError("lr_scheduler and multi_precision are not "
                             "ported yet")
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient if clip_gradient is not None \
            else -1.0
        #: host mirror of the number of steps taken (TrainStep advances it)
        self.num_update = 0
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        self.param_dict = param_dict or {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def create_state(self, index, weight):
        """The per-parameter state (tensors on the weight's device)."""
        raise NotImplementedError

    def update_raw(self, w, g, state, lr, wd, t):
        """One parameter, in place: ``(w, g, state, lr, wd, step)`` ->
        ``(w, state)``. ``lr``, ``wd`` and ``t`` may be device tensors, so
        a schedule never syncs the host."""
        raise NotImplementedError

    def update_raw_multi(self, ws, gs, states, lr, wd, t):
        """One update of every parameter in the lists; ``lr`` and ``wd`` are
        (N,) f32 tensors (the rates times each parameter's multiplier)."""
        for i, (w, g, s) in enumerate(zip(ws, gs, states)):
            self.update_raw(w, g, s, lr[i], wd[i], t)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros_like(weight, dtype=torch.float32),
                torch.zeros_like(weight, dtype=torch.float32))

    def _lr_t(self, lr, t):
        """The bias correction folded into lr, in f32 as the JAX optimizer
        does; ``lr`` (a float or a tensor of any shape) and ``t`` (an int or
        a device int tensor) stay where they are, so no host sync."""
        dev = lr.device if torch.is_tensor(lr) else \
            (t.device if torch.is_tensor(t) else None)
        tf = torch.as_tensor(t, device=dev).to(torch.float32)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=tf.device)
        coef1 = 1.0 - torch.pow(self.beta1, tf)
        coef2 = 1.0 - torch.pow(self.beta2, tf)
        return lr * torch.sqrt(coef2) / coef1

    def _hyper(self):
        return dict(beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)

    def update_raw(self, w, g, state, lr, wd, t):
        """One parameter through the plain version."""
        mean, var = state
        h = self._hyper()
        _oo.adam_update(w, g, mean, var, self._lr_t(lr, t), h["beta1"],
                        h["beta2"], h["epsilon"], wd, h["rescale_grad"],
                        h["clip_gradient"])
        return w, (mean, var)

    def update_raw_multi(self, ws, gs, states, lr, wd, t):
        """All parameters at once: one kernel launch on the card when the
        ``fused_adam`` knob is on, else the plain version per parameter."""
        if not _config.get("fused_adam"):
            return super().update_raw_multi(ws, gs, states, lr, wd, t)
        _oo.adam_update_fused(ws, gs, [s[0] for s in states],
                              [s[1] for s in states], self._lr_t(lr, t), wd,
                              **self._hyper())

"""Learning-rate schedules.

Counterpart of ``mxnet_tpu/lr_scheduler.py``: pure functions of the update
count with the same linear or constant warm-up. The JAX schedules compute
in float32 (jnp arrays, Python constants taking the array's type), so these
compute in numpy float32 with each Python constant converted where the JAX
expression converts it; Python's float64 would differ in the last bits.
``pow`` and ``cos`` of f32 operands are taken in float64 and rounded once,
which gives XLA's f32 results where numpy's own f32 versions are off by
an ulp.
A schedule is evaluated on the host once per step; ``TrainStep`` sends the
rate to the card without waiting for it.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]

_f32 = np.float32


def _pow(x, y):
    return _f32(np.power(np.float64(_f32(x)), np.float64(_f32(y))))


def _cos(x):
    return _f32(np.cos(np.float64(_f32(x))))


def _integer_pow(x, n):
    """``x ** n`` for a Python int ``n`` by f32 squaring and multiplying in
    the order of ``lax.integer_pow``, which ``jnp.power`` takes for a
    concrete integer exponent."""
    acc, x, y = None, _f32(x), abs(int(n))
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    acc = _f32(1.0) if acc is None else acc
    return _f32(1.0) / acc if n < 0 else acc


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0.0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = _f32(self.warmup_final_lr - self.warmup_begin_lr) \
                * _f32(num_update) / _f32(max(self.warmup_steps, 1))
            return _f32(self.warmup_begin_lr) + inc
        return _f32(self.warmup_begin_lr)

    def base_call(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        """The rate at update ``num_update`` as a numpy float32."""
        if self.warmup_steps and num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        return self.base_call(num_update)


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 **kw):
        super().__init__(base_lr, **kw)
        self.step, self.factor, self.stop_factor_lr = step, factor, stop_factor_lr

    def base_call(self, num_update):
        n = int(num_update) // self.step
        lr = _f32(self.base_lr) * _pow(self.factor, n)
        return np.maximum(lr, _f32(self.stop_factor_lr))


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, **kw):
        super().__init__(base_lr, **kw)
        self.step, self.factor = list(step), factor

    def base_call(self, num_update):
        n = _f32(0.0)
        for s in self.step:
            n = n + _f32(num_update >= s)
        return _f32(self.base_lr) * _pow(self.factor, n)


def _frac(num_update, warmup_steps, max_update):
    """``clip(clip(t - warmup, 0) / max(max_update - warmup, 1), 0, 1)`` in
    f32."""
    frac = max(_f32(num_update) - _f32(warmup_steps), _f32(0.0)) \
        / _f32(max(max_update - warmup_steps, 1))
    return min(max(frac, _f32(0.0)), _f32(1.0))


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update, self.pwr, self.final_lr = max_update, pwr, final_lr

    def base_call(self, num_update):
        frac = _frac(num_update, self.warmup_steps, self.max_update)
        base = _f32(1.0) - frac
        p = _integer_pow(base, self.pwr) if isinstance(self.pwr, int) \
            else _pow(base, self.pwr)
        return _f32(self.final_lr) + _f32(self.base_lr - self.final_lr) * p


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, **kw):
        super().__init__(base_lr, **kw)
        self.max_update, self.final_lr = max_update, final_lr

    def base_call(self, num_update):
        frac = _frac(num_update, self.warmup_steps, self.max_update)
        return _f32(self.final_lr) + _f32(self.base_lr - self.final_lr) \
            * (_f32(1.0) + _cos(_f32(math.pi) * frac)) / _f32(2.0)

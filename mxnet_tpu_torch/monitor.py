"""``mx.mon`` — training-time tensor monitor: a copy of
``mxnet_tpu/monitor.py``. Every ``interval`` steps it runs a stat function
over the observed block's parameters (and their gradients, except under a
``TrainStep``, whose gradients live only inside its step program) and
returns or logs a table; the rows also go to the event log
(``monitor_stat``)."""
from __future__ import annotations

import logging
import math
import re
from typing import Callable, List, Tuple

import numpy as np

__all__ = ["Monitor"]


def _default_stat(arr: np.ndarray) -> float:
    return float(np.abs(arr).sum() / max(arr.size, 1))


def _host(x) -> np.ndarray:
    """An NDArray, Parameter value or tensor as a host f32 array."""
    t = getattr(x, "_data", x)
    if hasattr(t, "detach"):
        return t.detach().float().cpu().numpy()
    return np.asarray(x)


class Monitor:
    def __init__(self, interval: int, stat_func: Callable = None,
                 pattern=".*", sort=False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _default_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, float]] = []

    def install(self, module_or_block, trainer=None, train_step=None):
        """Set the observation target and (optionally) hook the monitor into
        a training loop: ``trainer=`` runs tic/toc around every
        ``Trainer.step()``, ``train_step=`` at every step and window
        boundary of a ``TrainStep``. Without either, the caller drives
        ``tic``/``toc``."""
        self._target = module_or_block
        if trainer is not None:
            trainer.attach_monitor(self)
        if train_step is not None:
            train_step.attach_monitor(self)
        return self

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def _params(self):
        tgt = getattr(self, "_target", None)
        if tgt is None:
            return []
        if hasattr(tgt, "collect_params"):
            return list(tgt.collect_params().items())
        if hasattr(tgt, "named_parameters"):
            return list(tgt.named_parameters())
        params = getattr(tgt, "_arg_params", {}) or {}
        return list(params.items()) if hasattr(params, "items") else []

    def toc(self) -> List[Tuple[int, str, float]]:
        if not self.activated:
            return []
        for name, p in self._params():
            if not self.re.match(name):
                continue
            data = p.data() if callable(getattr(p, "data", None)) else p
            self.queue.append((self.step, name, self.stat_func(_host(data))))
            # no grad rows when observing a TrainStep: its gradients exist
            # only inside the step program
            if getattr(self, "_skip_grads", False):
                continue
            grad = getattr(p, "grad", None)
            g = grad() if callable(grad) else grad
            if g is not None:
                self.queue.append((self.step, name + "_grad",
                                   self.stat_func(_host(g))))
        self.activated = False
        res = sorted(self.queue, key=lambda x: x[1]) if self.sort \
            else list(self.queue)
        from . import observability as _obs

        for step, name, value in res:
            _obs.emit("monitor_stat", tensor=name, value=float(value),
                      monitor_step=step)
        return res

    def toc_print(self):
        for step, name, value in self.toc():
            logging.info("Batch: %7d %30s %s", step, name,
                         f"{value:.6g}" if math.isfinite(value)
                         else str(value))

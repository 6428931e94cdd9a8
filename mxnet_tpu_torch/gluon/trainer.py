"""gluon.Trainer on one device.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (``step``, ``update``,
``allreduce_grads``, ``zero_grad``, the learning rate, ``save_states``/
``load_states``). ``step(batch_size)`` sets ``rescale_grad`` to
``1/batch_size`` (times the AMP loss-scale correction), then updates every
parameter whose ``grad_req`` is not ``"null"`` from its ``.grad``. The
update lists are built once per step and go to the optimizer's
multi-tensor update in one call (Adam: one kernel launch on the card for
all f32 weights, one for all bf16/f16 weights under ``multi_precision``,
whose f32 masters live in the optimizer states and whose new values the
kernel writes into the parameters' own storage).

One device, no kvstore: ``kvstore`` ``"device"``/``"local"``/None are
accepted and ``allreduce_grads`` does nothing; a ``dist_*`` kvstore
raises until the multi-device slice. ``Trainer.run``,
``install_preemption``, ``attach_monitor`` and row-sparse gradients are
not ported.

``save_states`` writes a pickle of numpy states in the JAX package's
layout (``{"states": [...], "num_update": n, "index_update_count": {...}}``,
Adam's state a (mean, var) tuple, a master state ``{"master", "base"}``),
so either package reads the other's file.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import optimizer as opt_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        raise MXNetError("save_states: a bfloat16 optimizer state has no "
                         "numpy form")
    return t.cpu().numpy()


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("params must be a ParameterDict or list of "
                             "Parameters")
        if kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(f"kvstore {kvstore!r} is not ported: the port's "
                             "Trainer runs on one device")
        self._params = []
        self._param_names = []
        for p in params:
            if not isinstance(p, Parameter):
                raise ValueError(f"expected Parameter, got {type(p)}")
            if p.grad_req != "null":
                self._params.append(p)
                self._param_names.append(p.name)
        self._optimizer = opt_mod.create(optimizer,
                                         **(optimizer_params or {}))
        self._optimizer.idx2name = dict(enumerate(self._param_names))
        self._optimizer.param_dict = {p.name: p for p in self._params}
        self._states = [None] * len(self._params)
        self._states_created = [False] * len(self._params)
        self._scale = self._optimizer.rescale_grad
        self._kvstore = kvstore

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _ensure_states(self):
        for i, p in enumerate(self._params):
            if not self._states_created[i]:
                var = p.var()
                master = p.take_f32_source() \
                    if self._optimizer._needs_master(var) else None
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, var, master=master)
                self._states_created[i] = True

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def step(self, batch_size, ignore_stale_grad=False):
        """One update from the current gradients, each divided by
        ``batch_size``. Under float16 AMP (``contrib.amp.init_trainer``) a
        step whose gradients overflowed is skipped and the loss scale
        shrinks."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None and scaler.enabled:
            skip = scaler.has_overflow(self._params)
            scaler.update_scale(skip)
            if skip:
                return
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        """Every parameter's update in one optimizer call. A parameter
        without a gradient yet is updated with zeros, as in the JAX
        package, where a gradient starts at zeros."""
        self._ensure_states()
        idxs, ws, gs, sts = [], [], [], []
        for i, p in enumerate(self._params):
            var = p._var
            if var is None:
                continue
            g = var.grad
            if g is None:
                g = p.grad()._data
            idxs.append(i)
            ws.append(var.detach())
            gs.append(g)
            sts.append(self._states[i])
        if not idxs:
            return
        new = self._optimizer.update_tensors(idxs, ws, gs, sts)
        for i, s in zip(idxs, new):
            self._states[i] = s

    def zero_grad(self):
        for p in self._params:
            p.zero_grad()

    # -- optimizer-state checkpoints ----------------------------------------
    def save_states(self, fname):
        self._ensure_states()
        blob = pickle.dumps({
            "states": _tree_map(_to_numpy, list(self._states)),
            "num_update": self._optimizer.num_update,
            "index_update_count": dict(self._optimizer._index_update_count)})
        tmp = f"{fname}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, fname)

    def load_states(self, fname):
        """States from ``save_states`` of either package, each put on its
        parameter's device."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        states = list(blob["states"])
        if len(states) != len(self._params):
            raise MXNetError(f"{fname}: {len(states)} states for "
                             f"{len(self._params)} parameters")
        for i, p in enumerate(self._params):
            dev = p.var().device
            states[i] = _tree_map(
                lambda a: torch.from_numpy(np.array(a)).to(dev), states[i])
        self._states = states
        self._states_created = [True] * len(states)
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])

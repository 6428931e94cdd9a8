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
raises until the multi-device slice. Row-sparse gradients are not ported.

:meth:`Trainer.run` is the compiled route (the JAX ``Trainer.run``): it
builds and caches a ``parallel.TrainStep`` over the same optimizer and
runs ``TrainStep.run`` (one CUDA graph a window of steps), seeded from and
written back to this trainer's states, so ``step()`` and ``run()``
interleave. ``install_preemption`` and ``attach_monitor`` act at every
``step()`` and at the end of every ``run()``.

``save_states`` writes a pickle of numpy states in the JAX package's
layout (``{"states": [...], "num_update": n, "index_update_count": {...}}``,
Adam's state a (mean, var) tuple, a master state ``{"master", "base"}``),
so either package reads the other's file.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from .. import observability as _obs
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


def _leaves(state):
    if state is None:
        return []
    return list(state) if isinstance(state, (tuple, list)) else [state]


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
        # graceful preemption: set by install_preemption
        self._preempt_guard = None
        self._preempt_save = None
        self._preempt_exit = True
        self._preempt_saved = False
        self._monitors = []  # run around every step()
        self._obs_steps = 0  # steps recorded under telemetry
        # run()'s TrainStep, cached with its signature
        self._fused = None
        # float16 overflow skips of every TrainStep run() built: num_update
        # counts attempted steps, so the applied count is num_update - this
        self._amp_compiled_skips = 0

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
                var = p.tensor()
                master = p.take_f32_source() \
                    if self._optimizer._needs_master(var) else None
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, var, master=master)
                self._states_created[i] = True

    def allreduce_grads(self):
        """Nothing to reduce on one device."""

    def attach_monitor(self, mon):
        """Register a :class:`~mxnet_tpu_torch.monitor.Monitor` whose
        tic/toc run around every ``step()`` (the wiring ``Monitor.install
        (net, trainer=...)`` performs)."""
        self._monitors.append(mon)
        return mon

    def step(self, batch_size, ignore_stale_grad=False):
        """One update from the current gradients, each divided by
        ``batch_size``. Under float16 AMP (``contrib.amp.init_trainer``) a
        step whose gradients overflowed is skipped and the loss scale
        shrinks. Under telemetry (``observability.enabled()``) each step,
        skipped or not, records ``train_step_seconds{loop="trainer"}``,
        ``train_steps_total``, ``train_samples_total`` and the step id, and
        a skipped one ``train_amp_skipped_steps_total``, as the JAX
        Trainer does; without it the step does no telemetry work."""
        obs_on = _obs.enabled()
        t0 = time.perf_counter() if obs_on else 0.0
        for m in self._monitors:
            m.tic()
        self._optimizer.rescale_grad = self._scale / batch_size
        self.allreduce_grads()
        scaler = getattr(self, "_amp_loss_scaler", None)
        skip = False
        if scaler is not None and scaler.enabled:
            skip = scaler.has_overflow(self._params)
            scaler.update_scale(skip)
        if not skip:
            self._update(ignore_stale_grad)
        self._finish_step(obs_on, t0, batch_size, skipped=skip)
        self._check_preemption()

    def _finish_step(self, obs_on, t0, batch_size, skipped=False):
        for m in self._monitors:
            m.toc_print()
        if not obs_on:
            return
        dt = time.perf_counter() - t0
        self._obs_steps += 1
        _obs.set_step(self._obs_steps)
        _obs.histogram("train_step_seconds", "full train-step wall clock",
                       unit="s").observe(dt, loop="trainer")
        _obs.counter("train_steps_total").inc(loop="trainer")
        _obs.counter("train_samples_total").inc(int(batch_size),
                                                loop="trainer")
        if skipped:
            _obs.counter("train_amp_skipped_steps_total",
                         "steps dropped by AMP overflow handling").inc()

    # -- graceful preemption --------------------------------------------------
    def install_preemption(self, save_fn, guard=None, exit_on_preempt=True):
        """SIGTERM/SIGINT -> run ``save_fn()`` (the caller's checkpoint
        action, e.g. ``lambda: (net.save_parameters(p),
        trainer.save_states(s))``) at the next completed ``step()`` or
        ``run()``, then raise :class:`~mxnet_tpu_torch.resilience.Preempted`
        (``SystemExit(0)``). Returns the installed guard."""
        from ..resilience.preemption import PreemptionGuard

        self._preempt_guard = (guard or PreemptionGuard()).install()
        self._preempt_save = save_fn
        self._preempt_exit = exit_on_preempt
        self._preempt_saved = False  # re-arm the one-shot save on reinstall
        return self._preempt_guard

    def _check_preemption(self):
        g = self._preempt_guard
        if g is None or not g.requested:
            return
        from ..resilience.preemption import Preempted

        # one-shot: with exit_on_preempt=False the caller's loop may run
        # more steps before winding down
        if self._preempt_save is not None and not self._preempt_saved:
            self._preempt_save()
            self._preempt_saved = True
        if self._preempt_exit:
            raise Preempted(g.signum)

    # -- the compiled route ---------------------------------------------------
    def run(self, net, loss_fn, data_iter, steps=None, window=None,
            accum=None, mesh=None, rules=None, layout=None,
            n_model_inputs=1, amp="auto"):
        """Train ``steps`` steps in windows of ``window`` through a
        ``parallel.TrainStep`` over this trainer's optimizer (built for
        ``(net, loss_fn, n_model_inputs, amp)`` and cached): one captured
        CUDA graph and at most one host sync per window (``TrainStep.run``,
        whose arguments these are).

        Before every call the step is seeded from the imperative side: each
        parameter's optimizer state (a ``multi_precision`` state
        ``{"master", "base"}`` gives the step its base as the moments and
        its master as the step's f32 master), and Adam's t from the applied
        update count. Afterwards, also when the run raises (a source error,
        ``Preempted``), the states, the per-index update counts and the
        float16 skip count are written back, the states being the step's
        own tensors from then on: ``step()`` and ``run()`` interleave.

        Returns the per-step losses as one device tensor.
        ``mesh=``/``rules=``/``layout=`` are not ported yet and raise.
        """
        from ..contrib.amp import resolve_policy
        from ..parallel.train_step import TrainStep

        if mesh is not None or rules is not None or layout is not None:
            raise MXNetError("Trainer.run(mesh=/rules=/layout=) is not "
                             "ported yet: the port trains on one device")
        policy = resolve_policy(amp)
        sig = (net, loss_fn, n_model_inputs, policy)
        ts = None
        if self._fused is not None and all(
                a is b or a == b for a, b in zip(self._fused[0], sig)):
            ts = self._fused[1]
        if ts is None:
            self._ensure_states()
            ts = TrainStep(net, loss_fn, self._optimizer,
                           n_model_inputs=n_model_inputs, amp=policy)
            self._fused = (sig, ts)
        by_var = {id(p): name for _, name, p in ts._train}
        names = [by_var.get(id(p._var)) for p in self._params]
        self._seed(ts, names)
        skipped = ts.amp_skipped_steps if ts.amp_state is not None else 0
        counts = self._optimizer._index_update_count
        applied = max(max(counts.values(), default=0),
                      self._optimizer.num_update - self._amp_compiled_skips)
        ts.step_count.fill_(applied)
        before = self._optimizer.num_update
        try:
            losses = ts.run(data_iter, steps, window=window, accum=accum)
        finally:
            # the per-index counters advance by the steps APPLIED: a later
            # step() reads Adam's t from them, and a float16 skip holds t
            ran = self._optimizer.num_update - before
            if ts.amp_state is not None:
                new_skips = ts.amp_skipped_steps - skipped
                self._amp_compiled_skips += new_skips
                ran -= new_skips
            for i in range(len(self._params)):
                counts[i] = counts.get(i, 0) + ran
            for i, name in enumerate(names):
                if name is None:
                    continue
                st = ts.opt_state[name]
                master = ts._master.get(name)
                self._states[i] = st if master is None else \
                    {"master": master, "base": st}
                self._states_created[i] = True
        self._check_preemption()
        return losses

    def _seed(self, ts, names):
        """Write this trainer's states into the step's own tensors (a
        state that already is the step's tensor stays as it is), which
        become this trainer's states at once: the old ones are freed
        before the run."""
        with torch.no_grad():
            for i, name in enumerate(names):
                if name is None or not self._states_created[i] or \
                        self._states[i] is None:
                    continue
                st = self._states[i]
                if isinstance(st, dict) and "master" in st:
                    master = ts._master.get(name)
                    if master is not None:
                        if master is not st["master"]:
                            master.copy_(st["master"])
                        # the master is current: the step must not cast it
                        # again from the parameter the imperative update
                        # wrote
                        ts._stamps[name] = ts._stamp(self._params[i]._var)
                    st = st["base"]
                dst = ts.opt_state[name]
                for d, s in zip(_leaves(dst), _leaves(st)):
                    if d is not s:
                        d.copy_(s)
                master = ts._master.get(name)
                self._states[i] = dst if master is None else \
                    {"master": master, "base": dst}

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
            dev = p.tensor().device
            states[i] = _tree_map(
                lambda a: torch.from_numpy(np.array(a)).to(dev), states[i])
        self._states = states
        self._states_created = [True] * len(states)
        self._optimizer.num_update = blob["num_update"]
        self._optimizer._index_update_count = dict(
            blob["index_update_count"])

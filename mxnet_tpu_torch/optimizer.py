"""Optimizer registry: SGD, NAG, Adam, AdamW, AdaGrad, RMSProp, FTRL,
SignSGD and LAMB, and the KVStore-style ``Updater``.

Counterpart of ``mxnet_tpu/optimizer.py``: the
hyperparameters, the ``lr_scheduler``, the ``lr_mult``/``wd_mult`` dicts,
``create_state`` and the pure-state update ``update_raw`` that
``TrainStep`` drives, and the imperative protocol of ``gluon.Trainer``
(``update``, ``update_multi``, per-index update counts) with
``multi_precision``: a bf16/f16 weight is updated through an f32 master
kept in its state as ``{"master": f32, "base": state}``, the JAX layout.
A row-sparse gradient takes the lazy update: only its rows of the weight
and the states are read and written.
Updates run in place on the weight and state tensors (see
``ops/optimizer.py``). :meth:`Optimizer.update_raw_multi` applies one
update to a list of parameters; Adam's runs as one multi-tensor kernel
launch on the card when the ``fused_adam`` knob is on, and under
``multi_precision`` that launch updates the masters and writes the new
bf16/f16 weights into the parameters' own storage (the kernel's
low-precision output). The JAX package has no kernel for the others,
and neither has the port: their ``update_raw_multi`` loops the plain
update (``ops/optimizer.py``, ``ops/optimizer_ops.py``), each in place on
the f32 weight and states, so each runs inside ``TrainStep``'s graphs.
LAMB's per-tensor norms stay on the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import config as _config
from .ops import optimizer as _oo
from .ops import optimizer_ops as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "RMSProp",
           "FTRL", "SignSGD", "LAMB", "Updater", "get_updater", "create",
           "register"]

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


def _state_tensors(state):
    if state is None:
        return []
    return list(state) if isinstance(state, (tuple, list)) else [state]


_LOW = (torch.bfloat16, torch.float16)


def _is_row_sparse(x):
    return getattr(x, "stype", "default") == "row_sparse"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [] if tree is None else [tree]


class Optimizer:
    """Hyperparameters, the pure-state protocol and the imperative one.
    With ``lr_scheduler`` the rate is ``lr_scheduler(num_update)`` and
    ``learning_rate`` becomes its ``base_lr``. ``multi_precision`` gives a
    bf16/f16 weight an f32 master in the imperative protocol (``TrainStep``
    keeps f32 masters itself and ignores it)."""

    def __init__(self, learning_rate=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=None, param_dict=None, lr_scheduler=None,
                 multi_precision=False):
        self.multi_precision = multi_precision
        self.lr = learning_rate
        self.wd = wd
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient if clip_gradient is not None \
            else -1.0
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
        #: host mirror of the number of steps taken (TrainStep advances it)
        self.num_update = 0
        self._index_update_count: Dict[int, int] = {}
        self.lr_mult: Dict = {}
        self.wd_mult: Dict = {}
        self.param_dict = param_dict or {}
        self.idx2name: Dict[int, str] = {}
        # (device, values) -> the device tensor last sent for them
        self._sent = {}

    def set_learning_rate(self, lr):
        self.lr = lr
        if self.lr_scheduler is not None:
            self.lr_scheduler.base_lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler(self.num_update))
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def create_state(self, index, weight):
        """The per-parameter state (tensors on the weight's device)."""
        raise NotImplementedError

    # -- the imperative protocol (gluon.Trainer) ------------------------------
    def _update_count(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        self.num_update = max(self.num_update,
                              self._index_update_count[index])

    def _get_lr(self, index):
        lr = self.learning_rate
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            lr *= getattr(self.param_dict[name], "lr_mult", 1.0)
        return lr * self.lr_mult.get(name, self.lr_mult.get(index, 1.0))

    def _get_wd(self, index):
        wd = self.wd
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            wd *= getattr(self.param_dict[name], "wd_mult", 1.0)
        return wd * self.wd_mult.get(name, self.wd_mult.get(index, 1.0))

    def _send(self, values, dtype, device):
        """``values`` as a device tensor of ``dtype``. To the card it goes
        from pinned memory without waiting (a copy from pageable memory
        would wait for the stream); the last few are kept and reused."""
        key = (device, dtype, tuple(values))
        t = self._sent.get(key)
        if t is None:
            host = torch.from_numpy(np.asarray(values, dtype=dtype))
            if device.type == "cuda":
                t = host.pin_memory().to(device, non_blocking=True)
            else:
                t = host.to(device)
            if len(self._sent) >= 16:
                self._sent.clear()
            self._sent[key] = t
        return t

    def _needs_master(self, weight):
        t = weight._data if hasattr(weight, "_data") else weight
        return bool(self.multi_precision) and t.dtype in _LOW

    def create_state_multi_precision(self, index, weight, master=None):
        """``create_state``, or, when ``multi_precision`` is set and the
        weight is bf16/f16, ``{"master": f32, "base": create_state(master)}``
        with the master from ``master`` (the f32 values the weight was cast
        from) or else from the weight."""
        t = weight._data if hasattr(weight, "_data") else weight
        t = t.detach()
        if not self._needs_master(t):
            return self.create_state(index, t)
        if master is None:
            master = t.float()
        return {"master": master, "base": self.create_state(index, master)}

    def update_tensors(self, indices, weights, grads, states):
        """The imperative update of parameters ``indices`` (tensors, in
        place): each index's count advances; the rates, multipliers and
        Adam's t are the per-index ones, as in the JAX ``update_multi``.
        A bf16/f16 weight with a multi-precision state is updated through
        its master, its new value written into its own storage. Returns
        the states (the same objects, updated)."""
        for i in indices:
            self._update_count(i)
        groups = {}
        for k, i in enumerate(indices):
            groups.setdefault(self._index_update_count[i], []).append(k)
        out = list(states)
        with torch.no_grad():
            for t, members in groups.items():
                for master in (False, True):
                    sel = [k for k in members
                           if isinstance(states[k], dict) == master]
                    if sel:
                        self._update_group(
                            [indices[k] for k in sel],
                            [weights[k] for k in sel],
                            [grads[k] for k in sel],
                            [states[k] for k in sel], t, master)
        return out

    def _update_group(self, indices, ws, gs, sts, t, master):
        dev = ws[0].device
        lr = self._send([self._get_lr(i) for i in indices], np.float32, dev)
        wd = self._send([self._get_wd(i) for i in indices], np.float32, dev)
        step = self._send([t], np.int32, dev)[0]
        if master:
            self.update_raw_multi([s["master"] for s in sts], gs,
                                  [s["base"] for s in sts], lr, wd, step,
                                  out_lows=ws)
        else:
            self.update_raw_multi(ws, gs, sts, lr, wd, step)

    def update(self, index, weight, grad, state):
        """One parameter (NDArrays or tensors), in place; returns its
        state. A RowSparseNDArray gradient takes the lazy update
        (:meth:`_update_lazy`)."""
        if _is_row_sparse(grad):
            self._update_count(index)
            return self._update_lazy(index, weight, grad, state)
        return self.update_multi([index], [weight], [grad], [state])[0]

    def _update_lazy(self, index, weight, grad, state):
        """MXNet's ``lazy_update`` for a row-sparse gradient: the
        gradient's rows of the weight and of every state leaf with the
        weight's rows (of the f32 master too) are gathered into compact
        blocks, updated by one :meth:`update_raw_multi` call (Adam's
        launches its kernel on the card), and written back. Rows the
        gradient does not hold see no weight decay and no state decay."""
        w = (weight._data if hasattr(weight, "_data") else weight).detach()
        rows = grad._aux[0].long()
        n = w.shape[0]

        def gather(x):
            if torch.is_tensor(x) and x.dim() >= 1 and x.shape[0] == n:
                return x.index_select(0, rows)
            return x

        master = isinstance(state, dict) and "master" in state
        base = state["base"] if master else state
        sub = _tree_map(gather, base)
        t = self._index_update_count[index]
        with torch.no_grad():
            if master:
                blk, low = gather(state["master"]), gather(w)
                self._update_group([index], [low], [grad._data],
                                   [{"master": blk, "base": sub}], t, True)
                state["master"].index_copy_(0, rows, blk)
                w.index_copy_(0, rows, low)
            else:
                blk = gather(w)
                self._update_group([index], [blk], [grad._data], [sub], t,
                                   False)
                w.index_copy_(0, rows, blk)
            for full, part in zip(_tree_leaves(base), _tree_leaves(sub)):
                if part is not full:
                    full.index_copy_(0, rows, part)
        return state

    def update_multi(self, indices, weights, grads, states):
        """Parameters ``indices`` at once (NDArrays or tensors), in place;
        returns their states."""
        raw = [x._data if hasattr(x, "_data") else x for x in weights]
        graw = [x._data if hasattr(x, "_data") else x for x in grads]
        return self.update_tensors(list(indices), [w.detach() for w in raw],
                                   graw, list(states))

    def update_multi_precision(self, index, weight, grad, state):
        """:meth:`update` through the f32 master when the weight is
        bf16/f16 under ``multi_precision`` (a plain-layout state is adopted
        as the base, the master taken from the weight)."""
        w = weight._data if hasattr(weight, "_data") else weight
        if self._needs_master(w) and not isinstance(state, dict):
            state = {"master": w.detach().float(), "base": state}
        return self.update(index, weight, grad, state)

    def update_raw(self, w, g, state, lr, wd, t):
        """One parameter, in place: ``(w, g, state, lr, wd, step)`` ->
        ``(w, state)``. ``lr``, ``wd`` and ``t`` may be device tensors, so
        a schedule never syncs the host."""
        raise NotImplementedError

    def update_raw_multi(self, ws, gs, states, lr, wd, t, out_lows=None,
                         inv_scale=None, skip=None):
        """One update of every parameter in the lists; ``lr`` and ``wd`` are
        (N,) f32 tensors (the rates times each parameter's multiplier).
        ``out_lows`` (None, or per parameter None or a low-precision tensor)
        receive the new weights. ``inv_scale`` (a 0-d f32 tensor) multiplies
        each gradient first; ``skip`` (a 0-d tensor), when nonzero, leaves
        weights, states and copies as they were, as the JAX step's
        ``lax.cond``. Here, for optimizers whose update takes no skip flag:
        the plain update parameter by parameter, each weight and state put
        back where ``skip`` is set."""
        for i, (w, g, s) in enumerate(zip(ws, gs, states)):
            if inv_scale is not None:
                g = g.float() * inv_scale
            if skip is None:
                self.update_raw(w, g, s, lr[i], wd[i], t)
            else:
                held = [w] + _state_tensors(s)
                before = [x.clone() for x in held]
                self.update_raw(w, g, s, lr[i], wd[i], t)
                keep = skip.bool()
                for x, old in zip(held, before):
                    x.copy_(torch.where(keep, old, x))
            if out_lows is not None and out_lows[i] is not None:
                out_lows[i].copy_(w)


@register
class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is nonzero."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight, dtype=torch.float32)

    def update_raw(self, w, g, state, lr, wd, t):
        if self.momentum == 0.0:
            _oo.sgd_update(w, g, lr, wd, self.rescale_grad, self.clip_gradient)
            return w, None
        _oo.sgd_mom_update(w, g, state, lr, self.momentum, wd,
                           self.rescale_grad, self.clip_gradient)
        return w, state


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    def update_raw(self, w, g, state, lr, wd, t):
        if self.momentum == 0.0:
            _oo.sgd_update(w, g, lr, wd, self.rescale_grad, self.clip_gradient)
            return w, None
        _oo.nag_mom_update(w, g, state, lr, self.momentum, wd,
                           self.rescale_grad, self.clip_gradient)
        return w, state


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

    def update_raw_multi(self, ws, gs, states, lr, wd, t, out_lows=None,
                         inv_scale=None, skip=None):
        """All parameters at once: one kernel launch on the card when the
        ``fused_adam`` knob is on, else the plain version per parameter
        (which applies ``inv_scale`` and ``skip`` itself)."""
        update = _oo.adam_update_fused if _config.get("fused_adam") \
            else _oo.adam_update_multi
        update(ws, gs, [s[0] for s in states], [s[1] for s in states],
               self._lr_t(lr, t), wd, out_lows=out_lows, inv_scale=inv_scale,
               skip=skip, **self._hyper())


@register
class AdamW(Adam):
    """Adam with decoupled weight decay, applied after the Adam step (so it
    cannot ride the coupled-wd kernel: the plain update per parameter)."""

    def update_raw(self, w, g, state, lr, wd, t):
        mean, var = state
        h = self._hyper()
        w_old = w.clone()
        _oo.adam_update(w, g, mean, var, self._lr_t(lr, t), h["beta1"],
                        h["beta2"], h["epsilon"], 0.0, h["rescale_grad"],
                        h["clip_gradient"])
        w.copy_(w - lr * wd * w_old)
        return w, (mean, var)

    update_raw_multi = Optimizer.update_raw_multi


def _zeros(weight, n=1):
    z = [torch.zeros_like(weight, dtype=torch.float32) for _ in range(n)]
    return z[0] if n == 1 else tuple(z)


@register
class AdaGrad(Optimizer):
    """AdaGrad: each weight's step divided by the root of its summed
    squared gradients."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update_raw(self, w, g, state, lr, wd, t):
        _ops.adagrad_update(w, g, state, lr, self.float_stable_eps, wd,
                            self.rescale_grad, self.clip_gradient)
        return w, state


@register
class RMSProp(Optimizer):
    """RMSProp; with ``centered`` Graves' variant (``rmspropalex_update``:
    the first moment subtracted, and a momentum ``gamma2`` on the step),
    as MXNet's. The JAX optimizer ignores ``centered``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights if clip_weights is not None else -1.0

    def create_state(self, index, weight):
        return _zeros(weight, 3) if self.centered else _zeros(weight)

    def update_raw(self, w, g, state, lr, wd, t):
        if self.centered:
            n, gm, delta = state
            _ops.rmspropalex_update(w, g, n, gm, delta, lr, self.gamma1,
                                    self.gamma2, self.epsilon, wd,
                                    self.rescale_grad, self.clip_gradient,
                                    self.clip_weights)
        else:
            _ops.rmsprop_update(w, g, state, lr, self.gamma1, self.epsilon,
                                wd, self.rescale_grad, self.clip_gradient,
                                self.clip_weights)
        return w, state


@register
class FTRL(Optimizer):
    """FTRL-proximal with L1 strength ``lamda1``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update_raw(self, w, g, state, lr, wd, t):
        z, n = state
        _ops.ftrl_update(w, g, z, n, lr, self.lamda1, self.beta, wd,
                         self.rescale_grad, self.clip_gradient)
        return w, state


@register
class SignSGD(Optimizer):
    """SGD on the sign of the gradient."""

    def create_state(self, index, weight):
        return None

    def update_raw(self, w, g, state, lr, wd, t):
        _ops.signsgd_update(w, g, lr, wd, self.rescale_grad,
                            self.clip_gradient)
        return w, None


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments (the BERT pretraining optimizer): Adam's
    bias-corrected step plus ``wd·w``, scaled per tensor by the trust ratio
    ``‖w‖ / ‖step‖`` (``lamb_update_phase1``, the norms, ``phase2``). The
    norms are 0-d device tensors, so a step reads nothing on the host."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else -1.0
        self.upper_bound = upper_bound if upper_bound is not None else -1.0
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def update_raw(self, w, g, state, lr, wd, t):
        mean, var = state
        tf = torch.as_tensor(t, device=w.device).to(torch.float32)
        upd = _ops.lamb_update_phase1(w, g, mean, var, self.beta1, self.beta2,
                                      self.epsilon, tf, self.bias_correction,
                                      wd, self.rescale_grad,
                                      self.clip_gradient)
        r1, r2 = _ops.lamb_norms(w, upd)
        _ops.lamb_update_phase2(w, upd, r1, r2, lr, self.lower_bound,
                                self.upper_bound)
        return w, state


class Updater:
    """The KVStore-side updater (MXNet's ``get_updater``): ``updater(index,
    grad, weight)`` makes the index's state on first use (with an f32
    master for a bf16/f16 weight under ``multi_precision``) and updates
    ``weight`` in place."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
        self.states[index] = self.optimizer.update_multi_precision(
            index, weight, grad, self.states[index])

    def get_states(self, dump_optimizer=False):
        """The states (and with ``dump_optimizer`` the optimizer) pickled."""
        import pickle

        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)

    def set_states(self, states):
        """Restore what :meth:`get_states` gave (bytes this program wrote:
        unpickling runs code)."""
        import pickle

        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj


def get_updater(optimizer):
    return Updater(optimizer)

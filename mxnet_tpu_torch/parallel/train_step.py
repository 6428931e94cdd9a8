"""The single-device training step and training loop.

Counterpart of the ``mesh=None`` subset of ``mxnet_tpu/parallel/train_step.py``:
one call is forward, backward and the optimizer update of every trainable
parameter. Where the JAX step is one compiled program with donated
buffers, cached per signature (``_compiled``), this one is one captured
CUDA graph per signature (``ops/cuda_graph.py``; with
``engine_type="naive"``, and on the CPU, the same step function runs
eagerly at every call over the same static buffers), and it updates the
module's parameters and the optimizer state in place. The signature is
the batch's shapes and dtypes, the AMP policy, whether telemetry is on
(it adds the gradient norm to the program, as JAX's ``with_gnorm``), the
optimizer's scalar hyperparameters and the storage of every parameter,
moment, master and low-precision copy: a parameter given new storage
(``p.data = ...``) drops the graph, and the next calls capture anew
(counted in ``recaptures``). Each call copies the batch (and the
per-parameter rates, when they changed) into static buffers before the
replay, and returns a copy of the graph's loss. The step count lives on the card and the
bias-corrected learning rate is computed there from it, so a step issues
its work without waiting for the card: the returned loss is a 0-d device
tensor, and reading it is the caller's sync.

:meth:`TrainStep.run` is the JAX ``run``: ``window`` steps at a time
through one program, the port's counterpart of the JAX window's
``lax.scan``: one captured CUDA graph a window signature (``window``,
``accum``, the stacked batch's shapes and dtypes, and the step's
signature) that runs the step body ``window`` times over the rows of
one static ``[window, accum, B, ...]`` buffer per batch entry (filled by
one copy a window) and of a static ``[2, window, N]`` rate buffer,
and writes a ``[window]`` loss buffer. The host computes the rates from
``lr_scheduler(num_update + i)`` and sends them in one pinned copy (the
JAX ``lrs`` vector), so a window computes what ``window`` calls would, in the same
kernel order: its losses, weights, moments, step count and loss-scale
carry are bit-identical to those of ``window`` calls. With ``accum > 1``
each step takes ``accum`` microbatches: their gradients are upcast to f32
and summed in order from zeros, then the loss sum and the gradient sum
are divided by ``accum`` (the JAX ``_grads_of``), before one finiteness
check (float16) and one optimizer update.

Mixed precision (``amp=``) keeps the JAX semantics: the f32 parameters and
f32 model inputs are cast to the compute dtype inside the differentiated
function, the gradients reach the f32 masters, and the optimizer updates
the masters in f32; ``net`` keeps holding the masters. Eagerly, the step
keeps a persistent low-precision copy of each f32 parameter and runs the
forward through ``torch.func.functional_call`` with the copies as the
gradient leaves. A copy's gradient is exactly the JAX cotangent of the
cast before its upcast, so it goes to the optimizer as it is, and Adam's
kernel writes the next step's copy in the same pass as the update (its
low-precision output), which equals ``new_w.to(dtype)`` bit for bit: no
separate cast pass. Frozen parameters are cast once. A layer's state
(``Parameter.is_state``: BatchNorm's moving statistics) gets no copy: the
forward reads it in f32, and the layer writes its update in place into
that f32 tensor (``gluon.block.record_state_update``) at every forward:
once a step, eager or in a replay, each step of a window, each
microbatch of an accumulated step. The JAX step updates no state: its
``_loss_of`` drops the state tape. A trainable bfloat16
or float16 parameter (a ``net.cast("bfloat16")`` net) is trained through
an f32 master the step keeps, whose update writes the parameter in the
same pass (the ``multi_precision`` route of ``gluon.Trainer``). A master
or copy whose parameter changed outside the step (``load_mxnet_params``,
``load_state_dict``, an in-place write under ``no_grad``, or ``p.data =
...``) is cast again before the next forward: the step keeps each
parameter's storage and version counter as of the last write it knows of.
Writes through ``p.data`` bypass the version counter; call
:meth:`TrainStep.refresh_copies` after them. Under float16 the dynamic
loss scale, the good-step run and the skip count live on the card: an
overflowed step leaves weights, moments, copies and Adam's t as they
were, halves the scale (not below 1) and counts the skip, with no host
sync.

:meth:`TrainStep.save` / :meth:`TrainStep.restore` write and read the JAX
package's checkpoint (``checkpoint.py``); ``restore`` writes into the
existing storage, so captured graphs stay valid. ``install_preemption``
and ``attach_monitor`` act at every step and window boundary.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import time
import weakref
from typing import Optional

import numpy as np
import torch

from .. import config as _config
from .. import observability as _obs
from ..base import MXNetError
from ..contrib import amp as _amp
from ..observability import profiling as _profiling
from ..ops import cuda_graph as _cg

__all__ = ["TrainStep"]

_LOW = (torch.bfloat16, torch.float16)
# the optimizer's scalar hyperparameters a captured update reads
_HYPER = ("rescale_grad", "clip_gradient", "beta1", "beta2", "epsilon",
          "momentum", "float_stable_eps", "gamma1", "gamma2", "centered",
          "clip_weights", "lamda1", "beta", "lower_bound", "upper_bound",
          "bias_correction")


class TrainStep:
    """Forward, backward and update of ``net`` on its own device.

    Parameters
    ----------
    net : torch.nn.Module (a Gluon ``Block`` is one) whose parameters are
        named as the JAX package's (``word_embed.weight``, ...); it stays on
        its device. A Block's deferred shapes must be resolved (one
        forward) before the step is built.
    loss_fn : callable(out, *labels) -> loss tensor (a gluon loss block or
        a function); its f32 mean is the training loss.
    optimizer : an ``mxnet_tpu_torch.optimizer.Optimizer``.
    n_model_inputs : how many leading batch entries go to ``net``.
    amp : ``"auto"`` (default) follows ``contrib.amp.init``; ``"bfloat16"``,
        ``"float16"`` or a ``contrib.amp.Policy`` force one; ``None`` trains
        in the parameters' dtype.
    mesh, layout : not ported yet; anything but None raises.
    engine_type : "graph" (one captured CUDA graph per step signature) or
        "naive" (the eager step); None reads the ``engine_type`` knob.

    Parameters with ``requires_grad=False`` are frozen (the JAX
    ``grad_req='null'``). Per-parameter ``lr_mult``/``wd_mult`` resolve as
    in the JAX step: the ``optimizer.param_dict`` entry, else the parameter's
    own attribute, times the optimizer's name-keyed dicts.
    """

    def __init__(self, net, loss_fn, optimizer, mesh=None,
                 n_model_inputs: int = 1, amp="auto", layout=None,
                 engine_type=None):
        if mesh is not None or layout is not None:
            raise MXNetError("TrainStep(mesh=/layout=) is not ported yet: the "
                             "port's TrainStep runs on one device")
        self.engine_type = _config.resolve("engine_type", engine_type)
        self.amp_policy = _amp.resolve_policy(amp)
        self.net = net
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.n_model_inputs = n_model_inputs
        collect = getattr(net, "collect_params", None)
        if collect is not None:
            pending = [p.name for p in collect().values() if p._var is None]
            if pending:
                raise MXNetError(f"TrainStep: parameters {pending[:3]} have "
                                 "deferred shapes; run one forward first")
        self._plist = sorted(net.named_parameters())
        if not self._plist:
            raise MXNetError("TrainStep: the net has no parameters")
        self.device = self._plist[0][1].device
        self._swap_names = self._swap_locations(net, self._plist)
        self._capture = self.engine_type == "graph" and \
            self.device.type == "cuda"
        self._stream = _cg.capture_stream(self, self.device) \
            if self._capture else None
        self._train = [(i, name, p) for i, (name, p) in enumerate(self._plist)
                       if p.requires_grad]
        # name -> the f32 master of a bf16/f16 trainable parameter
        self._master = {name: p.detach().float() for _, name, p in self._train
                        if p.dtype in _LOW}
        self.opt_state = {name: optimizer.create_state(
                              i, self._master.get(name, p.detach()))
                          for i, name, p in self._train}
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        # name -> the low-precision copy of an f32 parameter (AMP only)
        self._low = {}
        # name -> its parameter's (storage, version) when the step last
        # wrote the parameter's copy or master
        self._stamps = {name: self._stamp(p) for _, name, p in self._train
                        if name in self._master}
        self.amp_state = None
        pol = self.amp_policy
        if pol is not None:
            states = self._state_vars(net)
            for name, p in self._plist:
                if p.dtype == torch.float32 and id(p) not in states:
                    low = p.detach().to(pol.torch_compute_dtype)
                    self._low[name] = low.requires_grad_(p.requires_grad)
                    self._stamps[name] = self._stamp(p)
            if pol.dynamic_scaling:
                dev = self.device
                self.amp_state = {
                    "scale": torch.tensor(pol.loss_scale, dtype=torch.float32,
                                          device=dev),
                    "good": torch.zeros((), dtype=torch.int32, device=dev),
                    "skipped": torch.zeros((), dtype=torch.int32, device=dev)}
        self._amp_skipped_seen = 0  # host mirror for the telemetry counter
        self._ckpt_names = self._checkpoint_names(net)
        # program key -> (program, static inputs, storage it was captured
        # over); step keys start with "step", window keys with "window"
        self._programs = {}
        #: the open step capture's token (observability.profiling)
        self._ptok = None
        #: programs dropped because a parameter, moment or copy moved
        self.recaptures = 0
        #: window programs dispatched (one host sync each with telemetry on)
        self._window_dispatches = 0
        self._signatures = {}  # family -> batch signatures seen (telemetry)
        self._monitors = []
        self._prefetcher = None
        # graceful preemption: set by install_preemption
        self._preempt_guard = None
        self._preempt_dir = None
        self._preempt_exit = True
        self._preempt_saved = False

    @staticmethod
    def _swap_locations(net, plist):
        """Parameter name -> the names under which the AMP forward swaps in
        its copy: one for each (module, attribute) that holds the tensor.
        A submodule registered under two names (a tied embedding:
        ``tgt_embed is src_embed``) is one location, swapped once: with
        ``tie_weights=True``, ``functional_call`` swaps it under both names
        and its restore then leaves the copy in the module."""
        owner = {id(p): name for name, p in plist}
        out = {name: [] for name, _ in plist}
        seen = set()
        for full, p in net.named_parameters(remove_duplicate=False):
            path, _, attr = full.rpartition(".")
            key = (id(net.get_submodule(path)), attr)
            if key not in seen and id(p) in owner:
                seen.add(key)
                out[owner[id(p)]].append(full)
        return out

    @staticmethod
    def _state_vars(net):
        """The ids of the variables of a Block's state parameters."""
        collect = getattr(net, "collect_params", None)
        if collect is None:
            return set()
        return {id(p._var) for p in collect().values() if p.is_state}

    @staticmethod
    def _stamp(p):
        return p.data_ptr(), p._version

    def _checkpoint_names(self, net):
        """Structural name -> the name a checkpoint keys the parameter by:
        its Gluon ``Parameter.name`` for a Block (the JAX step's keys), its
        structural name for a plain module."""
        names = {name: name for name, _ in self._plist}
        collect = getattr(net, "collect_params", None)
        if collect is not None:
            by_var = {id(p._var): p.name for p in collect().values()}
            names = {name: by_var.get(id(p), name)
                     for name, p in self._plist}
            if len(set(names.values())) != len(names):
                raise MXNetError("TrainStep: two parameters share a Gluon "
                                 "name")
        return names

    def _refresh_copies(self, force=False):
        """Cast again each copy or master whose parameter changed since the
        step last wrote it (every one with ``force``)."""
        with torch.no_grad():
            for name, p in self._plist:
                dst = self._low.get(name)
                if dst is None:
                    dst = self._master.get(name)
                if dst is None:
                    continue
                stamp = self._stamp(p)
                if force or stamp != self._stamps[name]:
                    dst.copy_(p.detach())
                    self._stamps[name] = stamp

    def refresh_copies(self):
        """Cast every low-precision copy and master from its parameter
        again. Needed only after writing parameters through ``p.data``,
        which the step cannot see; other changes it picks up by itself."""
        self._refresh_copies(force=True)

    def _resolve_mults(self):
        """Per-name lr/wd multipliers, as ``_resolve_mults`` of the JAX step."""
        opt = self.optimizer
        lr_mult, wd_mult = {}, {}
        for _, name, p in self._train:
            src = opt.param_dict.get(name, p)
            lr_mult[name] = float(getattr(src, "lr_mult", 1.0)) * \
                float(opt.lr_mult.get(name, 1.0))
            wd_mult[name] = float(getattr(src, "wd_mult", 1.0)) * \
                float(opt.wd_mult.get(name, 1.0))
        return lr_mult, wd_mult

    def _to_device(self, array):
        """A host f32 array on the net's device. To the card it goes from
        pinned memory without waiting: a copy from pageable memory would
        wait for the stream, a host sync at every scheduled rate."""
        t = torch.from_numpy(np.ascontiguousarray(array, np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _rates(self, steps):
        """The ``[2, steps, N]`` f32 rates of the next ``steps`` steps, on
        the host: lr·lr_mult and wd·wd_mult, each product taken in f32 as
        the JAX step takes it, step ``i`` at the scheduler's rate for
        ``num_update + i`` (what ``i`` sequential calls read)."""
        lr_mult, wd_mult = self._resolve_mults()
        names = [name for _, name, _ in self._train]
        lm = np.asarray([lr_mult[n] for n in names], np.float32)
        wm = np.asarray([wd_mult[n] for n in names], np.float32)
        opt = self.optimizer
        sched = getattr(opt, "lr_scheduler", None)
        lrs = [float(sched(opt.num_update + i)) if sched is not None
               else opt.learning_rate for i in range(steps)]
        out = np.empty((2, steps, len(names)), np.float32)
        for i, lr in enumerate(lrs):
            out[0, i] = np.float32(lr) * lm
            out[1, i] = np.float32(opt.wd) * wm
        return out

    def _hyper_key(self):
        return tuple(getattr(self.optimizer, k, None) for k in _HYPER)

    def _forward_loss(self, batch):
        """The f32 mean loss (times the loss scale under float16) and the
        gradient leaves: the parameters, or their low-precision copies."""
        n = self.n_model_inputs
        if self.amp_policy is None:
            out = self.net(*batch[:n])
            leaves = [p for _, _, p in self._train]
        else:
            cd = self.amp_policy.torch_compute_dtype
            inputs = tuple(b.to(cd) if b.dtype == torch.float32 else b
                           for b in batch[:n])
            params = {name: self._low.get(name, p) for name, p in self._plist}
            swap = {alias: params[name] for name in params
                    for alias in self._swap_names[name]}
            out = torch.func.functional_call(self.net, swap, inputs,
                                             tie_weights=False)
            leaves = [params[name] for _, name, _ in self._train]
        loss = self.loss_fn(out, *batch[n:]).float().mean()
        if self.amp_state is not None:
            loss = loss * self.amp_state["scale"]
        return loss, leaves

    def _loss_and_grads(self, batch):
        """The loss of one (micro)batch and the gradients of its leaves
        (zeros for a leaf the loss does not reach)."""
        was_training = self.net.training
        self.net.train()
        try:
            with torch.enable_grad():
                loss, leaves = self._forward_loss(batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            self.net.train(was_training)
        return loss, [torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads)]

    @staticmethod
    def _finite_all(grads):
        """One finiteness reduction over every gradient (the max-norm of
        each, one multi-tensor pass), kept on the card."""
        norms = torch._foreach_norm(grads, float("inf"))
        return torch.isfinite(torch.stack(norms)).all()

    @staticmethod
    def _grad_norm(grads, inv=None):
        """The global L2 norm of the (unscaled) gradients, in f32: the JAX
        step's telemetry ``gnorm``."""
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        out = torch.stack(norms).square().sum().sqrt()
        return out if inv is None else out * inv

    def _next_amp_state(self, finite):
        """The dynamic loss scale's transition, as the JAX step's: an
        overflow halves the scale (floor 1.0) and resets the good-step run;
        ``scale_window`` good steps in a row multiply it by the factor."""
        pol, a = self.amp_policy, self.amp_state
        good = torch.where(finite, a["good"] + 1, torch.zeros_like(a["good"]))
        grow = good >= pol.scale_window
        scale = a["scale"]
        a["scale"].copy_(torch.where(
            finite, torch.where(grow, scale * pol.scale_factor, scale),
            torch.clamp(scale / pol.scale_factor, min=1.0)))
        a["good"].copy_(torch.where(grow, torch.zeros_like(good), good))
        a["skipped"] += (~finite).to(torch.int32)

    # -- one step ----------------------------------------------------------
    def __call__(self, *batch):
        """Run one step. ``batch = (x, label, ...)`` as tensors (or
        NDArrays) on the net's device, or numpy arrays. Returns the loss as
        a 0-d f32 device tensor."""
        obs_on = _obs.enabled()
        t0 = time.perf_counter() if obs_on else 0.0
        batch = tuple(getattr(b, "_data", b) for b in batch)
        try:
            loss, gnorm = self._program_step(batch, obs_on)
            self._wrote_params()
            self.optimizer.num_update += 1
            if obs_on:
                self._record_step(t0 + _profiling.step_capture_begin_seconds(
                    self._ptok), batch, loss, gnorm)
        except BaseException:
            # a failed traced step must not leak the live trace session
            _profiling.step_capture_abort(self._ptok)
            self._ptok = None
            raise
        self._end_capture(loss)
        self._run_monitors()
        self._check_preemption()
        return loss

    def _wrote_params(self):
        """After an update: every copy and master is current."""
        for _, name, p in self._train:
            if name in self._stamps:
                self._stamps[name] = self._stamp(p)

    @property
    def compiled_programs(self) -> int:
        """Programs held now: one per step signature and one per window
        signature (under "graph", on the card, each is one captured CUDA
        graph), as the JAX step's ``_compiled``."""
        return len(self._programs)

    def _storage(self):
        """The storage a step graph is captured over: every parameter,
        moment, master and low-precision copy."""
        out = [p.data_ptr() for _, p in self._plist]
        for st in self.opt_state.values():
            out.extend(t.data_ptr() for t in
                       (st if isinstance(st, (tuple, list)) else (st,))
                       if t is not None)
        out.extend(low.data_ptr() for low in self._low.values())
        out.extend(m.data_ptr() for m in self._master.values())
        return tuple(out)

    def _program(self, key, kind, shapes, build):
        """The program of ``key``, built by ``build(shapes)`` when missing
        or captured over storage that moved since."""
        storage = self._storage()
        entry = self._programs.get(key)
        if entry is not None and entry[2] != storage:
            del self._programs[key]  # a parameter moved: capture again
            self.recaptures += 1
            entry = None
        if entry is None:
            if _obs.enabled():
                self._note_recompile(kind, shapes)
            entry = self._programs[key] = build(shapes) + (storage,)
        return entry

    def _program_step(self, batch, obs_on):
        """One step through the step graph of the batch's signature."""
        for b in batch:
            if torch.is_tensor(b) and b.device != self.device:
                raise MXNetError(f"batch tensor on {b.device}, the net on "
                                 f"{self.device}")
        # host arrays as CPU tensors, in the dtypes _as_batch would give
        host = [not torch.is_tensor(b) for b in batch]
        arrays = [torch.as_tensor(np.asarray(b)) if h else b
                  for b, h in zip(batch, host)]
        shapes = tuple((tuple(b.shape), b.dtype) for b in arrays)
        key = ("step", shapes, _cg.capture_state(), obs_on, self._hyper_key())
        prog, (static, rates, sent), _ = self._program(
            key, "step", shapes, lambda s: self._new_program(s, 1, 1, obs_on))
        for dst, b, h in zip(static, arrays, host):
            if h and self.device.type == "cuda":
                dst[0, 0].copy_(b.pin_memory(), non_blocking=True)
            else:
                dst[0, 0].copy_(b)
        self._fill(rates, sent)
        outs = self._probe(prog, int(self.optimizer.num_update) + 1)
        return outs[0][0].clone(), (outs[1][0].clone() if obs_on else None)

    def _probe(self, prog, step):
        """``prog()`` under the measured-profiling probe: a periodic or
        triggered step capture (``observability.profiling``) traces this
        call when its graph replays; a call that warms up or captures is
        never traced. One global read and one call while disarmed. The
        session's opening (on the card a sync and ``QUIET_S``) is taken
        out of the step's recorded time, and the capture closes in
        :meth:`_end_capture`, after the step is recorded, so neither the
        opening nor the parse and retention inflate the step's own
        telemetry."""
        self._ptok = _profiling.step_capture_begin(
            step, replay=prog.replays_next, device=self.device)
        return prog()

    def _end_capture(self, outputs):
        ptok, self._ptok = self._ptok, None
        if ptok is not None:
            _profiling.step_capture_end(ptok, outputs)

    def _fill(self, rates, sent):
        """Before a program: copies and masters current, and the rates in
        its static buffer (sent only when they changed since the program's
        last call: ``sent`` holds the bytes last sent)."""
        if self._low or self._master:
            self._refresh_copies()
        host = self._rates(rates.shape[1])
        if sent[0] != host.tobytes():
            rates.copy_(self._to_device(host))
            sent[0] = host.tobytes()

    def _new_program(self, shapes, window, accum, gnorm):
        """A program of ``window`` steps of ``accum`` microbatches of the
        batch signature ``shapes`` over new static buffers: one
        ``[window, accum, ...]`` tensor per batch entry (step ``i``'s
        microbatch ``j`` is its view ``[i, j]``) and the ``[2, window, N]``
        rates (with the bytes last sent into them)."""
        dev = self.device
        static = tuple(torch.zeros((window, accum) + tuple(shape), dtype=dt,
                                   device=dev) for shape, dt in shapes)
        rates = torch.zeros((2, window, len(self._train)),
                            dtype=torch.float32, device=dev)
        # the program holds its owner weakly: a cycle through it would keep
        # the graph's memory pool alive after the TrainStep is dropped
        owner = weakref.ref(self)
        sig = ("train_step" if window == 1 and accum == 1 else
               ("train_window", window, accum), shapes, self.amp_policy)
        prog = _cg.StepGraph(
            lambda: owner()._steps(static, rates, gnorm), sig, dev,
            stream=self._stream, capture=self._capture)
        return prog, (static, rates, [None])

    def _steps(self, static, rates, gnorm):
        """The program body: one step per row of the static buffers (its
        microbatches), at the rates' rows. Returns the ``[steps]`` losses
        (and gradient norms)."""
        window, accum = static[0].shape[:2]
        outs = [self._step([tuple(b[i, j] for b in static)
                            for j in range(accum)],
                           rates[0, i], rates[1, i], gnorm)
                for i in range(window)]
        losses = torch.stack([loss for loss, _ in outs])
        if not gnorm:
            return (losses,)
        return losses, torch.stack([g for _, g in outs])

    def _step(self, micros, lr, wd, gnorm=False):
        """Forward, backward and update over the device microbatches
        ``micros`` at the (N,) rates ``lr`` and ``wd``. Returns the detached
        loss and (``gnorm``) the gradient norm."""
        loss, grads = self._loss_and_grads(micros[0])
        if len(micros) > 1:
            # the JAX _grads_of: f32 sums from zeros in microbatch order,
            # then the means
            acc = [torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                   for g in grads]
            torch._foreach_add_(acc, [g.float() for g in grads])
            for mb in micros[1:]:
                lj, gj = self._loss_and_grads(mb)
                loss = loss + lj
                torch._foreach_add_(acc, [g.float() for g in gj])
            loss = loss / len(micros)
            torch._foreach_div_(acc, float(len(micros)))
            grads = acc
        weights, lows = [], []
        for _, name, p in self._train:
            master = self._master.get(name)
            weights.append(p.detach() if master is None else master)
            lows.append(self._low.get(name) if master is None
                        else p.detach())
        if not any(x is not None for x in lows):
            lows = None
        with torch.no_grad():
            t2 = self.step_count + 1
            inv = skip = finite = None
            if self.amp_state is not None:
                inv = 1.0 / self.amp_state["scale"]
                finite = self._finite_all(grads)
                skip = (~finite).to(torch.int32)
                loss = loss * inv
            norm = self._grad_norm(grads, inv) if gnorm else None
            self.optimizer.update_raw_multi(
                weights, grads,
                [self.opt_state[name] for _, name, _ in self._train],
                lr, wd, t2, out_lows=lows, inv_scale=inv, skip=skip)
            if finite is None:
                self.step_count.copy_(t2)
            else:
                # Adam's t advances only on applied steps
                self.step_count.copy_(torch.where(finite, t2, self.step_count))
                self._next_amp_state(finite)
        return loss.detach(), norm

    # -- the training loop -------------------------------------------------
    def attach_prefetcher(self, prefetcher):
        """Note the ``io.prefetch.DevicePrefetcher`` feeding this step
        (called by the prefetcher itself): its batches arrive on the
        device."""
        self._prefetcher = prefetcher
        return prefetcher

    def run(self, data_iter, steps=None, window=None, accum=None):
        """Run ``steps`` training steps in windows of ``window``.

        Each full window is one program (see the module docstring): one
        captured CUDA graph a window signature, replayed once a window, so
        the fixed launch and host cost is paid once per window.
        ``data_iter`` is any iterable of batches (tuples of arrays,
        ``DataBatch``, a ``DataLoader``), or a
        :class:`~mxnet_tpu_torch.io.prefetch.DevicePrefetcher` (e.g. from
        ``loader.prefetch_to_device(train_step, window)``), used as built;
        plain iterables are wrapped in a prefetcher (a ``host_batches()``
        stream where the source has one), whose thread stacks the windows
        and copies them to the device.

        ``accum`` > 1 takes ``accum`` microbatches a step and applies the
        mean of their gradients once. A trailing partial window falls back
        to single steps (``accum == 1``) or a smaller window program
        (``accum > 1``; microbatches short of one group are dropped and
        counted in ``prefetch_dropped_batches_total``). Monitors and the
        preemption check run at window boundaries.

        Returns the per-step losses as one ``[steps_run]`` device tensor:
        reading it is the only host sync.
        """
        from ..io.prefetch import DevicePrefetcher

        own = not isinstance(data_iter, DevicePrefetcher)
        if own:
            window = 8 if window is None else window
            accum = 1 if accum is None else accum
            host_fn = getattr(data_iter, "host_batches", None)
            src = host_fn() if callable(host_fn) else data_iter
            if steps is not None:
                src = itertools.islice(iter(src), steps * accum)
            pf = DevicePrefetcher(src, train_step=self, window=window,
                                  accum=accum)
        else:
            pf = data_iter
            # the prefetcher already stacked its groups: a silently ignored
            # mismatch would train at another effective batch size
            if window is not None and window != pf.window:
                raise ValueError(f"window={window} but the prefetcher was "
                                 f"built with window={pf.window}")
            if accum is not None and accum != pf.accum:
                raise ValueError(f"accum={accum} but the prefetcher was "
                                 f"built with accum={pf.accum}")
            window, accum = pf.window, pf.accum
            if steps is not None and steps % window:
                raise ValueError(
                    f"steps={steps} not divisible by the prefetcher's "
                    f"window={window}")
            if pf.device != self.device:
                raise MXNetError(f"the prefetcher places batches on "
                                 f"{pf.device}, the net is on {self.device}")
        losses = []
        done = 0
        try:
            while steps is None or done < steps:
                kind, payload, n = pf.next_group()
                if kind is None:
                    break
                if kind == "window":
                    losses.append(self._run_window(payload, n, accum))
                else:
                    losses.append(self(*payload).reshape(1))
                done += n
        finally:
            if own:
                pf.close()
        if not losses:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return torch.cat(losses) if len(losses) > 1 else losses[0]

    def profile(self, *batch, steps: int = 2, warmup: int = 1,
                window: Optional[int] = None, accum: int = 1,
                trace_dir: Optional[str] = None, calibrate: bool = False,
                band: float = 3.0):
        """Trace ``steps`` real training steps of this batch signature
        (after ``warmup`` untraced ones) and return the
        :class:`~mxnet_tpu_torch.observability.profiling.Capture`: measured
        per-device op timeline, hot-op ranking and measured step time
        (each step's device window; ``prof_step.busy`` spans hold the
        card's busy time in it). The steps go through ``__call__`` /
        ``run``'s own step graphs, so the traced program IS the production
        program, and the profiled steps advance the training state like
        any other steps. A step graph warms up on its first call and
        captures on its second: untraced calls run past ``warmup`` until
        the step replays, so that only replays are traced. ``window=``
        profiles the ``window``-step program instead (one traced replay a
        window). On the card a timeline without kernel rows raises.

        ``calibrate=True`` needs the schedule auditor of ``analysis/*``
        (``TrainStep.audit``), which the port does not have yet: it raises
        ``NotImplementedError``."""
        if calibrate:
            raise NotImplementedError(
                "TrainStep.profile(calibrate=True) needs the schedule "
                "auditor of analysis/* (TrainStep.audit), which the port "
                "does not have yet")
        if window:
            lead = (window,) if accum == 1 else (window, accum)
            stacked = tuple(
                torch.as_tensor(np.asarray(b)) if not torch.is_tensor(b)
                else b for b in (getattr(b, "_data", b) for b in batch))
            stacked = tuple(b.to(self.device).expand(lead + tuple(b.shape))
                            for b in stacked)
            fn = lambda: self._run_window(stacked, window, accum)  # noqa: E731
        else:
            fn = lambda: self(*batch)  # noqa: E731
        return _profiling.capture(fn, steps=steps, warmup=warmup,
                                  trace_dir=trace_dir, device=self.device,
                                  replays_only=True)

    def _run_window(self, batches, window, accum):
        """One window program over stacked device batches
        (``[window(, accum), B, ...]`` each). One replay; with telemetry
        on, one host sync for the whole window."""
        obs_on = _obs.enabled()
        t0 = time.perf_counter() if obs_on else 0.0
        batches = tuple(getattr(b, "_data", b) for b in batches)
        lead = 2 if accum > 1 else 1
        for b in batches:
            if not torch.is_tensor(b) or b.device != self.device or \
                    tuple(b.shape[:lead]) != ((window, accum) if accum > 1
                                              else (window,)):
                raise MXNetError(f"window batches must be [{window}"
                                 f"{', %d' % accum if accum > 1 else ''}, "
                                 f"B, ...] tensors on {self.device}")
        shapes = tuple((tuple(b.shape[lead:]), b.dtype) for b in batches)
        key = ("window", window, accum, shapes, _cg.capture_state(), obs_on,
               self._hyper_key())
        prog, (static, rates, sent), _ = self._program(
            key, "window", shapes,
            lambda s: self._new_program(s, window, accum, obs_on))
        for dst, b in zip(static, batches):
            dst.copy_(b if accum > 1 else b.unsqueeze(1))
        self._fill(rates, sent)
        try:
            # one capture covers the whole window
            outs = self._probe(prog, int(self.optimizer.num_update) + window)
            losses = outs[0].clone()
            self._wrote_params()
            self._window_dispatches += 1
            self.optimizer.num_update += window
            if obs_on:
                self._record_window(
                    t0 + _profiling.step_capture_begin_seconds(self._ptok),
                    batches, losses, outs[1].clone(), window, accum)
        except BaseException:
            _profiling.step_capture_abort(self._ptok)
            self._ptok = None
            raise
        self._end_capture(losses)
        self._run_monitors()
        self._check_preemption()
        return losses

    # -- telemetry -----------------------------------------------------------
    def _note_recompile(self, kind, shapes):
        """Count a new program with its cause (the JAX step's
        ``train_recompiles_total{reason}``): ``"window"`` for a window
        program; for a step program ``first``, ``arity``, ``shape``,
        ``dtype`` or ``hyperparams`` against the closest signature seen."""
        seen = self._signatures.setdefault(kind, [])
        if kind == "window":
            reason = "window"
        elif not seen:
            reason = "first"
        else:
            rank = {"hyperparams": 0, "dtype": 1, "shape": 2, "arity": 3}
            causes = []
            for prev in seen:
                if len(prev) != len(shapes):
                    causes.append("arity")
                elif any(a[0] != b[0] for a, b in zip(prev, shapes)):
                    causes.append("shape")
                elif any(a[1] != b[1] for a, b in zip(prev, shapes)):
                    causes.append("dtype")
                else:
                    causes.append("hyperparams")
            reason = min(causes, key=rank.get)
        seen.append(shapes)
        _obs.counter("train_recompiles_total",
                     "TrainStep program builds (cache misses)").inc(
                         reason=reason)
        _obs.emit("recompile", reason=reason, family=kind,
                  shapes=[list(s) for s, _ in shapes])

    def _amp_fetchable(self):
        if self.amp_state is None:
            return None
        return (self.amp_state["scale"], self.amp_state["skipped"])

    def _record_amp(self, amp_h):
        """Loss-scale gauge + skipped-step counter (float16 only), from the
        values fetched with the step's or window's one sync."""
        if amp_h is None:
            return
        scale_f, skipped = float(amp_h[0]), int(amp_h[1])
        _obs.gauge("train_loss_scale",
                   "current AMP dynamic loss scale").set(scale_f)
        d = skipped - self._amp_skipped_seen
        if d > 0:
            _obs.counter("train_amp_skipped_steps_total",
                         "steps dropped by AMP overflow handling").inc(d)
        self._amp_skipped_seen = skipped

    def _record_step(self, t0, raws, loss, gnorm):
        # reading loss/gnorm waits for the card: with telemetry on, the step
        # time is the step's wall clock, not its dispatch
        loss_f = float(loss)
        gnorm_f = float(gnorm) if gnorm is not None else None
        amp_h = self._amp_fetchable()
        dt = time.perf_counter() - t0
        _obs.set_step(int(self.optimizer.num_update))
        b0 = raws[0] if raws else None
        shape = tuple(np.shape(b0)) if b0 is not None else ()
        samples = int(shape[0]) if shape else 1
        tokens = int(np.prod(shape)) if b0 is not None else 0
        _obs.histogram("train_step_seconds", "full train-step wall clock",
                       unit="s").observe(dt, loop="train_step")
        _obs.counter("train_steps_total").inc(loop="train_step")
        _obs.counter("train_samples_total").inc(samples, loop="train_step")
        _obs.counter("train_tokens_total").inc(tokens, loop="train_step")
        _obs.gauge("train_tokens_per_sec", unit="tokens/s").set(
            tokens / dt if dt > 0 else 0.0)
        _obs.gauge("train_loss").set(loss_f)
        if gnorm_f is not None:
            _obs.gauge("train_grad_norm").set(gnorm_f)
        self._record_amp(amp_h)
        _obs.emit("train_step", loss=loss_f, grad_norm=gnorm_f,
                  step_seconds=round(dt, 6), samples=samples, tokens=tokens,
                  tokens_per_sec=round(tokens / dt, 3) if dt > 0 else 0.0)

    def _record_window(self, t0, batches, losses, gnorms, window, accum):
        # one sync for the whole window: losses, norms and the amp carry
        loss_h = losses.tolist()
        gnorm_h = gnorms.tolist()
        amp_h = self._amp_fetchable()
        dt = time.perf_counter() - t0
        _obs.set_step(int(self.optimizer.num_update))
        b0 = batches[0] if batches else None
        nlead = 2 if accum > 1 else 1
        samples = (int(math.prod(b0.shape[:nlead + 1]))
                   if b0 is not None and b0.dim() > nlead else window)
        tokens = int(b0.numel()) if b0 is not None else 0
        _obs.histogram("train_step_seconds", "full train-step wall clock",
                       unit="s").observe(dt, loop="run_window")
        _obs.counter("train_steps_total").inc(window, loop="run_window")
        _obs.counter("train_samples_total").inc(samples, loop="run_window")
        _obs.counter("train_tokens_total").inc(tokens, loop="run_window")
        _obs.gauge("train_tokens_per_sec", unit="tokens/s").set(
            tokens / dt if dt > 0 else 0.0)
        _obs.gauge("train_loss").set(float(loss_h[-1]))
        _obs.gauge("train_grad_norm").set(float(gnorm_h[-1]))
        self._record_amp(amp_h)
        _obs.emit("train_window", window=window, accum=accum,
                  loss=float(loss_h[-1]),
                  loss_mean=float(sum(loss_h) / len(loss_h)),
                  grad_norm=float(gnorm_h[-1]),
                  window_seconds=round(dt, 6),
                  step_seconds_amortized=round(dt / window, 6),
                  samples=samples, tokens=tokens,
                  tokens_per_sec=round(tokens / dt, 3) if dt > 0 else 0.0)

    # -- monitors and preemption ---------------------------------------------
    def attach_monitor(self, mon):
        """Register a :class:`~mxnet_tpu_torch.monitor.Monitor`, run at
        every step and window boundary over the parameters (gradients live
        only inside the step program: no grad rows)."""
        mon._skip_grads = True
        self._monitors.append(mon)
        return mon

    def _run_monitors(self):
        for m in self._monitors:
            m.tic()
            m.toc_print()

    def install_preemption(self, directory: str, guard=None,
                           exit_on_preempt: bool = True):
        """SIGTERM/SIGINT -> checkpoint into ``directory`` at the next step
        or window boundary, then raise
        :class:`~mxnet_tpu_torch.resilience.Preempted` (``SystemExit(0)``).
        Returns the installed guard (``guard.request()`` triggers the same
        path without a signal; with ``exit_on_preempt=False`` the step
        checkpoints once and lets the caller wind down)."""
        from ..resilience.preemption import PreemptionGuard

        self._preempt_guard = (guard or PreemptionGuard()).install()
        self._preempt_dir = directory
        self._preempt_exit = exit_on_preempt
        self._preempt_saved = False  # re-arm the one-shot save on reinstall
        return self._preempt_guard

    def _check_preemption(self):
        g = self._preempt_guard
        if g is None or not g.requested:
            return
        from ..resilience.preemption import Preempted

        if not self._preempt_saved:
            self.save(self._preempt_dir)
            self._preempt_saved = True
        if self._preempt_exit:
            raise Preempted(g.signum)

    # -- amp policy introspection ------------------------------------------
    @property
    def loss_scale(self):
        """The dynamic loss scale (a host float; syncs). None unless the
        policy is float16."""
        if self.amp_state is None:
            return None
        return float(self.amp_state["scale"])

    @property
    def amp_skipped_steps(self):
        """Steps skipped for overflow so far (a host int; syncs). 0 unless
        the policy is float16."""
        if self.amp_state is None:
            return 0
        return int(self.amp_state["skipped"])

    def sync(self):
        """Kept for the API: the parameters are updated in place, so the net
        already holds them."""

    # -- checkpoint / resume -------------------------------------------------
    def _tree(self):
        """``(params, opt_state)`` keyed as the JAX step keys them (see
        ``_checkpoint_names``): every parameter as the net holds it, the
        state of every trainable one."""
        names = self._ckpt_names
        params = {names[name]: p.detach() for name, p in self._plist}
        opt_state = {names[name]: self.opt_state[name]
                     for _, name, _ in self._train}
        return params, opt_state

    def save(self, directory):
        """Checkpoint into ``directory/ckpt-{num_update}`` in the JAX
        package's format (``checkpoint.save_train_state``). ``meta.json``
        holds ``step`` = ``num_update`` (attempted steps, the schedule's
        clock), ``applied_step`` = the card's step count (Adam's t) and,
        under float16, ``amp_state``. The f32 masters of bf16/f16
        parameters go into ``masters.npz`` beside the JAX package's arrays,
        so a resume keeps their low bits. Syncs. Returns the path."""
        from ..checkpoint import save_train_state

        extra = {"applied_step": int(self.step_count)}
        if self.amp_state is not None:
            a = self.amp_state
            extra["amp_state"] = {"scale": float(a["scale"]),
                                  "good": int(a["good"]),
                                  "skipped": int(a["skipped"])}
        params, opt_state = self._tree()
        masters = {self._ckpt_names[name]: m
                   for name, m in self._master.items()}
        return save_train_state(directory, int(self.optimizer.num_update),
                                params, opt_state, extra=extra,
                                masters=masters)

    def restore(self, directory):
        """Restore the newest valid checkpoint under ``directory`` (written
        by either package); False when there is none. Every parameter,
        moment, the step count and the loss-scale carry are written into
        their existing storage, then the copies and masters are cast again
        from the parameters, and the masters the checkpoint holds (a port
        checkpoint's ``masters.npz``) are written over theirs: captured
        programs stay valid."""
        from ..checkpoint import (latest_checkpoint, load_masters,
                                  load_train_state, tree_flatten)

        path = latest_checkpoint(directory)
        if path is None:
            return False
        like = self._tree()
        params, opt_state, step = load_train_state(path, like=like)
        meta = {}
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass  # pre-extra checkpoints: fall back to step for everything
        dst, _ = tree_flatten({"params": like[0], "opt_state": like[1]})
        src, _ = tree_flatten({"params": params, "opt_state": opt_state})
        for i, (d, s) in enumerate(zip(dst, src)):
            if d.dtype != s.dtype:
                raise MXNetError(f"{path}: array {i} is {s.dtype}, the step "
                                 f"holds {d.dtype}")
        masters = load_masters(path)
        want = {self._ckpt_names[name]: m for name, m in self._master.items()}
        if masters is not None and \
                {k: tuple(v.shape) for k, v in masters.items()} != \
                {k: tuple(v.shape) for k, v in want.items()}:
            raise MXNetError(f"{path}: its masters {sorted(masters)[:3]} do "
                             f"not fit the step's {sorted(want)[:3]}")
        with torch.no_grad():
            for d, s in zip(dst, src):
                d.copy_(s)
            self.step_count.fill_(int(meta.get("applied_step", step)))
            if self.amp_state is not None and "amp_state" in meta:
                a = meta["amp_state"]
                for k in ("scale", "good", "skipped"):
                    self.amp_state[k].fill_(a[k])
                self._amp_skipped_seen = int(a["skipped"])
        self.optimizer.num_update = step
        self._refresh_copies(force=True)
        if masters is not None:
            with torch.no_grad():
                for k, m in want.items():
                    m.copy_(masters[k])
        return True

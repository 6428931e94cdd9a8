"""The single-device training step.

Counterpart of the ``mesh=None`` subset of ``mxnet_tpu/parallel/train_step.py``:
one call is forward, backward and the optimizer update of every trainable
parameter. Where the JAX step is one compiled program with donated
buffers, cached per signature (``_compiled``), this one is one captured
CUDA graph per signature (``ops/cuda_graph.py``; with
``engine_type="naive"``, and on the CPU, the same step function runs
eagerly at every call over the same static buffers), and it updates the
module's
parameters and the optimizer state in place. The signature is the batch's
shapes and dtypes, the AMP policy and the storage of every parameter,
moment and low-precision copy: a parameter given new storage (``p.data =
...``) drops the graph, and the next calls capture anew (counted in
``recaptures``). Each call copies the batch and the per-parameter rates
into static buffers before the replay, and returns a copy of the graph's
loss. The step count lives on the card and the
bias-corrected learning rate is computed there from it, so a step issues
its work without waiting for the card: the returned loss is a 0-d device
tensor, and reading it is the caller's sync.

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
separate cast pass. Frozen parameters are cast once. A master changed
outside the step (``load_mxnet_params``, ``load_state_dict``, an in-place
write under ``no_grad``, or ``p.data = ...``) has its copy cast again
before the next forward: the step keeps each master's storage and version
counter as of the last write it knows of. Writes through ``p.data`` bypass
the version counter; call :meth:`TrainStep.refresh_copies` after them.
Under float16 the
dynamic loss scale, the good-step run and the skip count live on the card:
an overflowed step leaves weights, moments, copies and Adam's t as they
were, halves the scale (not below 1) and counts the skip, with no host
sync.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError
from ..contrib import amp as _amp
from ..ops import cuda_graph as _cg

__all__ = ["TrainStep"]


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
        self._capture = self.engine_type == "graph" and \
            self.device.type == "cuda"
        self._stream = _cg.capture_stream(self, self.device) \
            if self._capture else None
        self._train = [(i, name, p) for i, (name, p) in enumerate(self._plist)
                       if p.requires_grad]
        self.opt_state = {name: optimizer.create_state(i, p.detach())
                          for i, name, p in self._train}
        self.step_count = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._mult_key = self._rate_key = None
        self._mults = self._lr_wd = None
        # name -> the low-precision copy of an f32 parameter (AMP only), and
        # its master's (storage, version) when the copy was last written
        self._low = {}
        self._stamps = {}
        self.amp_state = None
        pol = self.amp_policy
        if pol is not None:
            for name, p in self._plist:
                if p.dtype == torch.float32:
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
        # (batch shapes and dtypes, capture state) -> the step program, its
        # static inputs and the storage it was captured over
        self._programs = {}
        #: programs dropped because a parameter, moment or copy moved
        self.recaptures = 0

    @staticmethod
    def _stamp(p):
        return p.data_ptr(), p._version

    def _refresh_copies(self, force=False):
        """Cast again each copy whose master changed since the step last
        wrote it (every copy with ``force``)."""
        with torch.no_grad():
            for name, p in self._plist:
                low = self._low.get(name)
                if low is None:
                    continue
                stamp = self._stamp(p)
                if force or stamp != self._stamps[name]:
                    low.copy_(p.detach())
                    self._stamps[name] = stamp

    def refresh_copies(self):
        """Cast every low-precision copy from its f32 master again. Needed
        only after writing masters through ``p.data``, which the step
        cannot see; other changes it picks up by itself."""
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

    def _rates(self):
        """(N,) f32 device tensors of lr·lr_mult and wd·wd_mult, products
        taken in f32 as the JAX step takes them, on the card. The
        multipliers are re-sent only when one changes; the two rates
        (a schedule's change every step) only when they change."""
        lr_mult, wd_mult = self._resolve_mults()
        mkey = (tuple(lr_mult.values()), tuple(wd_mult.values()))
        if mkey != self._mult_key:
            names = [name for _, name, _ in self._train]
            self._mults = self._to_device(
                [[lr_mult[n] for n in names], [wd_mult[n] for n in names]])
            self._mult_key, self._rate_key = mkey, None
        key = (np.float32(self.optimizer.learning_rate),
               np.float32(self.optimizer.wd))
        if key != self._rate_key:
            rates = self._to_device(key)
            self._lr_wd = (rates[0] * self._mults[0],
                           rates[1] * self._mults[1])
            self._rate_key = key
        return self._lr_wd

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
            out = torch.func.functional_call(self.net, params, inputs)
            leaves = [params[name] for _, name, _ in self._train]
        loss = self.loss_fn(out, *batch[n:]).float().mean()
        if self.amp_state is not None:
            loss = loss * self.amp_state["scale"]
        return loss, leaves

    @staticmethod
    def _finite_all(grads):
        """One finiteness reduction over every gradient (the max-norm of
        each, one multi-tensor pass), kept on the card."""
        norms = torch._foreach_norm(grads, float("inf"))
        return torch.isfinite(torch.stack(norms)).all()

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

    def __call__(self, *batch):
        """Run one step. ``batch = (x, label, ...)`` as tensors (or
        NDArrays) on the net's device, or numpy arrays. Returns the loss as
        a 0-d f32 device tensor."""
        batch = tuple(getattr(b, "_data", b) for b in batch)
        loss = self._program_step(batch)
        for _, name, p in self._train:  # the update wrote masters and copies
            if name in self._stamps:
                self._stamps[name] = self._stamp(p)
        self.optimizer.num_update += 1
        return loss

    @property
    def compiled_programs(self) -> int:
        """Step programs held now, one per batch signature (under "graph",
        on the card, each is one captured CUDA graph)."""
        return len(self._programs)

    def _storage(self):
        """The storage a step graph is captured over: every parameter,
        moment and low-precision copy."""
        out = [p.data_ptr() for _, p in self._plist]
        for st in self.opt_state.values():
            out.extend(t.data_ptr() for t in
                       (st if isinstance(st, (tuple, list)) else (st,))
                       if t is not None)
        out.extend(low.data_ptr() for low in self._low.values())
        return tuple(out)

    def _program_step(self, batch):
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
        key = (shapes, _cg.capture_state())
        storage = self._storage()
        entry = self._programs.get(key)
        if entry is not None and entry[2] != storage:
            del self._programs[key]  # a parameter moved: capture again
            self.recaptures += 1
            entry = None
        if entry is None:
            entry = self._programs[key] = self._new_program(shapes, storage)
        prog, (static_batch, lr_buf, wd_buf), _ = entry
        for dst, b, h in zip(static_batch, arrays, host):
            if h and self.device.type == "cuda":
                dst.copy_(b.pin_memory(), non_blocking=True)
            else:
                dst.copy_(b)
        if self._low:
            self._refresh_copies()
        lr, wd = self._rates()
        lr_buf.copy_(lr)
        wd_buf.copy_(wd)
        return prog()[0].clone()

    def _new_program(self, shapes, storage):
        """A step graph over new static batch and (N,) rate buffers."""
        dev = self.device
        static_batch = tuple(torch.zeros(shape, dtype=dt, device=dev)
                             for shape, dt in shapes)
        n = len(self._train)
        lr_buf = torch.zeros(n, dtype=torch.float32, device=dev)
        wd_buf = torch.zeros(n, dtype=torch.float32, device=dev)
        # the program holds its owner weakly: a cycle through it would keep
        # the graph's memory pool alive after the TrainStep is dropped
        owner = weakref.ref(self)
        prog = _cg.StepGraph(
            lambda: (owner()._step(static_batch, lr_buf, wd_buf),),
            ("train_step", shapes, self.amp_policy), dev,
            stream=self._stream, capture=self._capture)
        return prog, (static_batch, lr_buf, wd_buf), storage

    def _step(self, batch, lr, wd):
        """Forward, backward and update over device ``batch`` at the (N,)
        rates ``lr`` and ``wd``. Returns the detached loss."""
        was_training = self.net.training
        self.net.train()
        try:
            with torch.enable_grad():
                loss, leaves = self._forward_loss(batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            self.net.train(was_training)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        lows = [self._low.get(name) for _, name, _ in self._train] \
            if self._low else None
        with torch.no_grad():
            t2 = self.step_count + 1
            inv = skip = finite = None
            if self.amp_state is not None:
                inv = 1.0 / self.amp_state["scale"]
                finite = self._finite_all(grads)
                skip = (~finite).to(torch.int32)
                loss = loss * inv
            self.optimizer.update_raw_multi(
                [p.detach() for _, _, p in self._train], grads,
                [self.opt_state[name] for _, name, _ in self._train],
                lr, wd, t2, out_lows=lows, inv_scale=inv, skip=skip)
            if finite is None:
                self.step_count.copy_(t2)
            else:
                # Adam's t advances only on applied steps
                self.step_count.copy_(torch.where(finite, t2, self.step_count))
                self._next_amp_state(finite)
        return loss.detach()

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

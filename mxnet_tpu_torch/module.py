"""The Module API: ``Module.fit``, the legacy symbolic training path.

Counterpart of ``mxnet_tpu/module.py`` (MXNet's ``python/mxnet/module/``).
A :class:`Module` binds a Symbol (a loss head such as ``SoftmaxOutput``)
to data and label shapes, keeps its parameters as NDArrays on one device
(its ``context``, the current context, the card, by default), evaluates
the graph op by op through the registry under ``autograd.record`` and
updates every parameter through the optimizer's ``update_multi`` (Adam:
one kernel launch an update). :class:`BucketingModule` keeps one bound
Module a bucket key (a sequence length), all sharing the default bucket's
parameters and optimizer states by reference.

``forward_backward`` is ``BaseModule``'s, as in MXNet, so
``BucketingModule.fit`` runs (the JAX package defines it on ``Module``
only, and its ``BucketingModule.fit`` raises ``AttributeError``).

One device and no kvstore: ``init_optimizer(kvstore=)`` takes ``"local"``,
``"device"`` or None and keeps no store; a distributed kvstore raises.
The JAX package's BatchNorm graph has no auxiliary states (its moving
statistics are arguments), so a Module hands them to the optimizer as it
does the weights.
"""
from __future__ import annotations

import logging
import pickle
from typing import Dict

import numpy as np
import torch

from . import metric as metric_mod
from . import optimizer as opt_mod
from .base import MXNetError
from .context import as_device
from .io.io import DataBatch, DataDesc
from .ndarray import NDArray, array
from .symbol import Symbol

__all__ = ["BaseModule", "Module", "BucketingModule"]

_LOCAL_KVSTORES = (None, "local", "device")


class BaseModule:
    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger()
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_init=False, begin_epoch=0, num_epoch=None,
            validation_metric=None, monitor=None):
        assert num_epoch is not None, "num_epoch required"
        if not self.binded:
            self.bind(data_shapes=train_data.provide_data,
                      label_shapes=train_data.provide_label,
                      for_training=True)
        if not self.params_initialized or force_init:
            self.init_params(initializer=initializer, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
        if not self.optimizer_initialized:
            self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=dict(optimizer_params))
        eval_metric = metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            for batch in train_data:
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    for cb in _listify(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric))
                nbatch += 1
            name_vals = eval_metric.get_name_value()
            self.logger.info("Epoch[%d] %s", epoch,
                             " ".join(f"{n}={v:.5f}" for n, v in name_vals))
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _listify(epoch_end_callback):
                    cb(epoch, self._symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric)
                for n, v in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, n, v)

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True):
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
        return eval_metric.get_name_value()

    # outputs kept on the device before they are copied to the host: the
    # dispatch of the next batches runs ahead of the copy, and device memory
    # holds a window of outputs, not the whole set
    _PREDICT_WINDOW = 16

    def predict(self, eval_data, num_batch=None, reset=True):
        if reset:
            eval_data.reset()
        pending, host = [], []
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            pending.append(self.get_outputs()[0]._data.detach())
            if len(pending) >= self._PREDICT_WINDOW:
                host.append(pending.pop(0).cpu().numpy())
        host.extend(t.cpu().numpy() for t in pending)
        return array(np.concatenate(host))


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = None


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _host_tree(x):
    """Optimizer states as host numpy (tuples, lists and dicts kept)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_host_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    return x


class Module(BaseModule):
    def __init__(self, symbol: Symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=None, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._context = context
        self._device = None
        self._arg_params: Dict[str, NDArray] = {}
        self._optimizer = None
        self._opt_states = None
        self._opt_idx = None

    def _dev(self):
        if self._device is None:
            self._device = as_device(self._context)
        return self._device

    # -- bind ---------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        shapes = {}
        for d in list(data_shapes) + list(label_shapes or []):
            name, shape = (d.name, d.shape) if isinstance(d, DataDesc) else d
            shapes[name] = tuple(shape)
        # label arguments may be absent from the symbol (a loss in-symbol)
        self._param_names = [a for a in self._symbol.list_arguments()
                             if a not in shapes]
        self._shapes = shapes
        self._dev()
        self.binded = True
        self._for_training = for_training
        self._grad_req = grad_req
        return self

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        from . import initializer as init_mod

        initializer = initializer or init_mod.Uniform(0.01)
        # parameter shapes inferred from the data shapes
        arg_shapes, _, _ = self._symbol.infer_shape(**self._shapes)
        if arg_shapes is None:
            raise MXNetError("init_params: cannot infer shapes; provide all "
                             "input shapes at bind time")
        dev = self._dev()
        names = self._symbol.list_arguments()
        for name, shape in zip(names, arg_shapes):
            if name in self._shapes:
                continue
            if arg_params and name in arg_params:
                self._arg_params[name] = _copy_to(arg_params[name], dev)
            elif name not in self._arg_params or force_init:
                data = initializer.init_for_name(name, shape)
                self._arg_params[name] = NDArray(
                    data.to(device=dev, dtype=torch.float32))
        for p in self._arg_params.values():
            p.attach_grad()
        self.params_initialized = True
        return self

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if not (kvstore is None or isinstance(kvstore, str)) or \
                kvstore not in _LOCAL_KVSTORES:
            raise MXNetError(
                f"kvstore {kvstore!r} is not ported: Module runs on one "
                "device and keeps no store ('local', 'device' or None); "
                "distributed kvstores come with the multi-device work "
                "(ROADMAP.md section 1, item 11)")
        self._optimizer = opt_mod.create(optimizer, **(optimizer_params or {}))
        self._opt_states = {k: self._optimizer.create_state(i, v._data)
                            for i, (k, v) in
                            enumerate(self._arg_params.items())}
        self._opt_idx = {k: i for i, k in enumerate(self._arg_params)}
        self.optimizer_initialized = True
        return self

    # -- step ---------------------------------------------------------------
    def forward(self, data_batch: DataBatch, is_train=None):
        from . import autograd

        dev = self._dev()
        env = {}
        for name, arr in zip(self._data_names, data_batch.data):
            env[name] = _on(arr, dev)
        if data_batch.label is not None:
            for name, arr in zip(self._label_names, data_batch.label):
                env[name] = _on(arr, dev)
        env.update(self._arg_params)
        is_train = self._for_training if is_train is None else is_train
        if is_train:
            with autograd.record():
                self._outputs = self._eval_symbol(env)
        else:
            self._outputs = self._eval_symbol(env)
        return self

    def _eval_symbol(self, env):
        """The bound symbol's outputs, one NDArray a head (a Group has
        several)."""
        from .symbol import eval_symbol

        out = eval_symbol(self._symbol, env)
        return list(out) if isinstance(out, tuple) else [out]

    def backward(self, out_grads=None):
        from . import autograd

        heads = list(self._outputs)
        # every head backpropagates, a non-scalar one with a ones cotangent
        # unless given one (MXNet's executor; output ops such as
        # SoftmaxOutput carry their own gradient and ignore it)
        if out_grads is not None and not isinstance(out_grads, (list, tuple)):
            out_grads = [out_grads]
        if out_grads is not None and len(out_grads) != len(heads):
            raise ValueError(
                f"Module.backward got {len(out_grads)} out_grads for "
                f"{len(heads)} outputs; pass one cotangent per output")
        autograd.backward(heads, head_grads=list(out_grads) if out_grads
                          else None)

    def update(self):
        names = list(self._arg_params)
        ws = [self._arg_params[k] for k in names]
        gs = [w._data.grad if w._data.grad is not None else
              torch.zeros_like(w._data) for w in ws]
        states = [self._opt_states[k] for k in names]
        new_states = self._optimizer.update_multi(
            [self._opt_idx[k] for k in names], ws, gs, states)
        for k, s in zip(names, new_states):
            self._opt_states[k] = s

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        # detached: a metric's running sums must not hold the step's graph
        eval_metric.update(labels, [o.detach() for o in self._outputs])

    def get_outputs(self, merge_multi_context=True):
        return self._outputs

    def get_params(self):
        return dict(self._arg_params), {}

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        dev = self._dev()
        for k, v in (arg_params or {}).items():
            self._arg_params[k] = _copy_to(v, dev)
            self._arg_params[k].attach_grad()
        self.params_initialized = True

    # -- checkpoint (mod.save_checkpoint / Module.load) ----------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-NNNN.params`` (``arg:`` names)
        and, with ``save_optimizer_states``, ``prefix-NNNN.states`` (the
        states as host numpy, pickled; nothing reads it back, as in the
        JAX package)."""
        from .serialization import save_ndarrays

        self._symbol.save(f"{prefix}-symbol.json")
        save_ndarrays(f"{prefix}-{epoch:04d}.params",
                      {f"arg:{k}": v._data.detach()
                       for k, v in self._arg_params.items()})
        if save_optimizer_states:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                pickle.dump(_host_tree(self._opt_states), f)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        pass  # a single module; BucketingModule keeps one a bucket

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix-symbol.json`` whose parameters
        (``prefix-NNNN.params``) wait in ``_pending_params`` for
        :meth:`init_params_from_pending` after ``bind``."""
        from . import symbol as sym_mod
        from .serialization import load_tensors

        symbol = sym_mod.load(f"{prefix}-symbol.json")
        mod = Module(symbol, **kwargs)
        loaded = load_tensors(f"{prefix}-{epoch:04d}.params")
        mod._pending_params = {k.removeprefix("arg:"): NDArray(v)
                               for k, v in loaded.items()}
        return mod

    def init_params_from_pending(self):
        self.set_params(self._pending_params)


def _on(arr, dev):
    if not isinstance(arr, NDArray):
        return array(arr, ctx=dev)
    return arr if arr._data.device == dev else NDArray(arr._data.to(dev))


def _copy_to(v, dev):
    t = v._data if isinstance(v, NDArray) else torch.as_tensor(np.asarray(v))
    return NDArray(t.detach().to(dev).clone())


class BucketingModule(BaseModule):
    """Variable-length training with one Module a bucket key (MXNet's
    ``python/mxnet/module/bucketing_module.py``): ``sym_gen(key)`` gives
    the bucket's symbol, data names and label names; every bucket shares
    the default bucket's parameters and optimizer states by reference."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=None,
                 context=None, **kwargs):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._buckets: Dict = {}
        self._curr = None

    def _module_for(self, key):
        if key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(key)
            mod = Module(sym, data_names=data_names, label_names=label_names,
                         logger=self.logger, context=self._context)
            if self._default_key in self._buckets and \
                    key != self._default_key:
                # parameters and optimizer state shared with the default
                # bucket by reference; the bucket binds itself (in forward)
                # with its own shapes
                master = self._buckets[self._default_key]
                mod._device = master._device
                mod._arg_params = master._arg_params
                mod._opt_states = master._opt_states
                mod._opt_idx = master._opt_idx
                mod._optimizer = master._optimizer
                mod.params_initialized = master.params_initialized
                mod.optimizer_initialized = master.optimizer_initialized
            self._buckets[key] = mod
        return self._buckets[key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             **kwargs):
        mod = self._module_for(self._default_key)
        mod.bind(data_shapes, label_shapes, for_training)
        self.binded = True
        return self

    def init_params(self, **kwargs):
        self._buckets[self._default_key].init_params(**kwargs)
        self.params_initialized = True
        return self

    def init_optimizer(self, **kwargs):
        self._buckets[self._default_key].init_optimizer(**kwargs)
        self.optimizer_initialized = True
        return self

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", None) or self._default_key
        self._curr = self._module_for(key)
        if not self._curr.binded:
            shapes = [(n, a.shape) for n, a in
                      zip(self._curr._data_names, data_batch.data)]
            lshapes = None
            if data_batch.label is not None:
                lshapes = [(n, a.shape) for n, a in
                           zip(self._curr._label_names, data_batch.label)]
            self._curr.bind(shapes, lshapes)
        self._curr.forward(data_batch, is_train)
        return self

    def backward(self, out_grads=None):
        self._curr.backward(out_grads)

    def update(self):
        self._curr.update()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr.update_metric(eval_metric, labels)

    def get_outputs(self, merge_multi_context=True):
        return self._curr.get_outputs()

    def get_params(self):
        return self._buckets[self._default_key].get_params()

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol with the shared parameters (and
        optimizer states), as MXNet's ``BucketingModule`` saves them."""
        self._buckets[self._default_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)

"""The legacy ``mx.model`` namespace.

Counterpart of ``mxnet_tpu/model.py`` (MXNet's ``python/mxnet/model.py``).
``FeedForward`` was deprecated in favour of ``mx.mod.Module`` in MXNet
1.x already; here it is a thin shim over
:class:`~mxnet_tpu_torch.module.Module` that keeps the constructor,
``fit``, ``predict``, ``score``, ``save`` and ``load`` old scripts call.
The checkpoint helpers are shared with Module.
"""
from __future__ import annotations

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint"]

from .module import Module


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params=None):
    """``mx.model.save_checkpoint``: prefix-symbol.json and
    prefix-NNNN.params (``arg:``/``aux:`` keys, the 0x112 format)."""
    from .serialization import save_ndarrays

    symbol.save(f"{prefix}-symbol.json")
    blob = {f"arg:{k}": _raw(v) for k, v in (arg_params or {}).items()}
    blob.update({f"aux:{k}": _raw(v) for k, v in (aux_params or {}).items()})
    save_ndarrays(f"{prefix}-{epoch:04d}.params", blob)


def _raw(v):
    return v._data.detach() if hasattr(v, "_data") else v


def load_checkpoint(prefix, epoch):
    """``mx.model.load_checkpoint`` -> (symbol, arg_params, aux_params),
    NDArrays on the CPU, the context a ``.params`` file records."""
    from . import symbol as sym_mod
    from .ndarray import NDArray
    from .serialization import load_tensors

    symbol = sym_mod.load(f"{prefix}-symbol.json")
    loaded = {k: NDArray(v) for k, v in
              load_tensors(f"{prefix}-{epoch:04d}.params").items()}
    arg_params = {k.removeprefix("arg:"): v for k, v in loaded.items()
                  if k.startswith("arg:")}
    aux_params = {k.removeprefix("aux:"): v for k, v in loaded.items()
                  if k.startswith("aux:")}
    return symbol, arg_params, aux_params


class FeedForward:
    """Deprecated MXNet API; delegates to Module. Supported surface:
    ``fit(X, y=None, eval_data=...)``, ``predict(X)``, ``score(X)``,
    ``save(prefix, epoch)``, ``FeedForward.load(prefix, epoch)``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, optimizer="sgd",
                 initializer=None, arg_params=None, aux_params=None,
                 begin_epoch=0, **kwargs):
        import warnings

        warnings.warn("FeedForward is deprecated (as in MXNet); "
                      "use mx.mod.Module or Gluon", DeprecationWarning,
                      stacklevel=2)
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.begin_epoch = begin_epoch
        self._optimizer = optimizer
        self._init = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        # every extra kwarg is an optimizer hyperparameter (MXNet's
        # FeedForward forwarded **kwargs to the optimizer)
        self._opt_kwargs = dict(kwargs)
        self._mod = None

    def _module(self, data_iter):
        if self._mod is None:
            self._mod = Module(self.symbol, context=self.ctx)
            self._mod.bind(data_shapes=data_iter.provide_data,
                           label_shapes=getattr(data_iter, "provide_label",
                                                None))
            self._mod.init_params(initializer=self._init,
                                  arg_params=self.arg_params,
                                  aux_params=self.aux_params)
            self._mod.init_optimizer(optimizer=self._optimizer,
                                     optimizer_params=self._opt_kwargs or None)
        return self._mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            batch_end_callback=None, epoch_end_callback=None, logger=None):
        it = self._as_iter(X, y)
        mod = self._module(it)
        # num_epoch is the END epoch (MXNet's semantics); after load()
        # begin_epoch may exceed a default, which would silently train zero
        # epochs — default to one epoch past begin instead
        end_epoch = self.num_epoch if self.num_epoch is not None \
            else self.begin_epoch + 1
        mod.fit(it, eval_data=eval_data, eval_metric=eval_metric,
                num_epoch=end_epoch,
                begin_epoch=self.begin_epoch,
                batch_end_callback=batch_end_callback,
                epoch_end_callback=epoch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None):
        it = self._as_iter(X, None)
        mod = self._module(it)
        return mod.predict(it, num_batch=num_batch)

    def score(self, X, y=None, eval_metric="acc"):
        it = self._as_iter(X, y)
        return self._module(it).score(it, eval_metric)

    def save(self, prefix, epoch=None):
        epoch = epoch if epoch is not None else self.num_epoch or 0
        if self._mod is not None:
            self._mod.save_checkpoint(prefix, epoch)
        else:
            # constructed/loaded but never fit: save the held params directly
            save_checkpoint(prefix, epoch, self.symbol,
                            self.arg_params or {}, self.aux_params or {})

    @classmethod
    def load(cls, prefix, epoch, ctx=None, **kwargs):
        sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(sym, ctx=ctx, arg_params=arg_params,
                   aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def _as_iter(X, y):
        from .io.io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, label=y)

"""Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``. A :class:`Block` **is** a
``torch.nn.Module``: its children are torch submodules and the variables
of its Gluon :class:`~.parameter.Parameter`s are its torch parameters,
under the attribute names that declared them, so the structural names of
``_collect_params_with_prefix()`` are the ``state_dict`` keys, and
``TrainStep``, the generation engine and ``torch.func.functional_call``
work on a Block as on any module. Prefixes come from name scopes and
per-scope counters as in the JAX package, so ``collect_params().keys()``
match its keys for the same construction.

Calling a block on NDArrays is MXNet's imperative call: the outermost
call unwraps them, runs the forward with PyTorch's grad mode set by
``autograd.record`` and Dropout following ``autograd.is_training()``, and
wraps the outputs; inside, tensors flow as they do for a call on tensors
(``TrainStep``, the engine), where Dropout follows ``Module.training``.

Calling a block on Symbols (``mx.sym.var``) traces it: each
``hybrid_forward`` receives ``F = mx.sym`` and its parameters' Symbol
variables (``Parameter.var()``), and the call returns the output Symbol.
:meth:`HybridBlock.export` writes that graph as ``symbol.json`` with the
weights, and :class:`SymbolBlock` runs such a file as a block.

``hybridize()`` keeps eager execution: the port's compiled step is
``TrainStep``'s captured CUDA graph, and nothing here compiles. Its
``remat=`` runs each ``_remat_unit`` layer under
``torch.utils.checkpoint`` when gradients are recorded.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import torch
import torch.utils.checkpoint

from .. import autograd as _ag
from .. import ndarray as nd
from .. import symbol as _sym
from ..base import MXNetError
from ..context import as_device as _as_device
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "imperative", "symbolic",
           "record_state_update"]


class _BlockScope:
    """Naming scope: unique prefixes as the JAX package makes them."""

    _tls = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._tls, "current", None)
        if current is None:
            if prefix is None:
                prefix = _global_count(hint)
            return prefix, ParameterDict(prefix, shared=params)
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = f"{hint}{count}_"
        full = current._block.prefix + prefix
        shared = params if params is not None else \
            current._block._params._shared
        return full, ParameterDict(full, shared=shared)

    def __enter__(self):
        self._old = getattr(_BlockScope._tls, "current", None)
        _BlockScope._tls.current = self
        return self

    def __exit__(self, *exc):
        _BlockScope._tls.current = self._old


_GLOBAL_COUNT = {}
_NAME_LOCK = threading.Lock()


def _global_count(hint):
    with _NAME_LOCK:
        n = _GLOBAL_COUNT.get(hint, 0)
        _GLOBAL_COUNT[hint] = n + 1
    return f"{hint}{n}_"


class _CallState(threading.local):
    def __init__(self):
        self.imperative = False
        self.symbolic = False


_CALL = _CallState()


def imperative() -> bool:
    """Whether an imperative (NDArray) block call is running."""
    return _CALL.imperative


def symbolic() -> bool:
    """Whether a block call on Symbols (a trace) is running."""
    return _CALL.symbolic


def record_state_update(param, value):
    """Write a layer's new state (BatchNorm's moving statistics) into
    ``param``'s variable, in place and outside autograd. The counterpart of
    the JAX state channel (``gluon/block.py:122``), which hands the update
    to its caller on a tape that the JAX ``TrainStep`` never reads. Here the
    write lands in the tensor the block declared, also when the forward
    read a substitute for it (``TrainStep``'s low-precision copies under
    ``torch.func.functional_call``): an imperative call, a call on tensors
    and a ``TrainStep`` step (eager or a captured graph's replay, where the
    write is a node of the graph) all update the same f32 statistic."""
    with torch.no_grad():
        param.tensor().copy_(value)


def _unwrap(obj):
    if isinstance(obj, NDArray):
        return obj._data
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unwrap(o) for o in obj)
    return obj


def _wrap(obj):
    if torch.is_tensor(obj):
        return NDArray(obj)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_wrap(o) for o in obj)
    return obj


def _has_nd(args, kwargs):
    return any(isinstance(a, NDArray) for a in args) or \
        any(isinstance(v, NDArray) for v in kwargs.values())


class Block(torch.nn.Module):
    """Base container: Gluon parameter declaration on a torch module."""

    #: a rematerialization unit under ``hybridize(remat=)``
    _remat_unit = False

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._scope = _BlockScope(self)
        self._reg_params = OrderedDict()
        self._remat = None
        self._active = False

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    @property
    def params(self):
        return self._params

    @property
    def _children(self):
        return self._modules

    def name_scope(self):
        return self._scope

    # -- registration -------------------------------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            self.__dict__.pop(name, None)
            value._attach_owner(self, name)
            return
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def _alloc_params(self, device):
        """Make the variables of this block's declared parameters whose
        shapes are known, on ``device`` (None: the current context)."""
        for p in self._reg_params.values():
            p._alloc(device)

    # -- parameters ---------------------------------------------------------
    def collect_params(self, select=None):
        """This block's parameters and its children's (a tied parameter
        appears once), optionally those whose names match ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self._params.items()
                        if pat.match(k)})
        for child in self._modules.values():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        seen = set()
        for k in list(ret.keys()):
            pid = id(ret[k])
            if pid in seen:
                ret.pop(k)
            else:
                seen.add(pid)
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx,
                                         force_reinit=force_reinit)
        return self

    def _draw(self, generator, device=None):
        """Initialize every parameter from ``generator``, in declaration
        order (the model zoo's ``seed=``)."""
        for p in self.collect_params().values():
            p.initialize(ctx=device, force_reinit=True, generator=generator)

    def cast(self, dtype):
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)
        return self

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + n: p for n, p in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """The initialized parameters under their structural names, each in
        its own dtype (bfloat16 stays bfloat16)."""
        from ..serialization import save_ndarrays

        params = self._collect_params_with_prefix()
        save_ndarrays(filename, {k: p._var.detach() for k, p in
                                 params.items() if p._var is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a ``.params`` file by structural names, each value cast to
        its parameter's dtype; with ``cast_dtype=True`` and
        ``dtype_source="saved"`` each parameter takes the file's dtype."""
        from ..serialization import load_tensors

        loaded = load_tensors(filename)
        params = self._collect_params_with_prefix()
        for name, p in params.items():
            if name not in loaded and not allow_missing:
                raise MXNetError(f"Parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"{filename} contains unknown parameters "
                                 f"{sorted(extra)[:5]}")
        for name, p in params.items():
            if name not in loaded:
                continue
            value = loaded[name]
            if cast_dtype and dtype_source == "saved":
                p.cast(value.dtype)
            p.set_data(value)
            if ctx is not None:
                p.reset_ctx(ctx)

    save_params = save_parameters

    def load_params(self, filename, ctx=None, **kw):
        self.load_parameters(filename, ctx=ctx, **kw)

    # -- call ---------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _CALL.symbolic or any(isinstance(a, _sym.Symbol) for a in args) \
                or any(isinstance(v, _sym.Symbol) for v in kwargs.values()):
            return self._trace(args, kwargs)
        if _has_nd(args, kwargs):
            args, kwargs = _unwrap(args), {k: _unwrap(v)
                                           for k, v in kwargs.items()}
            if not _CALL.imperative:
                _CALL.imperative = True
                try:
                    with torch.set_grad_enabled(_ag.is_recording()):
                        return _wrap(self._call(args, kwargs))
                finally:
                    _CALL.imperative = False
        return self._call(args, kwargs)

    def _trace(self, args, kwargs):
        """The forward on Symbols: no hooks, no rematerialization, no
        gradient; returns Symbols."""
        if _CALL.symbolic:
            return self.forward(*args, **kwargs)
        _CALL.symbolic = True
        try:
            with torch.no_grad():
                return self.forward(*args, **kwargs)
        finally:
            _CALL.symbolic = False

    def _call(self, args, kwargs):
        with nd.block_scope():
            if (self._remat is not None and type(self)._remat_unit
                    and torch.is_grad_enabled() and
                    kwargs.get("cache") is None):
                return torch.utils.checkpoint.checkpoint(
                    super().__call__, *args, use_reentrant=False, **kwargs)
            return super().__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        """Eager execution stays; ``remat=`` (True/"full": recompute each
        ``_remat_unit`` layer in backward, False: clear, None: leave as
        it is) threads to the children."""
        r = kwargs.get("remat", None)
        if r is not None:
            if r not in (True, False, "full"):
                raise ValueError(f"remat= takes True, 'full' or False here "
                                 f"(torch.utils.checkpoint recomputes the "
                                 f"whole layer), got {r!r}")
            self._remat = None if r is False else r
        self._active = active
        for child in self._modules.values():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)


class HybridBlock(Block):
    """A block written as ``hybrid_forward(F, x, *args, **params)``: ``F``
    is the port's ``nd`` (its ops take and return tensors here), and each
    declared parameter arrives as its variable, read from the module's
    torch parameters (so ``functional_call`` substitutes it)."""

    def infer_shape(self, *args):
        """Complete deferred shapes from the first forward's inputs."""
        raise DeferredInitializationError(
            f"{self.__class__.__name__} has deferred-initialized parameters "
            "and no infer_shape; run one forward or give full shapes")

    def forward(self, x, *args, **kwargs):
        if _CALL.symbolic:
            params = {name: p.var() for name, p in self._reg_params.items()}
            return self.hybrid_forward(_sym, x, *args, **params, **kwargs)
        params = {}
        for name in self._reg_params:
            t = self._parameters.get(name)
            if t is None:
                self._deferred_infer(x, *args)
                t = self._parameters.get(name)
            params[name] = t
        return self.hybrid_forward(nd, x, *args, **params, **kwargs)

    def _deferred_infer(self, x, *args):
        """Resolve deferred shapes in an eager forward, never inside a
        captured step graph."""
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(f"{self.name}: a deferred parameter cannot be "
                             "made inside a CUDA graph capture; run one "
                             "forward first")
        undone = [p for p in self._reg_params.values() if p._var is None]
        if any(p._deferred_init is None for p in undone):
            raise DeferredInitializationError(
                f"{self.name}: parameters used before initialization; call "
                ".initialize() first")
        self.infer_shape(x, *args)
        for p in undone:
            p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- deployment (MXNet's HybridBlock.export -> symbol.json + params) ----
    def trace_symbol(self, *input_names):
        """This block's forward traced into a Symbol graph: the inputs are
        ``sym.var`` of ``input_names`` and the parameters their named
        variables. A block whose forward reads shapes or calls torch
        directly (GPT-2, BERT, the fused RNN layers, as in the JAX package)
        does not trace and raises :class:`MXNetError`."""
        input_names = input_names or ("data",)
        try:
            return self(*[_sym.var(n) for n in input_names])
        except (AttributeError, TypeError) as e:
            raise MXNetError(f"{type(self).__name__} does not trace to a "
                             f"Symbol graph: {e}") from e

    def export(self, path, epoch=0, input_names=("data",)):
        """Write ``path-symbol.json`` and ``path-{epoch:04d}.params`` (the
        deploy format: every parameter under ``arg:`` and its name) and
        return the two file names."""
        from ..serialization import save_ndarrays

        out = self.trace_symbol(*input_names)
        if isinstance(out, (tuple, list)):
            out = _sym.Group(list(out))
        out.save(f"{path}-symbol.json")
        fname = f"{path}-{epoch:04d}.params"
        save_ndarrays(fname, {"arg:" + p.name: p._var.detach()
                              for p in self.collect_params().values()
                              if p._var is not None})
        return f"{path}-symbol.json", fname


class SymbolBlock(Block):
    """A block that runs a Symbol graph (MXNet's deploy path,
    ``SymbolBlock.imports(symbol_file, ['data'], param_file)``). Every
    argument of the graph that is not an input is a Gluon
    :class:`Parameter` of this block (named as in the graph, registered
    as a torch parameter of the module), so ``collect_params()``, a
    ``gluon.Trainer`` and a ``TrainStep`` train it. The graph is
    evaluated op by op through the registry (:func:`symbol.eval_symbol`)."""

    def __init__(self, outputs, inputs, params=None, ctx=None):
        super().__init__(prefix="symbolblock_", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(list(outputs))
        self._out_symbol = outputs
        self._input_names = [i.name if isinstance(i, _sym.Symbol) else i
                             for i in (inputs if isinstance(inputs,
                                                            (list, tuple))
                                       else [inputs])]
        device = None
        for name in outputs.list_arguments():
            if name in self._input_names:
                continue
            p = Parameter(name, allow_deferred_init=True)
            self._params._params[name] = p
            p._attach_owner(self, name.replace(".", "_"))
            if params and name in params:
                device = device or _as_device(ctx)
                value = params[name]
                value = value._data if isinstance(value, NDArray) else value
                p._shape = tuple(value.shape)
                p._write(torch.as_tensor(value), device)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file`` with the ``arg:``/``aux:``
        values of ``param_file``, on ``ctx`` (the current context, the
        card, by default)."""
        from ..serialization import load_tensors

        out = _sym.load(symbol_file)
        params = {}
        if param_file:
            params = {k.removeprefix("arg:").removeprefix("aux:"): v
                      for k, v in load_tensors(param_file).items()}
        if isinstance(input_names, str):
            input_names = [input_names]
        return SymbolBlock(out, input_names, params, ctx=ctx)

    def forward(self, *args):
        env = dict(zip(self._input_names, args))
        for name, p in self._params.items():
            if p._var is not None:
                env[name] = p._var
        return _sym.eval_symbol(self._out_symbol, env)

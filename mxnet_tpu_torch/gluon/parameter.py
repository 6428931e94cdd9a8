"""Parameter / Constant / ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``. A :class:`Parameter`
holds one ``torch.nn.Parameter`` (its *variable*, :meth:`Parameter.tensor`;
:meth:`Parameter.var` is its Symbol variable, as in MXNet), which every
block that declared it registers as its own torch parameter under the
declaring attribute's name, so ``state_dict``, ``named_parameters``,
``TrainStep`` and the generation engine see exactly the tensors that Gluon
sees. A block attribute (``dense.weight``) is that tensor, as in PyTorch;
the Parameter itself is reached through ``block.params``,
``collect_params()`` or ``_collect_params_with_prefix()``.

``grad_req`` maps to the variable: ``"null"`` is ``requires_grad=False``,
``"write"``/``"add"`` are kept by ``autograd.backward``. ``lr_mult`` and
``wd_mult`` live on the variable too (where ``TrainStep`` reads them).
A shape with a 0 is deferred: the variable is made at the first forward
(``HybridBlock.infer_shape``). The values are drawn by :meth:`initialize`
(or set by :meth:`set_data` / ``load_parameters``); a variable allocated
before that holds uninitialised memory.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from .. import autograd as _ag
from .. import initializer as init_mod
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import as_device

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


_STYPES = ("default", "row_sparse", "csr")


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self._dtype = dtype_name(dtype)
        self._lr_mult = lr_mult
        self._wd_mult = wd_mult
        self.init = init
        self._grad_req = grad_req if differentiable else "null"
        self.allow_deferred_init = allow_deferred_init
        for what, st in (("stype", stype), ("grad_stype", grad_stype)):
            if st not in _STYPES:
                raise MXNetError(f"Parameter {name}: unknown {what} {st!r}")
        # storage types: the values stay dense; grad_stype "row_sparse"
        # makes gluon.Trainer hand the optimizer the gradient's rows in
        # _sparse_rows (recorded by the layer that reads the parameter,
        # Embedding(sparse_grad=True)) as a RowSparseNDArray: a lazy update
        self.stype = stype
        self.grad_stype = grad_stype
        #: the sorted int32 rows recorded forwards touched since the last
        #: update (a tensor on the parameter's device), or None
        self._sparse_rows = None
        self._var = None
        self._sym_var = None
        self._initialized = False
        self._deferred_init = None
        # (block, attribute name) of every block that declared this one
        self._owners = []
        # an f32 copy kept by cast() for a multi-precision master
        self._f32_source = None
        #: a layer's state (BatchNorm's moving statistics): never trained,
        #: written by the layer's forward (``block.record_state_update``),
        #: and read in its own dtype under ``TrainStep``'s AMP
        self.is_state = False

    # -- the variable and its owners ------------------------------------------
    @property
    def shape(self):
        if self._var is not None:
            return tuple(self._var.shape)
        return self._shape

    @shape.setter
    def shape(self, value):
        if self._var is not None and tuple(value) != tuple(self._var.shape):
            raise MXNetError(f"Parameter {self.name} already has shape "
                             f"{tuple(self._var.shape)}")
        self._shape = tuple(value)

    @property
    def dtype(self):
        return self._dtype

    @dtype.setter
    def dtype(self, value):
        self.cast(value)

    def _known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def _attach_owner(self, block, attr):
        self._owners.append((weakref.ref(block), attr))
        block._parameters[attr] = self._var

    def _set_var(self, var):
        self._var = var
        var.lr_mult = self._lr_mult
        var.wd_mult = self._wd_mult
        _ag.attach(var, self._grad_req)
        live = []
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._parameters[attr] = var
                live.append((ref, attr))
        self._owners = live

    def _alloc(self, device):
        """Make the variable (uninitialised) on ``device`` if the shape is
        known and it does not exist yet."""
        if self._var is None and self._known():
            self._set_var(torch.nn.Parameter(torch.empty(
                self._shape, dtype=dtype_torch(self._dtype),
                device=as_device(device))))

    def tensor(self) -> torch.nn.Parameter:
        """The ``torch.nn.Parameter`` (raises before it exists)."""
        if self._var is None:
            self.data()
        return self._var

    def var(self):
        """The parameter's Symbol variable, ``symbol.var(name, shape=,
        dtype=)``, made once (what a symbolic trace of a block reads)."""
        from .. import symbol

        if self._sym_var is None:
            self._sym_var = symbol.var(self.name, shape=self.shape,
                                       dtype=self.dtype)
        return self._sym_var

    # -- attributes kept on the variable --------------------------------------
    @property
    def grad_req(self):
        if self._var is not None and not self._var.requires_grad:
            return "null"
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError(f"grad_req must be 'write', 'add' or 'null', "
                             f"got {req!r}")
        self._grad_req = req
        if self._var is not None:
            _ag.attach(self._var, req)
            if req == "null":
                self._var.grad = None

    @property
    def lr_mult(self):
        return getattr(self._var, "lr_mult", self._lr_mult) \
            if self._var is not None else self._lr_mult

    @lr_mult.setter
    def lr_mult(self, value):
        self._lr_mult = value
        if self._var is not None:
            self._var.lr_mult = value

    @property
    def wd_mult(self):
        return getattr(self._var, "wd_mult", self._wd_mult) \
            if self._var is not None else self._wd_mult

    @wd_mult.setter
    def wd_mult(self, value):
        self._wd_mult = value
        if self._var is not None:
            self._var.wd_mult = value

    # -- init ---------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Draw the values (``self.init``, else ``init``, else
        ``default_init``, else ``Uniform()``) on ``ctx`` (default: where
        the variable already is, else the current context, ``gpu(0)``
        unless a ``with mx.cpu():`` scope says otherwise). A deferred shape
        waits for the first forward."""
        if self._initialized and not force_reinit:
            return
        ini = self.init or init or default_init or init_mod.Uniform()
        if isinstance(ini, str):
            ini = init_mod.create(ini)
        if ctx is not None or self._var is None:
            device = as_device(ctx)
        else:
            device = self._var.device
        if not self._known():
            if not self.allow_deferred_init:
                raise DeferredInitializationError(
                    f"Parameter {self.name} has unknown shape {self._shape} "
                    "and allow_deferred_init=False")
            self._deferred_init = (ini, device, generator)
            return
        self._finish_init(ini, device, generator)

    def _finish_init(self, ini, device, generator):
        data = ini.init_for_name(self.name, self._shape, generator)
        self._write(data, device)
        self._deferred_init = None

    def _write(self, data, device=None):
        """Copy ``data`` into the variable (made on ``device`` when there
        is none, moved there when it lies elsewhere)."""
        device = device if device is not None else (
            self._var.device if self._var is not None else as_device(None))
        if self._var is None:
            self._alloc(device)
        elif self._var.device != device:
            self._var.data = self._var.data.to(device)
        with torch.no_grad():
            self._var.copy_(data.to(device=device, dtype=self._var.dtype))
        self._initialized = True
        self._f32_source = None

    def _finish_deferred_init(self, inferred_shape):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"Parameter {self.name} used before initialization; call "
                ".initialize() first")
        self._shape = tuple(i if s == 0 or s is None else s
                            for s, i in zip(self._shape or inferred_shape,
                                            inferred_shape))
        ini, device, generator = self._deferred_init
        self._finish_init(ini, device, generator)

    # -- access -------------------------------------------------------------
    def data(self, ctx=None):
        """The variable as an NDArray (no copy)."""
        from ..ndarray import NDArray

        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name} deferred-initialized; run a "
                    "forward pass to infer its shape")
            raise MXNetError(f"Parameter {self.name} not initialized")
        return NDArray(self._var)

    def list_data(self):
        return [self.data()]

    def grad(self, ctx=None):
        """The gradient as an NDArray (zeros before the first backward)."""
        from ..ndarray import NDArray

        var = self.tensor()
        if self.grad_req == "null":
            raise MXNetError(f"Parameter {self.name} has grad_req='null'")
        if var.grad is None:
            var.grad = torch.zeros_like(var)
        return NDArray(var.grad)

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        return [self.data().context]

    def zero_grad(self):
        if self._var is not None and self._var.grad is not None:
            self._var.grad.zero_()

    def set_data(self, data):
        """Write ``data`` (an NDArray, tensor or array) into the variable,
        cast to its dtype, in place (the first write of a deferred one
        makes it with ``data``'s shape)."""
        t = data._data if hasattr(data, "_data") else data
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.array(t))
        t = t.detach()
        if self._var is None:
            self._shape = tuple(t.shape)
            device = t.device if self._deferred_init is None else \
                self._deferred_init[1]
            self._write(t, device)
            self._deferred_init = None
            return
        if tuple(t.shape) != tuple(self._var.shape):
            raise MXNetError(f"Parameter {self.name}: shape {tuple(t.shape)} "
                             f"does not match {tuple(self._var.shape)}")
        self._write(t)

    def cast(self, dtype):
        """Cast in place: the variable object stays, with new storage. A
        float32 variable cast to bfloat16/float16 keeps its f32 values for
        a multi-precision optimizer's master (taken once, by the Trainer)."""
        name = dtype_name(dtype)
        self._dtype = name
        var = self._var
        if var is None:
            return
        new = dtype_torch(name)
        if var.dtype == new:
            return
        old = var.data
        var.data = old.to(new)
        self._f32_source = (old, var._version) if old.dtype == \
            torch.float32 and new in (torch.bfloat16, torch.float16) else None
        if var.grad is not None:
            var.grad = var.grad.to(new)

    def take_f32_source(self):
        """The f32 values :meth:`cast` kept, if nothing wrote the variable
        since (else None); given away once."""
        src, self._f32_source = self._f32_source, None
        if src is None or self._var is None or src[1] != self._var._version:
            return None
        return src[0]

    def reset_ctx(self, ctx):
        if self._var is not None:
            self._var.data = self._var.data.to(as_device(ctx))

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, dtype={self.dtype})"


class Constant(Parameter):
    """A parameter with a fixed value and no gradient."""

    def __init__(self, name, value):
        t = value._data if hasattr(value, "_data") else value
        t = t.detach() if torch.is_tensor(t) else \
            torch.from_numpy(np.array(value, np.float32))
        self.value = t

        class _CInit(init_mod.Initializer):
            def init_for_name(self, _name, _shape, _generator=None):
                return t

        super().__init__(name, grad_req="null", shape=tuple(t.shape),
                         dtype=t.dtype, init=_CInit())


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    @staticmethod
    def _check_shared(p, name, kwargs):
        want = kwargs.get("shape")
        if want is not None and p.shape is not None:
            if tuple(want) != tuple(p.shape) and 0 not in tuple(want):
                raise ValueError(
                    f"shared parameter {p.name} has shape {p.shape}, but "
                    f"'{name}' is declared with shape {tuple(want)}")
        return p

    def get(self, name, **kwargs):
        """Create or retrieve ``prefix + name`` (a block's declaration); a
        shared dict is searched by the full name, then by the unprefixed
        one under its own prefix (tied weights)."""
        raw = name
        name = self._prefix + name
        if name in self._params:
            return self._params[name]
        if self._shared is not None:
            if name in self._shared:
                self._params[name] = self._check_shared(
                    self._shared[name], name, kwargs)
                return self._params[name]
            alt = getattr(self._shared, "prefix", "") + raw
            if alt in self._shared:
                self._params[name] = self._check_shared(
                    self._shared[alt], name, kwargs)
                return self._params[name]
        p = Parameter(name, **kwargs)
        self._params[name] = p
        return p

    def get_constant(self, name, value=None):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = Constant(name, value)
        return self._params[name]

    def pop(self, name, default=None):
        return self._params.pop(name, default)

    def update(self, other):
        for k, v in other.items():
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=init, ctx=ctx, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            if p.grad_req != "null":
                p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def cast(self, dtype):
        for p in self.values():
            p.cast(dtype)

    def __repr__(self):
        lines = "\n".join(f"  {p!r}" for p in self.values())
        return f"ParameterDict (\n{lines}\n)"


"""``mx.nd``: the imperative NDArray API over ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``. An :class:`NDArray`
wraps one tensor with no copy (``nd.array(t)`` of a tensor, ``.detach()``
and ``as_in_context`` to its own device share storage), and the op
namespace is generated from the registry (``mxnet_tpu_torch/registry.py``)
at import, as MXNet generates ``mx.nd.*``.

Each generated function is also the ``F`` of ``HybridBlock.hybrid_forward``:
given NDArrays it returns NDArrays and runs with PyTorch's grad mode set by
``autograd.record`` (recorded inside it, no graph outside it); given
tensors (inside a block's forward, where tensors flow) it returns tensors
and leaves the grad mode as it is. Creation functions without a tensor
argument return NDArrays, except inside a block's forward.

Writes (``x[:] = v``, ``copyto``, ``+=``) go into the tensor in place,
as MXNet's engine writes into the array's buffer; the JAX package rebinds
the handle instead. bfloat16 arrays come back from ``asnumpy`` as
float32 (exact), since numpy has no bfloat16.
"""
from __future__ import annotations

import inspect
import sys
import threading
import types

import numpy as _np
import torch

from .. import autograd as _ag
from .. import ops as _ops  # noqa: F401  (populates the registry)
from .. import random as _rng
from .. import registry as _registry
from ..base import MXNetError, dtype_name, dtype_torch
from ..context import Context, as_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall", "concat", "stack", "save", "load", "zeros_like",
           "ones_like", "invoke"]

_pyslice = slice  # an op named "slice" is generated below


_TLS = threading.local()


def in_block() -> bool:
    """Whether a ``gluon.Block``'s forward is running on this thread."""
    return getattr(_TLS, "block_depth", 0) > 0


class block_scope:
    """Marks a block's forward (``gluon/block.py``): F's creation ops then
    return tensors."""

    def __enter__(self):
        _TLS.block_depth = getattr(_TLS, "block_depth", 0) + 1

    def __exit__(self, *exc):
        _TLS.block_depth -= 1


def _np_dtype(t):
    if t.dtype == torch.bfloat16:
        return torch.bfloat16
    return _np.dtype(dtype_name(t.dtype))


class NDArray:
    """A handle on one ``torch.Tensor``."""

    __slots__ = ("_data", "__weakref__")
    __array_priority__ = 100.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not torch.is_tensor(data):
            data = _from_host(data, dtype, copy=ctx is None or
                              as_device(ctx).type == "cpu")
        elif dtype is not None:
            data = data.to(dtype_torch(dtype))
        if ctx is not None:
            data = data.to(as_device(ctx))
        self._data = data

    # -- properties -----------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """A numpy dtype, or ``torch.bfloat16`` for bfloat16."""
        return _np_dtype(self._data)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        g = self._data.grad
        return None if g is None else NDArray(g)

    @property
    def T(self):
        return self.transpose()

    # -- sync and host interop -----------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()
        return self

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy (bfloat16 widened to float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()
        return t.cpu().numpy() if t.is_cuda else t.numpy().copy()

    def asscalar(self):
        return self.asnumpy().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asnumpy().reshape(()).item())
        return self.size > 0

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -- autograd -------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable of ``autograd.backward`` (its gradient
        starts at zeros). An array computed by recorded ops becomes a new
        leaf holding the same values."""
        if not self._data.is_leaf:
            self._data = self._data.detach()
        _ag.attach(self._data, grad_req)
        if grad_req != "null":
            self._data.grad = torch.zeros_like(self._data)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach())

    # -- conversion and copies -----------------------------------------------
    def astype(self, dtype, copy=True):
        return _invoke_name("cast", (self,), {"dtype": dtype})

    def copy(self):
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        """Copy into ``other`` (an NDArray of the same shape, cast to its
        dtype, in place) or onto a Context (a new array)."""
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        if other.shape != self.shape:
            raise ValueError(
                f"copyto: shape mismatch {self.shape} vs {other.shape}")
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def as_in_context(self, ctx):
        """This array on ``ctx`` (itself when it is there already)."""
        dev = as_device(ctx)
        if self._data.device == dev:
            return self
        return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("sparse storage types are not ported")
        return self

    # -- indexing --------------------------------------------------------------
    def __getitem__(self, key):
        key = _raw_index(key)
        with torch.set_grad_enabled(_ag.is_recording()):
            return NDArray(self._data[key])

    def __setitem__(self, key, value):
        value = _raw(value)
        with torch.no_grad():
            if isinstance(key, _pyslice) and key == _pyslice(None):
                self._data.copy_(torch.as_tensor(value).expand_as(self._data))
            else:
                self._data[_raw_index(key)] = torch.as_tensor(
                    value, dtype=self._data.dtype, device=self._data.device)

    # -- arithmetic (through the registry) ------------------------------------
    def _binop(self, other, op, scalar_op, reverse=False):
        if _is_arr(other):
            o = other if isinstance(other, NDArray) else NDArray(
                torch.as_tensor(_np.asarray(other),
                                device=self._data.device))
            a, b = (o, self) if reverse else (self, o)
            return _invoke_name(op, (a, b), {})
        return _invoke_name(scalar_op, (self,), {"scalar": other})

    def __add__(self, o): return self._binop(o, "add", "_plus_scalar")
    __radd__ = __add__
    def __sub__(self, o): return self._binop(o, "subtract", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "subtract", "_rminus_scalar", reverse=True)
    def __mul__(self, o): return self._binop(o, "multiply", "_mul_scalar")
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binop(o, "divide", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "divide", "_rdiv_scalar", reverse=True)
    def __mod__(self, o): return self._binop(o, "mod", "_mod_scalar")
    def __pow__(self, o): return self._binop(o, "power", "_power_scalar")
    def __rpow__(self, o): return _invoke_name("_rpower_scalar", (self,), {"scalar": o})
    def __matmul__(self, o): return _invoke_name("dot", (self, _as_nd(o, self)), {})
    def __neg__(self): return _invoke_name("negative", (self,), {})
    def __abs__(self): return _invoke_name("abs", (self,), {})

    def _inplace(self, o, fn):
        with torch.no_grad():
            fn(self._data, _raw(o))
        return self

    def __iadd__(self, o): return self._inplace(o, torch.Tensor.add_)
    def __isub__(self, o): return self._inplace(o, torch.Tensor.sub_)
    def __imul__(self, o): return self._inplace(o, torch.Tensor.mul_)
    def __itruediv__(self, o): return self._inplace(o, torch.Tensor.div_)

    def _cmp(self, o, name):
        return _invoke_name(name, (self, _as_nd(o, self)), {})

    def __eq__(self, o): return self._cmp(o, "equal")
    def __ne__(self, o): return self._cmp(o, "not_equal")
    def __gt__(self, o): return self._cmp(o, "greater")
    def __ge__(self, o): return self._cmp(o, "greater_equal")
    def __lt__(self, o): return self._cmp(o, "lesser")
    def __le__(self, o): return self._cmp(o, "lesser_equal")

    def __hash__(self):
        return id(self)

    # -- method forms of common ops --------------------------------------------
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _invoke_name("reshape", (self,), {"shape": shape, **kw})

    def reshape_like(self, other):
        return _invoke_name("reshape_like", (self, other), {})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _invoke_name("transpose", (self,), {"axes": axes or None})

    def flatten(self): return _invoke_name("flatten", (self,), {})
    def expand_dims(self, axis): return _invoke_name("expand_dims", (self,), {"axis": axis})
    def squeeze(self, axis=None): return _invoke_name("squeeze", (self,), {"axis": axis})
    def sum(self, axis=None, keepdims=False): return _invoke_name("sum", (self,), {"axis": axis, "keepdims": keepdims})
    def mean(self, axis=None, keepdims=False): return _invoke_name("mean", (self,), {"axis": axis, "keepdims": keepdims})
    def max(self, axis=None, keepdims=False): return _invoke_name("max", (self,), {"axis": axis, "keepdims": keepdims})
    def min(self, axis=None, keepdims=False): return _invoke_name("min", (self,), {"axis": axis, "keepdims": keepdims})
    def prod(self, axis=None, keepdims=False): return _invoke_name("prod", (self,), {"axis": axis, "keepdims": keepdims})
    def argmax(self, axis=None): return _invoke_name("argmax", (self,), {"axis": axis})
    def argmin(self, axis=None): return _invoke_name("argmin", (self,), {"axis": axis})
    def norm(self, ord=2, axis=None, keepdims=False): return _invoke_name("norm", (self,), {"ord": ord, "axis": axis, "keepdims": keepdims})
    def dot(self, other, **kw): return _invoke_name("dot", (self, other), kw)
    def clip(self, a_min, a_max): return _invoke_name("clip", (self,), {"a_min": a_min, "a_max": a_max})
    def abs(self): return _invoke_name("abs", (self,), {})
    def sqrt(self): return _invoke_name("sqrt", (self,), {})
    def square(self): return _invoke_name("square", (self,), {})
    def exp(self): return _invoke_name("exp", (self,), {})
    def log(self): return _invoke_name("log", (self,), {})
    def tanh(self): return _invoke_name("tanh", (self,), {})
    def sigmoid(self): return _invoke_name("sigmoid", (self,), {})
    def relu(self): return _invoke_name("relu", (self,), {})
    def softmax(self, axis=-1): return _invoke_name("softmax", (self,), {"axis": axis})
    def log_softmax(self, axis=-1): return _invoke_name("log_softmax", (self,), {"axis": axis})
    def slice_axis(self, axis, begin, end): return _invoke_name("slice_axis", (self,), {"axis": axis, "begin": begin, "end": end})
    def take(self, indices, axis=0, mode="clip"): return _invoke_name("take", (self, indices), {"axis": axis, "mode": mode})
    def one_hot(self, depth, **kw): return _invoke_name("one_hot", (self,), {"depth": depth, **kw})
    def tile(self, reps): return _invoke_name("tile", (self,), {"reps": reps})
    def repeat(self, repeats, axis=None): return _invoke_name("repeat", (self,), {"repeats": repeats, "axis": axis})
    def broadcast_to(self, shape): return _invoke_name("broadcast_to", (self,), {"shape": shape})
    def broadcast_like(self, other): return _invoke_name("broadcast_like", (self, other), {})
    def swapaxes(self, dim1, dim2): return _invoke_name("swapaxes", (self,), {"dim1": dim1, "dim2": dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke_name("split", (self,), {"num_outputs": num_outputs, "axis": axis, "squeeze_axis": squeeze_axis})

    def zeros_like(self): return _invoke_name("zeros_like", (self,), {})
    def ones_like(self): return _invoke_name("ones_like", (self,), {})
    def sign(self): return _invoke_name("sign", (self,), {})
    def round(self): return _invoke_name("round", (self,), {})
    def topk(self, **kw): return _invoke_name("topk", (self,), kw)
    def sort(self, **kw): return _invoke_name("sort", (self,), kw)
    def argsort(self, **kw): return _invoke_name("argsort", (self,), kw)


def _raw(x):
    return x._data if isinstance(x, NDArray) else x


def _raw_all(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_raw(v) for v in x)
    return _raw(x)


def _is_arr(o):
    return isinstance(o, (NDArray, _np.ndarray)) or torch.is_tensor(o)


def _as_nd(o, like):
    if isinstance(o, NDArray):
        return o
    return NDArray(torch.as_tensor(_np.asarray(o) if not torch.is_tensor(o)
                                   else o, device=like._data.device))


def _raw_index(key):
    if isinstance(key, NDArray):
        t = key._data
        return t.long() if t.is_floating_point() else t
    if isinstance(key, tuple):
        return tuple(_raw_index(k) for k in key)
    return key


def _from_host(source, dtype=None, copy=False):
    """A CPU tensor of host data, with MXNet's dtype rules: float64 becomes
    float32, int64 int32 (checked to fit, as the JAX package's
    ``as_index_array``). With ``copy`` it never shares memory with
    ``source``, as MXNet's ``nd.array`` copies (an in-place write must not
    reach the caller's numpy array); without, it may, for a caller that
    copies it anyway (to the card, or into pinned memory)."""
    a = _np.asarray(source)
    if dtype is not None:
        name = dtype_name(dtype)
        if name == "bfloat16":
            return torch.from_numpy(_np.array(a, _np.float32)).to(
                torch.bfloat16)
        a = _np.array(a, dtype=_np.dtype(name))
    elif a.dtype == _np.float64:
        a = a.astype(_np.float32)
    if a.dtype in (_np.dtype(_np.int64), _np.dtype(_np.uint64)) and \
            (dtype is None or dtype_name(dtype) == "int64"):
        info = _np.iinfo(_np.int32)
        if a.size and (a.max() > info.max or a.min() < info.min):
            raise MXNetError("nd.array int64: values exceed the int32 range")
        a = a.astype(_np.int32)
    if copy and _np.may_share_memory(a, source):
        a = a.copy()
    return torch.from_numpy(_np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# op invocation
# ---------------------------------------------------------------------------
def _wrap(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return NDArray(out) if torch.is_tensor(out) else out


def _mark_implicit(args):
    """Plain floating leaves fed to a recorded op become differentiable,
    as every array is to the JAX tape (``autograd.grad`` may name one that
    was never attached); attached leaves and parameters keep their
    ``grad_req``."""
    for a in args:
        if isinstance(a, NDArray):
            t = a._data
            if t.is_leaf and not t.requires_grad and t.is_floating_point() \
                    and not hasattr(t, "_mx_grad_req"):
                t.requires_grad_(True)


def invoke(opdef, args, kwargs):
    """Run ``opdef`` on NDArrays (NDArrays out, grad mode from
    ``autograd``) or on tensors (tensors out, grad mode untouched)."""
    has_nd = any(isinstance(a, NDArray) for a in args) or \
        any(isinstance(v, NDArray) for v in kwargs.values())
    if not has_nd:
        out = opdef.fn(*args, **kwargs)
        if in_block() or any(torch.is_tensor(a) for a in args):
            return out
        return _wrap(out)
    raw_args = [_raw(a) for a in args]
    kwargs = {k: _raw(v) for k, v in kwargs.items()}
    recording = _ag.is_recording()
    if recording:
        _mark_implicit(args)
    with torch.set_grad_enabled(recording):
        out = opdef.fn(*raw_args, **kwargs)
    return _wrap(out)


def _invoke_name(name, args, kwargs):
    return invoke(_registry.get(name), args, kwargs)


def _takes_ctx(fn):
    try:
        return "ctx" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # a builtin without a signature
        return False


def _make_op_func(name):
    opdef = _registry.get(name)
    # the creation operators and the samplers that take no tensor: ``ctx=``
    # names their device
    creation = _takes_ctx(opdef.fn)

    def fn(*args, **kwargs):
        ctx = kwargs.pop("ctx", None)
        out = kwargs.pop("out", None)
        if creation:
            kwargs["ctx"] = ctx
        res = invoke(opdef, args, kwargs)
        if out is None:
            return res
        write_back = getattr(opdef.fn, "write_back", None)
        if write_back is not None:
            # an update op: the new weights into out, the new states into
            # the state arguments (``ops/optimizer_ops.py``)
            write_back([_raw(a) for a in args], _raw_all(res),
                       [_raw(o) for o in out] if isinstance(out, (list, tuple))
                       else _raw(out))
            return out
        with torch.no_grad():
            out._data.copy_(_raw(res))
        return out

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = opdef.doc
    return fn


_g = globals()
for _name in _registry.list_ops():
    if _name not in _g:
        _g[_name] = _make_op_func(_name)


def Custom(*args, op_type=None, **kwargs):
    """Run a registered user-defined operator (``mx.operator``)."""
    from ..operator import make_custom_fn

    if op_type is None:
        raise MXNetError("nd.Custom requires op_type=")
    fn, nout = make_custom_fn(op_type, kwargs)
    opdef = _registry.OpDef(name=f"Custom:{op_type}", fn=fn, nout=nout)
    return invoke(opdef, args, {})


def __getattr__(name):  # ops registered after import
    try:
        return _make_op_func(name)
    except AttributeError:
        raise AttributeError(f"module 'mx.nd' has no attribute {name!r}") \
            from None


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx=None, dtype=None):
    """An NDArray of ``source_array`` on ``ctx``. Host data goes to the
    current context when ``ctx`` is None; an NDArray or tensor stays where
    it is, and is wrapped with no copy when dtype and device already
    match."""
    if isinstance(source_array, NDArray):
        source_array = source_array._data
    if torch.is_tensor(source_array):
        t = source_array if dtype is None else \
            source_array.to(dtype_torch(dtype))
        return NDArray(t if ctx is None else t.to(as_device(ctx)))
    device = as_device(ctx)
    return NDArray(_from_host(source_array, dtype,
                              copy=device.type == "cpu").to(device))


def zeros(shape, ctx=None, dtype="float32"):
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                               device=as_device(ctx)))


def ones(shape, ctx=None, dtype="float32"):
    return NDArray(torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                              device=as_device(ctx)))


def full(shape, val, ctx=None, dtype="float32"):
    return NDArray(torch.full(_shape(shape), val, dtype=dtype_torch(dtype),
                              device=as_device(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    from ..ops import core as _core

    return NDArray(_core.arange(start, stop, step, repeat, dtype,
                                device=as_device(ctx)))


def zeros_like(a):
    return _invoke_name("zeros_like", (a,), {})


def ones_like(a):
    return _invoke_name("ones_like", (a,), {})


def waitall():
    """Wait for all work queued on the card (``MXNDArrayWaitAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(fname, data):
    """``mx.nd.save``: a dict of NDArrays, a list, or one NDArray, as a
    ``.params`` file (bfloat16 stored as bfloat16)."""
    from ..serialization import save_ndarrays

    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        data = {k: _raw(v) for k, v in data.items()}
    else:
        data = [_raw(v) for v in data]
    save_ndarrays(fname, data)


def load(fname):
    """``mx.nd.load``: a dict (or a list) of NDArrays on the CPU, the
    context a ``.params`` file records; bfloat16 arrays come back as
    bfloat16."""
    from ..serialization import load_tensors

    loaded = load_tensors(fname)
    if isinstance(loaded, dict):
        return {k: NDArray(v) for k, v in loaded.items()}
    return [NDArray(v) for v in loaded]


# ---------------------------------------------------------------------------
# mx.nd.random
# ---------------------------------------------------------------------------
random = types.ModuleType(__name__ + ".random")
random.uniform = _make_op_func("_random_uniform")
random.normal = _make_op_func("_random_normal")
random.randint = _make_op_func("_random_randint")
random.gamma = _make_op_func("_random_gamma")
random.exponential = _make_op_func("_random_exponential")
random.poisson = _make_op_func("_random_poisson")
random.multinomial = _make_op_func("_sample_multinomial")
random.shuffle = _make_op_func("shuffle")
random.seed = _rng.seed
sys.modules[random.__name__] = random

# ---------------------------------------------------------------------------
# mx.nd.contrib (the ``_contrib_`` ops, and the control-flow operators) and
# mx.nd.linalg (``nd.linalg.gemm2`` is ``linalg_gemm2``)
# ---------------------------------------------------------------------------
contrib = types.ModuleType(__name__ + ".contrib")
contrib.__getattr__ = lambda name: _make_op_func("_contrib_" + name)
from ..control_flow import cond as _cf_cond  # noqa: E402
from ..control_flow import foreach as _cf_foreach  # noqa: E402
from ..control_flow import while_loop as _cf_while_loop  # noqa: E402

contrib.foreach = _cf_foreach
contrib.while_loop = _cf_while_loop
contrib.cond = _cf_cond
sys.modules[contrib.__name__] = contrib

linalg = types.ModuleType(__name__ + ".linalg")
linalg.__getattr__ = lambda name: _make_op_func("linalg_" + name)
sys.modules[linalg.__name__] = linalg

"""``mx.sym``: the lazy Symbol graph over the port's op registry.

Counterpart of ``mxnet_tpu/symbol/__init__.py`` (MXNet's nnvm ``Symbol``
and ``GraphExecutor``). A :class:`Symbol` is a DAG of named registry ops
and variables; its JSON (``tojson``/``save``/``load``) is the JAX
package's node list (``op``, ``name``, ``attrs``, ``_raw_attrs``,
``inputs``, ``heads``, ``mxnet_tpu_version``), so a ``symbol.json`` written
by either package loads in the other.

Evaluation is eager: the graph runs op by op through the registry on the
tensors it is given (the executor's context, the card by default), so the
ops that have a hand-written kernel (``LayerNorm``,
``multi_head_attention``) launch it, and gradients come from
``torch.autograd``. Shape inference runs the ops on fake CPU tensors
(``FakeTensorMode``: shapes and dtypes, no data, nothing on the card),
where the JAX package calls ``jax.eval_shape``.
Graph walks are iterative: an unrolled recurrent graph is deeper than
Python's recursion limit.
"""
from __future__ import annotations

import contextlib
import json
import numbers
import threading as _threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import registry as _registry
from ..base import MXNetError
from ..context import Context, as_device
from ..ndarray import NDArray

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "Executor", "eval_symbol", "zeros", "ones", "linspace", "Custom"]


class Symbol:
    def __init__(self, op, inputs: List["Symbol"], kwargs: dict, name: str,
                 nout: int = 1, out_index: int = 0, sliced: bool = False):
        self._op = op  # None for variables
        self._inputs = inputs
        self._kwargs = kwargs
        self._name = name
        self._nout = nout
        self._out_index = out_index
        # a "sliced" symbol selects ONE output of a multi-output node (bn[1]);
        # an unsliced multi-output symbol exposes all its outputs
        self._sliced = sliced or nout == 1

    # -- composition ---------------------------------------------------------
    @property
    def name(self):
        return self._name

    def list_arguments(self):
        seen, order = set(), []
        for s in _postorder([self]):
            if s._op is None and s._name not in seen:
                seen.add(s._name)
                order.append(s._name)
        return order

    def list_outputs(self):
        """Output names: variables are their own name, op outputs are
        ``<name>_output`` (``<name>_output<i>`` for multi-output ops),
        groups concatenate."""
        if self._op is None:
            return [self._name]
        if self._op == "_group":
            return [n for i in self._inputs for n in i.list_outputs()]
        if self._nout == 1:
            return [f"{self._name}_output"]
        if self._sliced:
            return [f"{self._name}_output{self._out_index}"]
        return [f"{self._name}_output{i}" for i in range(self._nout)]

    def list_auxiliary_states(self):
        return []

    def _topo_nodes(self):
        return _postorder([self])

    def get_internals(self):
        """Group over every node of the graph in topological order, each
        selectable by output name and bindable as an executor head
        (``sym.get_internals()['flatten0_output']``)."""
        nodes = [n for n in self._topo_nodes() if n._op != "_group"]
        return Symbol("_group", nodes, {}, f"{self._name}_internals",
                      nout=len(nodes))

    def __getitem__(self, i):
        if isinstance(i, str):
            names = self.list_outputs()
            if i not in names:
                raise MXNetError(
                    f"output {i!r} not found; candidates: {names}")
            i = names.index(i)
        if self._op == "_group":
            total = len(self.list_outputs())
            if i < 0:
                i += total
            if not 0 <= i < total:
                raise MXNetError(
                    f"group output index {i} out of range ({total})")
            for inp in self._inputs:
                n = len(inp.list_outputs())
                if i < n:
                    return inp[i] if (inp._nout > 1 and not inp._sliced) \
                        else inp
                i -= n
        if isinstance(i, int) and self._nout > 1 and not self._sliced:
            if i < 0:
                i += self._nout
            if not 0 <= i < self._nout:
                raise MXNetError(
                    f"output index {i} out of range ({self._nout})")
            return Symbol(self._op, self._inputs, self._kwargs, self._name,
                          self._nout, i, sliced=True)
        return self

    def __iter__(self):
        # tuple-unpacking of multi-output ops: out, mean, var = F.BatchNorm(...)
        if self._op == "_group":
            return iter(self[i] for i in range(len(self.list_outputs())))
        if self._nout > 1 and not self._sliced:
            return iter(self[i] for i in range(self._nout))
        raise TypeError("single-output Symbol is not iterable")

    # -- arithmetic ----------------------------------------------------------
    def _bin(self, other, opname, scalar_op):
        if isinstance(other, Symbol):
            return _apply(opname, [self, other], {})
        return _apply(scalar_op, [self], {"scalar": other})

    def __add__(self, o): return self._bin(o, "add", "_plus_scalar")
    __radd__ = __add__
    def __sub__(self, o): return self._bin(o, "subtract", "_minus_scalar")
    def __rsub__(self, o): return _apply("_rminus_scalar", [self], {"scalar": o})
    def __mul__(self, o): return self._bin(o, "multiply", "_mul_scalar")
    __rmul__ = __mul__
    def __truediv__(self, o): return self._bin(o, "divide", "_div_scalar")
    def __rtruediv__(self, o): return _apply("_rdiv_scalar", [self], {"scalar": o})
    def __pow__(self, o): return self._bin(o, "power", "_power_scalar")
    def __neg__(self): return _apply("negative", [self], {})
    # comparisons give 0/1 arrays like MXNet's broadcast_* ops
    def __lt__(self, o): return self._bin(o, "lesser", "_lesser_scalar")
    def __le__(self, o): return self._bin(o, "lesser_equal", "_lesser_equal_scalar")
    def __gt__(self, o): return self._bin(o, "greater", "_greater_scalar")
    def __ge__(self, o): return self._bin(o, "greater_equal", "_greater_equal_scalar")

    def __eq__(self, o):
        if isinstance(o, (Symbol, numbers.Number)):
            return self._bin(o, "equal", "_equal_scalar")
        return NotImplemented

    def __ne__(self, o):
        if isinstance(o, (Symbol, numbers.Number)):
            return self._bin(o, "not_equal", "_not_equal_scalar")
        return NotImplemented

    __hash__ = object.__hash__  # __eq__ override must not break dict keys

    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _apply("reshape", [self], {"shape": shape})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _apply("transpose", [self], {"axes": axes or None})

    def sum(self, axis=None, keepdims=False): return _apply("sum", [self], {"axis": axis, "keepdims": keepdims})
    def mean(self, axis=None, keepdims=False): return _apply("mean", [self], {"axis": axis, "keepdims": keepdims})
    def max(self, axis=None, keepdims=False): return _apply("max", [self], {"axis": axis, "keepdims": keepdims})
    def flatten(self): return _apply("flatten", [self], {})
    def expand_dims(self, axis): return _apply("expand_dims", [self], {"axis": axis})
    def squeeze(self, axis=None): return _apply("squeeze", [self], {"axis": axis})
    def swapaxes(self, dim1, dim2): return _apply("swapaxes", [self], {"dim1": dim1, "dim2": dim2})
    def slice_axis(self, axis, begin, end): return _apply("slice_axis", [self], {"axis": axis, "begin": begin, "end": end})
    def astype(self, dtype): return _apply("cast", [self], {"dtype": str(dtype)})
    def softmax(self, axis=-1): return _apply("softmax", [self], {"axis": axis})
    def log_softmax(self, axis=-1): return _apply("log_softmax", [self], {"axis": axis})

    def __repr__(self):
        return f"<Symbol {self._name}>"

    # -- evaluation ----------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Evaluate on the given arrays (NDArrays stay where they are; host
        data goes to ``ctx``, the current context by default)."""
        from ..ndarray import array

        env = {k: v._data if isinstance(v, NDArray) else
               array(v, ctx=ctx)._data for k, v in kwargs.items()}
        with torch.no_grad():
            out = _evaluate(self, env, _call_op)
        return [NDArray(o) for o in (out if isinstance(out, tuple)
                                     else (out,))]

    def infer_shape(self, **kwargs):
        """Shape inference: unknown parameter shapes are solved from the
        data shapes by per-op hints (the analog of MXNet's bidirectional
        FInferShape pass), then the graph runs on fake tensors."""
        args = self.list_arguments()
        known = {k: tuple(v) for k, v in kwargs.items()}
        shapes = _infer_shapes_partial(self, known)
        arg_shapes = [shapes.get(a) for a in args]
        if any(s is None for s in arg_shapes):
            return None, None, None
        with _shape_pass():
            env = {a: _fake(shapes[a]) for a in args}
            out = _evaluate(self, env, _call_op)
        out = out if isinstance(out, tuple) else (out,)
        return arg_shapes, [tuple(o.shape) for o in out], []

    def infer_type(self, **kwargs):
        return None, [np.float32], []

    # -- binding -------------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        """An executor with every argument made as zeros on ``ctx`` (the
        current context by default), missing shapes inferred from the
        given ones."""
        known = {k: tuple(v) for k, v in shapes.items()}
        inferred = _infer_shapes_partial(self, dict(known))
        device = as_device(ctx)
        args = {}
        for name in self.list_arguments():
            # membership, not truthiness: an explicit scalar shape () must
            # win over (or instead of) the inferred shape
            shp = known[name] if name in known else inferred.get(name)
            if shp is None:
                raise MXNetError(f"simple_bind: missing shape for {name}")
            args[name] = NDArray(torch.zeros(tuple(shp), dtype=torch.float32,
                                             device=device))
        return Executor(self, args, grad_req, ctx=device)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None):
        if isinstance(args, (list, tuple)):
            args = dict(zip(self.list_arguments(), args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self.list_arguments(), args_grad))
        return Executor(self, dict(args), grad_req, args_grad,
                        ctx=None if ctx is None else as_device(ctx))

    # -- serialization -------------------------------------------------------
    def tojson(self):
        heads_of = self._inputs if self._op == "_group" else [self]
        index = {}
        nodes = []
        for s in _postorder(heads_of):
            op = s._op
            if isinstance(op, _registry.OpDef):
                # sym.Custom nodes carry their OpDef; the JSON records its
                # name, which load_json refuses unless the op is registered
                op = op.name
            nodes.append({
                "op": op or "null",
                "name": s._name,
                "attrs": {k: repr(v) for k, v in s._kwargs.items()},
                "_raw_attrs": _jsonable(s._kwargs),
                "inputs": [[index[id(i)], i._out_index, 0]
                           for i in s._inputs],
            })
            index[id(s)] = len(nodes) - 1
        heads = []
        for h in heads_of:
            if self._op == "_group" and h._nout > 1 and not h._sliced:
                # an unsliced multi-output head is one entry per output
                heads.extend([index[id(h)], j, 0] for j in range(h._nout))
            else:
                heads.append([index[id(h)], h._out_index, 0])
        return json.dumps({"nodes": nodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _postorder(heads):
    """The nodes reachable from ``heads``, each object once, every input
    before its consumer, inputs in order (an iterative depth-first walk)."""
    order, seen = [], set()
    stack = [(h, False) for h in reversed(heads)]
    while stack:
        s, done = stack.pop()
        if done:
            order.append(s)
            continue
        if id(s) in seen:
            continue
        seen.add(id(s))
        stack.append((s, True))
        stack.extend((i, False) for i in reversed(s._inputs)
                     if id(i) not in seen)
    return order


def _evaluate(head, env, apply):
    """Evaluate ``head`` over ``env`` (argument name -> value), each node
    once (keyed by op and name), through ``apply(opdef, inputs, kwargs)``.
    Returns one value, or a tuple for a group."""
    memo = {}

    def outputs(s):
        if s._op is None:
            if s._name not in env:
                raise MXNetError(f"unbound argument {s._name}")
            return (env[s._name],)
        return memo[(s._op, s._name)]

    def value(s):
        return outputs(s)[s._out_index]

    for s in _postorder([head]):
        if s._op is None or s._op == "_group":
            continue
        key = (s._op, s._name)
        if key not in memo:
            out = apply(_resolve_op(s._op), [value(i) for i in s._inputs],
                        dict(s._kwargs))
            memo[key] = out if isinstance(out, tuple) else (out,)
    if head._op == "_group":
        # one entry per list_outputs() name: unsliced multi-output heads
        # contribute all their outputs
        flat = []
        for i in head._inputs:
            if i._nout > 1 and not i._sliced:
                flat.extend(outputs(i))
            else:
                flat.append(value(i))
        return tuple(flat)
    return value(head)


def _call_op(opdef, inputs, kwargs):
    return opdef.fn(*inputs, **kwargs)


@contextlib.contextmanager
def _shape_pass():
    """A shape pass: CPU tensors made inside it are fake (shapes and
    dtypes, no data), so the ops, the kernel wrappers' plain versions
    included, compute nothing and nothing reaches the card; creation ops
    make theirs on the CPU; an op that reads a value raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with torch.no_grad(), Context("cpu"), \
            FakeTensorMode(allow_non_fake_inputs=True):
        yield


def _fake(shape):
    return torch.empty(tuple(shape), dtype=torch.float32)


def _jsonable(kwargs):
    out = {}
    for k, v in kwargs.items():
        if isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        elif isinstance(v, (tuple, list)):
            out[k] = list(v)
    return out


# -- partial shape inference -------------------------------------------------
# hint: (input shapes, kwargs) -> shapes for ALL inputs
def _fc_hint(shapes, kwargs):
    data = shapes[0]
    num_hidden = int(kwargs["num_hidden"])
    flatten = kwargs.get("flatten", True)
    in_units = 1
    if data is not None:
        in_units = int(np.prod(data[1:])) if flatten else data[-1]
    out = [data, (num_hidden, in_units)]
    if len(shapes) > 2:
        out.append((num_hidden,))
    return out


def _conv_hint(shapes, kwargs):
    data = shapes[0]
    nf = int(kwargs["num_filter"])
    kern = tuple(kwargs.get("kernel", (1, 1)))
    groups = int(kwargs.get("num_group", 1))
    w = (nf, (data[1] // groups) if data else 1) + kern
    out = [data, w]
    if len(shapes) > 2:
        out.append((nf,))
    return out


def _norm_hint(shapes, kwargs):
    data = shapes[0]
    axis = int(kwargs.get("axis", 1 if kwargs.get("_bn", False) else -1))
    c = data[axis] if data else 1
    return [data] + [(c,)] * (len(shapes) - 1)


def _embed_hint(shapes, kwargs):
    return [shapes[0], (int(kwargs["input_dim"]), int(kwargs["output_dim"]))]


_PARAM_SHAPE_HINTS = {
    "FullyConnected": _fc_hint,
    "Convolution": _conv_hint,
    "Embedding": _embed_hint,
    "LayerNorm": lambda s, k: _norm_hint(s, {**k}),
    "BatchNorm": lambda s, k: _norm_hint(s, {**k, "_bn": True}),
    "InstanceNorm": lambda s, k: _norm_hint(s, {**k, "_bn": True}),
}


def _infer_shapes_partial(head, known):
    """Variable shapes: the known ones, and those the op hints solve, node
    by node in topological order; each op's output shapes come from a run
    on fake tensors (None where an input is unknown or the op refuses)."""
    shapes = dict(known)  # var name -> shape
    node_out = {}  # (op, name) -> tuple of shapes, or None

    def out_shape(s):
        if s._op is None:
            return shapes.get(s._name)
        outs = node_out.get((s._op, s._name))
        return outs[s._out_index] if outs is not None else None

    for s in _postorder([head]):
        if s._op is None or s._op == "_group":
            continue
        key = (s._op, s._name)
        if key in node_out:
            continue
        in_shapes = [out_shape(i) for i in s._inputs]
        hint = _PARAM_SHAPE_HINTS.get(s._op)
        if hint is not None:
            full = hint(in_shapes, s._kwargs)
            for inp, sh in zip(s._inputs, full):
                if inp._op is None and shapes.get(inp._name) is None and sh:
                    shapes[inp._name] = tuple(int(x) for x in sh)
            in_shapes = [out_shape(i) for i in s._inputs]
        if any(sh is None for sh in in_shapes):
            node_out[key] = None
            continue
        try:
            with _shape_pass():
                outs = _call_op(_resolve_op(s._op),
                                [_fake(sh) for sh in in_shapes],
                                dict(s._kwargs))
        except Exception:  # an op that cannot run on these shapes
            node_out[key] = None
            continue
        outs = outs if isinstance(outs, tuple) else (outs,)
        node_out[key] = tuple(tuple(o.shape) for o in outs)
    return shapes


_NAME_COUNT: Dict[str, int] = {}
_NAME_LOCK = _threading.Lock()


def _auto_name(op):
    # symbol graphs may be composed from more than one thread
    with _NAME_LOCK:
        n = _NAME_COUNT.get(op, 0)
        _NAME_COUNT[op] = n + 1
    return f"{op.lower().strip('_')}{n}"


def _resolve_op(op):
    # nodes carry a registry NAME; sym.Custom nodes carry their own OpDef
    return op if isinstance(op, _registry.OpDef) else _registry.get(op)


def _apply(op, inputs, kwargs, name=None):
    opdef = _resolve_op(op)
    return Symbol(op, inputs, kwargs, name or _auto_name(op),
                  nout=max(opdef.nout, 1))


# creation helpers of MXNet's generated sym surface, over the registered
# creation ops so they stay lazy symbols
def _as_shape(shape):
    return tuple(shape) if hasattr(shape, "__iter__") else (int(shape),)


def zeros(shape, dtype="float32", name=None):
    return __getattr__("full")(shape=_as_shape(shape), value=0.0,
                               dtype=dtype, name=name)


def ones(shape, dtype="float32", name=None):
    return __getattr__("full")(shape=_as_shape(shape), value=1.0,
                               dtype=dtype, name=name)


def linspace(start, stop, num, endpoint=True, dtype="float32", name=None):
    """``num`` evenly spaced values over [start, stop]: start + arange(num)
    * step, all lazy registry ops. The user's name goes on the returned
    node, so output-name lookups find it."""
    n = int(num)
    denom = (n - 1) if endpoint else n
    step = (stop - start) / denom if denom > 0 else 0.0
    idx = __getattr__("arange")(start=0.0, stop=float(n), step=1.0,
                                dtype=dtype)
    scaled = _apply("_mul_scalar", [idx], {"scalar": step})
    return _apply("_plus_scalar", [scaled], {"scalar": start}, name=name)


def Custom(*args, op_type=None, name=None, **kwargs):
    """A user-defined operator (``mx.operator``) as a graph node. Symbol
    inputs come positionally or by keyword (``sym.Custom(data=x,
    op_type=...)``); other keywords parameterize the CustomOpProp. The
    node carries its own OpDef (nothing is registered), and a graph with
    it reloads only where the op is registered: ``tojson`` records
    ``Custom:<type>``, which ``load_json`` refuses otherwise."""
    from ..operator import make_custom_fn

    sym_args = [a for a in args if isinstance(a, Symbol)]
    if len(sym_args) != len(args):
        raise MXNetError("sym.Custom: positional args must be Symbols")
    kw_syms = [(k, v) for k, v in kwargs.items() if isinstance(v, Symbol)]
    if sym_args and kw_syms:
        raise MXNetError(
            "sym.Custom: pass Symbol inputs either positionally or by "
            "keyword, not both (slot order would be ambiguous)")
    params = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
    inputs = sym_args or [v for _, v in kw_syms]
    fn, nout_ = make_custom_fn(op_type, params)
    opdef = _registry.OpDef(name=f"Custom:{op_type}", fn=fn, nout=nout_)
    return Symbol(opdef, inputs, {}, name or f"custom_{op_type}",
                  nout=max(nout_, 1))


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    s = Symbol(None, [], {}, name)
    s._shape = shape
    return s


Variable = var


def Group(symbols):
    """A multi-head symbol: heads keep their own shapes; an executor's
    forward returns one NDArray per head."""
    symbols = list(symbols)
    return Symbol("_group", symbols, {}, "group", nout=len(symbols))


def load_json(json_str):
    graph = json.loads(json_str)
    built: List[Symbol] = []
    for node in graph["nodes"]:
        if node["op"] == "null":
            built.append(var(node["name"]))
        else:
            inputs = [built[i[0]][i[1]] if built[i[0]]._nout > 1
                      else built[i[0]] for i in node["inputs"]]
            kwargs = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in node.get("_raw_attrs", {}).items()}
            built.append(_apply(node["op"], inputs, kwargs, node["name"]))
    heads = [built[h[0]][h[1]] if built[h[0]]._nout > 1 else built[h[0]]
             for h in graph["heads"]]
    return heads[0] if len(heads) == 1 else Group(heads)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def eval_symbol(symbol: Symbol, env: dict):
    """Evaluate a Symbol graph over NDArrays or tensors through the
    imperative ``invoke`` path: on NDArrays it is recorded under
    ``autograd.record`` (an imported ``SymbolBlock`` fine-tunes), on
    tensors it runs under the caller's grad mode."""
    from ..ndarray import invoke

    return _evaluate(symbol, env,
                     lambda opdef, ins, kw: invoke(opdef, tuple(ins), kw))


class Executor:
    """A bound graph (MXNet's ``GraphExecutor``). ``forward`` evaluates it
    on the bound arrays, op by op, under the executor's context (the
    arrays' device); ``forward(is_train=True)`` keeps the autograd graph,
    and ``backward`` differentiates it (or a fresh forward) with
    ``torch.autograd``, storing each argument's gradient by ``grad_req``
    (``write``, ``add`` or ``null``)."""

    def __init__(self, symbol: Symbol, args: Dict[str, NDArray],
                 grad_req="write", args_grad=None, ctx=None):
        self._symbol = symbol
        self.arg_dict = args
        self.arg_names = symbol.list_arguments()
        self.grad_req = grad_req
        if grad_req == "null":
            self.grad_dict = {}
        else:
            self.grad_dict = args_grad or {
                k: NDArray(torch.zeros_like(v._data))
                for k, v in args.items()}
        if ctx is None:
            ctx = next(iter(args.values()))._data.device if args else \
                as_device(None)
        self._ctx = Context(ctx)
        self._tape = None
        self.outputs: List[NDArray] = []

    def _run(self, grad):
        env, leaves = {}, {}
        for k, v in self.arg_dict.items():
            t = v._data
            if grad and k in self.grad_dict and t.is_floating_point():
                t = t.detach().requires_grad_(True)
                leaves[k] = t
            env[k] = t
        with self._ctx, torch.set_grad_enabled(bool(leaves)):
            out = _evaluate(self._symbol, env, _call_op)
        return (out if isinstance(out, tuple) else (out,)), leaves

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            self.arg_dict[k]._data = v._data if isinstance(v, NDArray) \
                else torch.as_tensor(np.asarray(v),
                                     device=self._ctx.torch_device)
        keep = is_train and self.grad_req != "null"
        outs, leaves = self._run(keep)
        self._tape = (outs, leaves) if keep else None
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def backward(self, out_grads=None):
        outs, leaves = self._tape if self._tape is not None \
            else self._run(self.grad_req != "null")
        self._tape = None
        if not leaves:
            return
        if out_grads is None:
            cts = [torch.ones_like(o) for o in outs]
        else:
            gl = out_grads if isinstance(out_grads, (list, tuple)) \
                else [out_grads]
            cts = [torch.as_tensor(g._data if isinstance(g, NDArray) else
                                   np.asarray(g), dtype=o.dtype,
                                   device=o.device)
                   for g, o in zip(gl, outs)]
        live = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
        names = list(leaves)
        grads = torch.autograd.grad([o for o, _ in live],
                                    [leaves[k] for k in names],
                                    [c for _, c in live], allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    g = torch.zeros_like(leaves[k])
                dst = self.grad_dict[k]._data
                if self.grad_req == "add":
                    dst.add_(g.to(dst.dtype))
                else:
                    dst.copy_(g)

    def copy_params_from(self, arg_params, aux_params=None):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                self.arg_dict[k]._data = v._data


# ops whose parameter inputs MXNet auto-creates as named variables when the
# caller passes only data (``sym.FullyConnected(x, num_hidden=10)`` grows an
# ``<name>_weight``/``<name>_bias``: nnvm's FListInputNames + Compose)
_AUTO_PARAM_SUFFIXES = {
    "FullyConnected": ("weight", "bias"),
    "Convolution": ("weight", "bias"),
    "Deconvolution": ("weight", "bias"),
    "Embedding": ("weight",),
}


def __getattr__(name):
    try:
        opdef = _registry.get(name)
    except AttributeError:
        raise AttributeError(
            f"module 'mx.sym' has no attribute {name!r}") from None

    def sym_op(*args, name=None, **kwargs):
        inputs = [a for a in args if isinstance(a, Symbol)]
        data_kw = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        params = {k: v for k, v in kwargs.items()
                  if not isinstance(v, Symbol)}
        suffixes = _AUTO_PARAM_SUFFIXES.get(opdef.name)
        if suffixes:
            # resolve by INPUT NAME: slot order is (data, *suffixes);
            # keyword Symbols land in their named slot, positional Symbols
            # fill the remaining slots left to right, and still-empty
            # parameter slots get auto-created named variables
            need = [s for s in suffixes
                    if not (s == "bias" and params.get("no_bias"))]
            slot_names = ["data"] + need
            slots = {k: data_kw.pop(k) for k in list(data_kw)
                     if k in slot_names}
            pos = iter(inputs)
            resolved = [slots[sn] if sn in slots else next(pos, None)
                        for sn in slot_names]
            # keyword Symbols outside the named slots ride along after them
            extra = list(pos) + list(data_kw.values())
            if resolved[0] is None and not extra:
                # no data input at all: the generic path
                return _apply(opdef.name, inputs + list(slots.values()),
                              params, name)
            if any(r is None for r in resolved[1:]):
                name = name or _auto_name(opdef.name)
            resolved = [r if r is not None else var(f"{name}_{sn}")
                        for r, sn in zip(resolved, slot_names)]
            return _apply(opdef.name, resolved + extra, params, name)
        inputs.extend(data_kw.values())
        return _apply(opdef.name, inputs, params, name)

    sym_op.__name__ = name
    return sym_op

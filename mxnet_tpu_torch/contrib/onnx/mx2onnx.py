"""ONNX exporter (reference: ``python/mxnet/contrib/onnx/mx2onnx/export_model.py``
+ ``_op_translations.py``).

Walks the port's Symbol DAG (the ``_op``, ``_inputs``, ``_kwargs``,
``_name`` and ``_out_index`` fields of the JAX package's Symbol) in the
JAX exporter's order and emits one ONNX node (or a short chain) per
operator, with parameters as initializers, so both write the same bytes. Opset 12 (attribute-style reduce
axes, Dropout-as-attr) keeps every emitted node in its stable form.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ...base import MXNetError
from . import proto

OPSET = 12


def _pair(v):
    if isinstance(v, (tuple, list)):
        return [int(x) for x in v]
    return [int(v), int(v)]


class _Ctx:
    def __init__(self):
        self.nodes: List[bytes] = []
        self.initializers: List[bytes] = []
        self.counter = 0

    def fresh(self, stem):
        self.counter += 1
        return f"{stem}_{self.counter}"

    def add_init(self, name, arr):
        self.initializers.append(proto.tensor_proto(name, np.asarray(arr)))
        return name

    def emit(self, op_type, inputs, outputs, name="", **attrs):
        self.nodes.append(proto.node_proto(op_type, inputs, outputs, name, **attrs))


def _conv(ctx, name, ins, out, kw):
    pad = _pair(kw.get("pad", (0, 0)))
    attrs = dict(kernel_shape=_pair(kw["kernel"]), strides=_pair(kw.get("stride", (1, 1))),
                 pads=pad + pad, dilations=_pair(kw.get("dilate", (1, 1))),
                 group=int(kw.get("num_group", 1)))
    ctx.emit("Conv", ins[:2] if kw.get("no_bias") else ins, [out], name, **attrs)


def _fc(ctx, name, ins, out, kw):
    data = ins[0]
    if kw.get("flatten", True):
        flat = ctx.fresh(name + "_flat")
        ctx.emit("Flatten", [data], [flat], axis=1)
        data = flat
    if kw.get("no_bias") or len(ins) < 3:
        zero = ctx.add_init(ctx.fresh(name + "_zero_bias"),
                            np.zeros(int(kw["num_hidden"]), np.float32))
        ctx.emit("Gemm", [data, ins[1], zero], [out], name, transB=1)
    else:
        ctx.emit("Gemm", [data, ins[1], ins[2]], [out], name, transB=1)


def _pool(ctx, name, ins, out, kw):
    ptype = kw.get("pool_type", "max")
    if kw.get("global_pool"):
        ctx.emit("GlobalMaxPool" if ptype == "max" else "GlobalAveragePool",
                 ins, [out], name)
        return
    pad = _pair(kw.get("pad", (0, 0)))
    kernel = _pair(kw.get("kernel", (2, 2)))
    stride = _pair(kw["stride"]) if kw.get("stride") is not None else kernel
    attrs = dict(kernel_shape=kernel, strides=stride, pads=pad + pad)
    if ptype == "avg":
        attrs["count_include_pad"] = 1 if kw.get("count_include_pad", True) else 0
        ctx.emit("AveragePool", ins, [out], name, **attrs)
    else:
        ctx.emit("MaxPool", ins, [out], name, **attrs)


def _act(ctx, name, ins, out, kw):
    table = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
             "softrelu": "Softplus", "softsign": "Softsign"}
    act = kw.get("act_type", "relu")
    if act not in table:
        raise MXNetError(f"ONNX export: unsupported act_type {act!r}")
    ctx.emit(table[act], ins, [out], name)


def _bn(ctx, name, ins, out, kw):
    ctx.emit("BatchNormalization", ins, [out], name,
             epsilon=float(kw.get("eps", 1e-5)),
             momentum=float(kw.get("momentum", 0.9)))


def _reshape(ctx, name, ins, out, kw):
    shape = ctx.add_init(ctx.fresh(name + "_shape"),
                         np.asarray(list(kw["shape"]), np.int64))
    ctx.emit("Reshape", [ins[0], shape], [out], name)


def _scalar_bin(onnx_op, reverse=False):
    def fn(ctx, name, ins, out, kw):
        c = ctx.add_init(ctx.fresh(name + "_const"),
                         np.asarray(kw["scalar"], np.float32))
        args = [c, ins[0]] if reverse else [ins[0], c]
        ctx.emit(onnx_op, args, [out], name)

    return fn


def _simple(onnx_op, **fixed):
    def fn(ctx, name, ins, out, kw):
        ctx.emit(onnx_op, ins, [out], name, **fixed)

    return fn


def _softmax(ctx, name, ins, out, kw):
    ctx.emit("Softmax", ins, [out], name, axis=int(kw.get("axis", -1)))


def _reduce(onnx_op):
    def fn(ctx, name, ins, out, kw):
        attrs = {"keepdims": 1 if kw.get("keepdims") else 0}
        ax = kw.get("axis")
        if ax is not None:
            attrs["axes"] = list(ax) if isinstance(ax, (tuple, list)) else [int(ax)]
        ctx.emit(onnx_op, ins, [out], name, **attrs)

    return fn


def _transpose(ctx, name, ins, out, kw):
    attrs = {}
    if kw.get("axes"):
        attrs["perm"] = list(kw["axes"])
    ctx.emit("Transpose", ins, [out], name, **attrs)


def _dropout(ctx, name, ins, out, kw):
    ctx.emit("Dropout", ins, [out], name, ratio=float(kw.get("p", 0.5)))


_TRANSLATORS = {
    "Convolution": _conv,
    "FullyConnected": _fc,
    "Pooling": _pool,
    "Activation": _act,
    "BatchNorm": _bn,
    "Flatten": _simple("Flatten", axis=1),
    "flatten": _simple("Flatten", axis=1),
    "add": _simple("Add"), "elemwise_add": _simple("Add"), "broadcast_add": _simple("Add"),
    "subtract": _simple("Sub"), "elemwise_sub": _simple("Sub"), "broadcast_sub": _simple("Sub"),
    "multiply": _simple("Mul"), "elemwise_mul": _simple("Mul"), "broadcast_mul": _simple("Mul"),
    "divide": _simple("Div"), "elemwise_div": _simple("Div"), "broadcast_div": _simple("Div"),
    "dot": _simple("MatMul"),
    "relu": _simple("Relu"), "sigmoid": _simple("Sigmoid"), "tanh": _simple("Tanh"),
    "exp": _simple("Exp"), "log": _simple("Log"), "sqrt": _simple("Sqrt"),
    "negative": _simple("Neg"), "abs": _simple("Abs"),
    "softmax": _softmax,
    "log_softmax": lambda ctx, name, ins, out, kw: ctx.emit(
        "LogSoftmax", ins, [out], name, axis=int(kw.get("axis", -1))),
    "Concat": lambda ctx, name, ins, out, kw: ctx.emit(
        "Concat", ins, [out], name, axis=int(kw.get("dim", 1))),
    "concat": lambda ctx, name, ins, out, kw: ctx.emit(
        "Concat", ins, [out], name, axis=int(kw.get("dim", 1))),
    "reshape": _reshape, "Reshape": _reshape,
    "transpose": _transpose,
    "sum": _reduce("ReduceSum"), "mean": _reduce("ReduceMean"),
    "max": _reduce("ReduceMax"), "min": _reduce("ReduceMin"),
    "Dropout": _dropout, "dropout": _dropout,
    "_plus_scalar": _scalar_bin("Add"), "_minus_scalar": _scalar_bin("Sub"),
    "_rminus_scalar": _scalar_bin("Sub", reverse=True),
    "_mul_scalar": _scalar_bin("Mul"), "_div_scalar": _scalar_bin("Div"),
    "_rdiv_scalar": _scalar_bin("Div", reverse=True),
    "_power_scalar": _scalar_bin("Pow"),
}


def export_model(sym, params, input_shapes=None, input_types="float32",
                 onnx_file="model.onnx", verbose=False):
    """Export (Symbol, params) to an ONNX file; returns the file path.

    ``params`` keys may carry the deploy-format ``arg:``/``aux:`` prefixes
    (as written by ``HybridBlock.export``)."""
    from ... import symbol as sym_mod

    if isinstance(sym, str):
        sym = sym_mod.load(sym)
    if isinstance(params, str):
        from ...serialization import load_ndarrays

        params = load_ndarrays(params)
    clean = {}
    for k, v in params.items():
        k = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
        if hasattr(v, "asnumpy"):
            v = v.asnumpy()
        elif hasattr(v, "detach"):  # a tensor, on the card or not
            v = v.detach().cpu().numpy()
        clean[k] = np.asarray(v)
    params = clean

    ctx = _Ctx()
    graph_inputs = []
    out_name: Dict[int, str] = {}
    emitted = set()

    def walk(s):
        key = id(s)
        if key in out_name:
            return out_name[key]
        if s._op is None:
            out_name[key] = s._name
            if s._name in params:
                if s._name not in emitted:
                    emitted.add(s._name)
                    ctx.add_init(s._name, params[s._name])
            elif s._name not in emitted:
                emitted.add(s._name)
                shape = (input_shapes or {}).get(s._name) if isinstance(input_shapes, dict) \
                    else (input_shapes[0] if input_shapes else ())
                graph_inputs.append(proto.value_info(
                    s._name, proto.NP_TO_DT[str(np.dtype(input_types))], shape or ()))
            return s._name
        if s._out_index != 0:
            raise MXNetError(f"ONNX export: secondary output {s._out_index} of "
                             f"{s._op!r} has no ONNX representation")
        ins = [walk(i) for i in s._inputs]
        base = f"{s._name}_out"
        node_key = (id(s._inputs[0]) if s._inputs else 0, s._op, s._name)
        if node_key not in emitted:
            emitted.add(node_key)
            fn = _TRANSLATORS.get(s._op)
            if fn is None:
                raise MXNetError(f"ONNX export: operator {s._op!r} has no translator")
            fn(ctx, s._name, ins, base, dict(s._kwargs))
        out_name[key] = base
        return base

    head = walk(sym)
    graph = proto.graph_proto("mxnet_tpu_graph", ctx.nodes, ctx.initializers,
                              graph_inputs,
                              [proto.value_info(head, proto.DT_FLOAT, ())])
    model = proto.model_proto(graph, opset_version=OPSET)
    with open(onnx_file, "wb") as f:
        f.write(model)
    return onnx_file

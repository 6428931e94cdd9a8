"""ONNX importer (reference: ``python/mxnet/contrib/onnx/onnx2mx/import_model.py``).

The port of ``mxnet_tpu/contrib/onnx/onnx2mx.py``: parses an ONNX protobuf
into a Symbol graph over the port's op registry (``symbol._apply`` /
``var``),
returning ``(sym, arg_params, aux_params)`` exactly like the reference API so
``gluon.SymbolBlock(sym, inputs)`` / ``Module`` can run or fine-tune it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ...base import MXNetError
from . import proto


def _attr_pair(v, default):
    if v is None:
        return tuple(default)
    return tuple(int(x) for x in v)


def import_model(onnx_file):
    from ... import symbol as sym_mod
    from ...ndarray import NDArray

    with open(onnx_file, "rb") as f:
        model = proto.parse_model(f.read())
    graph = model["graph"]
    inits = graph["initializers"]

    env: Dict[str, object] = {}
    arg_params = {name: NDArray(np.asarray(arr)) for name, arr in inits.items()}

    for name, _elem, _shape in graph["inputs"]:
        if name not in inits:
            env[name] = sym_mod.var(name)
    for name in inits:
        env[name] = sym_mod.var(name)

    def apply(op, inputs, kwargs, name):
        return sym_mod._apply(op, [env[i] for i in inputs], kwargs, name)

    for node in graph["nodes"]:
        op, ins, outs, a = node["op_type"], node["inputs"], node["outputs"], node["attrs"]
        name = node["name"] or outs[0]
        if op == "Conv":
            pads = a.get("pads", [0, 0, 0, 0])
            if pads[:len(pads) // 2] != pads[len(pads) // 2:]:
                raise MXNetError("asymmetric Conv pads are not supported")
            w = inits[ins[1]]
            out = apply("Convolution", ins, {
                "kernel": _attr_pair(a.get("kernel_shape"), w.shape[2:]),
                "stride": _attr_pair(a.get("strides"), (1, 1)),
                "pad": tuple(pads[:len(pads) // 2]),
                "dilate": _attr_pair(a.get("dilations"), (1, 1)),
                "num_group": int(a.get("group", 1)),
                "num_filter": int(w.shape[0]),
                "no_bias": len(ins) < 3,
            }, name)
        elif op == "Gemm":
            if a.get("transA"):
                raise MXNetError("Gemm with transA=1 is not supported")
            alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
            w_name = ins[1]
            w = inits.get(w_name)
            if w is None:
                raise MXNetError("Gemm weight must be an initializer")
            if not a.get("transB"):
                w = np.ascontiguousarray(w.T)
            if alpha != 1.0:
                w = w * alpha
            arg_params[w_name] = NDArray(w)
            if len(ins) > 2 and beta != 1.0:
                arg_params[ins[2]] = NDArray(np.asarray(inits[ins[2]]) * beta)
            out = apply("FullyConnected", ins, {
                "num_hidden": int(w.shape[0]), "flatten": False,
                "no_bias": len(ins) < 3,
            }, name)
        elif op == "MatMul":
            out = apply("dot", ins, {}, name)
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
            act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh",
                   "Softplus": "softrelu", "Softsign": "softsign"}[op]
            out = apply("Activation", ins, {"act_type": act}, name)
        elif op in ("MaxPool", "AveragePool"):
            pads = a.get("pads", [0, 0, 0, 0])
            # ONNX spec defaults: strides = 1 along each axis,
            # count_include_pad = 0
            out = apply("Pooling", ins, {
                "kernel": _attr_pair(a.get("kernel_shape"), (2, 2)),
                "stride": _attr_pair(a.get("strides"), (1, 1)),
                "pad": tuple(pads[:len(pads) // 2]),
                "pool_type": "max" if op == "MaxPool" else "avg",
                "count_include_pad": bool(a.get("count_include_pad", 0)),
            }, name)
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            out = apply("Pooling", ins, {
                "global_pool": True,
                "pool_type": "max" if op == "GlobalMaxPool" else "avg",
            }, name)
        elif op == "BatchNormalization":
            out = apply("BatchNorm", ins, {
                "eps": float(a.get("epsilon", 1e-5)),
                "momentum": float(a.get("momentum", 0.9)),
                "use_global_stats": True,
            }, name)[0]
        elif op == "Flatten":
            out = apply("flatten", ins, {}, name)
        elif op in ("Add", "Sub", "Mul", "Div", "Pow"):
            mx_op = {"Add": "broadcast_add", "Sub": "broadcast_sub",
                     "Mul": "broadcast_mul", "Div": "broadcast_div",
                     "Pow": "broadcast_power"}[op]
            out = apply(mx_op, ins, {}, name)
        elif op in ("Exp", "Log", "Sqrt", "Neg", "Abs"):
            out = apply({"Exp": "exp", "Log": "log", "Sqrt": "sqrt",
                         "Neg": "negative", "Abs": "abs"}[op], ins, {}, name)
        elif op == "Softmax":
            out = apply("softmax", ins, {"axis": int(a.get("axis", -1))}, name)
        elif op == "LogSoftmax":
            out = apply("log_softmax", ins, {"axis": int(a.get("axis", -1))}, name)
        elif op == "Concat":
            out = apply("concat", ins, {"dim": int(a.get("axis", 1))}, name)
        elif op == "Reshape":
            shape = tuple(int(x) for x in inits[ins[1]])
            out = apply("reshape", ins[:1], {"shape": shape}, name)
            arg_params.pop(ins[1], None)
        elif op == "Transpose":
            out = apply("transpose", ins, {"axes": tuple(a["perm"]) if a.get("perm") else None}, name)
        elif op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin"):
            axes = a.get("axes")
            out = apply({"ReduceSum": "sum", "ReduceMean": "mean",
                         "ReduceMax": "max", "ReduceMin": "min"}[op], ins, {
                "axis": tuple(axes) if axes else None,
                "keepdims": bool(a.get("keepdims", 1)),
            }, name)
        elif op in ("Dropout", "Identity"):
            out = env[ins[0]]  # inference identity
        else:
            raise MXNetError(f"ONNX import: unsupported operator {op!r}")
        env[outs[0]] = out

    head = graph["outputs"][0][0] if graph["outputs"] else None
    if head is None or head not in env:
        # fall back to the last node's output
        head = list(env)[-1]
    return env[head], arg_params, {}

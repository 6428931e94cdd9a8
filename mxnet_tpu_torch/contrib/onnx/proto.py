"""Minimal protobuf wire-format codec for the ONNX message subset: the
port's own copy of ``mxnet_tpu/contrib/onnx/proto.py`` (numpy only), so
that both exporters write the same bytes (the producer field included).

The reference (``python/mxnet/contrib/onnx``) leans on the ``onnx`` pip
package for protobuf serialization; that package is not in this image, so
this module speaks the protobuf wire format directly for exactly the ONNX
messages the exporter/importer need (ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto — onnx/onnx.proto). Files
written here are standard ONNX protobufs readable by onnxruntime/netron.

Wire format: each field is ``tag(varint: field<<3|wiretype)`` + payload;
wiretype 0 = varint, 2 = length-delimited, 5 = 32-bit. Repeated numeric
fields are emitted unpacked (legal for both proto2 and proto3 parsers) and
parsed in either packed or unpacked form.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

# ONNX TensorProto.DataType enum
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BFLOAT16 = 9, 10, 11, 16

NP_TO_DT = {"float32": DT_FLOAT, "uint8": DT_UINT8, "int8": DT_INT8,
            "int32": DT_INT32, "int64": DT_INT64, "bool": DT_BOOL,
            "float16": DT_FLOAT16, "float64": DT_DOUBLE, "bfloat16": DT_BFLOAT16}
DT_TO_NP = {v: k for k, v in NP_TO_DT.items()}

# AttributeProto.AttributeType enum
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_FLOATS, AT_INTS, AT_STRINGS = 1, 2, 3, 4, 6, 7, 8


# -- encoding ---------------------------------------------------------------
def varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement 64-bit, the protobuf convention
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tag(field: int, wt: int) -> bytes:
    return varint((field << 3) | wt)


def f_varint(field: int, v: int) -> bytes:
    return tag(field, 0) + varint(int(v))


def f_bytes(field: int, payload: bytes) -> bytes:
    return tag(field, 2) + varint(len(payload)) + payload


def f_str(field: int, s: str) -> bytes:
    return f_bytes(field, s.encode())


def f_float(field: int, v: float) -> bytes:
    return tag(field, 5) + struct.pack("<f", float(v))


# -- decoding ---------------------------------------------------------------
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse(buf: bytes) -> Dict[int, List[Tuple[int, object]]]:
    """Parse one message into {field: [(wiretype, raw_value), ...]}."""
    fields: Dict[int, List[Tuple[int, object]]] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack("<I", buf[pos:pos + 4])[0]
            pos += 4
        elif wt == 1:
            v = struct.unpack("<Q", buf[pos:pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(field, []).append((wt, v))
    return fields


def get_str(fields, field, default=""):
    vals = fields.get(field)
    return vals[-1][1].decode() if vals else default


def get_int(fields, field, default=0):
    vals = fields.get(field)
    if not vals:
        return default
    v = vals[-1][1]
    return v - (1 << 64) if v >= (1 << 63) else v


def get_float(fields, field, default=0.0):
    vals = fields.get(field)
    if not vals:
        return default
    return struct.unpack("<f", struct.pack("<I", vals[-1][1]))[0]


def get_bytes(fields, field, default=b""):
    vals = fields.get(field)
    return bytes(vals[-1][1]) if vals else default


def get_repeated(fields, field):
    return [v for _, v in fields.get(field, [])]


def get_repeated_int(fields, field):
    """Repeated int64/int32, handling both packed and unpacked encodings."""
    out = []
    for wt, v in fields.get(field, []):
        if wt == 0:
            out.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:  # packed: length-delimited run of varints
            pos = 0
            while pos < len(v):
                x, pos = _read_varint(v, pos)
                out.append(x - (1 << 64) if x >= (1 << 63) else x)
    return out


def get_repeated_float(fields, field):
    out = []
    for wt, v in fields.get(field, []):
        if wt == 5:
            out.append(struct.unpack("<f", struct.pack("<I", v))[0])
        else:  # packed
            out.extend(struct.unpack(f"<{len(v) // 4}f", v))
    return out


# -- ONNX message builders --------------------------------------------------
def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    dt = NP_TO_DT[arr.dtype.name]
    out = b"".join(f_varint(1, d) for d in arr.shape)
    out += f_varint(2, dt)
    out += f_str(8, name)
    out += f_bytes(9, arr.tobytes())  # raw_data
    return out


def parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    fields = parse(buf)
    dims = get_repeated_int(fields, 1)
    dt = get_int(fields, 2, DT_FLOAT)
    name = get_str(fields, 8)
    raw = get_bytes(fields, 9)
    np_dt = np.dtype(DT_TO_NP[dt]) if DT_TO_NP[dt] != "bfloat16" else np.dtype("uint16")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dt).reshape(dims)
    else:  # float_data/int32_data/int64_data fallback fields
        if dt == DT_FLOAT:
            arr = np.asarray(get_repeated_float(fields, 4), np.float32).reshape(dims)
        elif dt == DT_INT64:
            arr = np.asarray(get_repeated_int(fields, 7), np.int64).reshape(dims)
        else:
            # int32_data is field 5 (field 6 is string_data): covers int32,
            # int8/uint8, int16/uint16, bool per onnx.proto TensorProto
            arr = np.asarray(get_repeated_int(fields, 5), np_dt).reshape(dims)
    return name, arr


def attr_proto(name: str, value) -> bytes:
    out = f_str(1, name)
    if isinstance(value, bool):
        out += f_varint(3, int(value)) + f_varint(20, AT_INT)
    elif isinstance(value, int):
        out += f_varint(3, value) + f_varint(20, AT_INT)
    elif isinstance(value, float):
        out += f_float(2, value) + f_varint(20, AT_FLOAT)
    elif isinstance(value, str):
        out += f_bytes(4, value.encode()) + f_varint(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += f_bytes(5, tensor_proto(name + "_value", value)) + f_varint(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            out += b"".join(f_float(7, v) for v in value) + f_varint(20, AT_FLOATS)
        else:
            out += b"".join(f_varint(8, int(v)) for v in value) + f_varint(20, AT_INTS)
    else:
        raise ValueError(f"unsupported attribute value {value!r}")
    return out


def parse_attr(buf: bytes):
    fields = parse(buf)
    name = get_str(fields, 1)
    at = get_int(fields, 20)
    if at == AT_INT:
        return name, get_int(fields, 3)
    if at == AT_FLOAT:
        return name, get_float(fields, 2)
    if at == AT_STRING:
        return name, get_bytes(fields, 4).decode()
    if at == AT_INTS:
        return name, get_repeated_int(fields, 8)
    if at == AT_FLOATS:
        return name, get_repeated_float(fields, 7)
    if at == AT_TENSOR:
        return name, parse_tensor(get_bytes(fields, 5))[1]
    return name, None


def node_proto(op_type: str, inputs, outputs, name="", **attrs) -> bytes:
    out = b"".join(f_str(1, i) for i in inputs)
    out += b"".join(f_str(2, o) for o in outputs)
    if name:
        out += f_str(3, name)
    out += f_str(4, op_type)
    out += b"".join(f_bytes(5, attr_proto(k, v)) for k, v in attrs.items())
    return out


def parse_node(buf: bytes):
    fields = parse(buf)
    return {
        "inputs": [v.decode() for v in get_repeated(fields, 1)],
        "outputs": [v.decode() for v in get_repeated(fields, 2)],
        "name": get_str(fields, 3),
        "op_type": get_str(fields, 4),
        "attrs": dict(parse_attr(bytes(v)) for v in get_repeated(fields, 5)),
    }


def value_info(name: str, elem_type: int, shape) -> bytes:
    dims = b"".join(f_bytes(1, f_varint(1, d)) for d in shape)
    shape_proto = dims
    ttype = f_varint(1, elem_type) + f_bytes(2, shape_proto)
    type_proto = f_bytes(1, ttype)
    return f_str(1, name) + f_bytes(2, type_proto)


def parse_value_info(buf: bytes):
    fields = parse(buf)
    name = get_str(fields, 1)
    tfields = parse(get_bytes(fields, 2))
    ttfields = parse(get_bytes(tfields, 1))
    elem = get_int(ttfields, 1, DT_FLOAT)
    shape = []
    for dim_buf in get_repeated(parse(get_bytes(ttfields, 2)), 1):
        dfields = parse(bytes(dim_buf))
        shape.append(get_int(dfields, 1))
    return name, elem, tuple(shape)


def graph_proto(name, nodes, initializers, inputs, outputs) -> bytes:
    out = b"".join(f_bytes(1, n) for n in nodes)
    out += f_str(2, name)
    out += b"".join(f_bytes(5, t) for t in initializers)
    out += b"".join(f_bytes(11, i) for i in inputs)
    out += b"".join(f_bytes(12, o) for o in outputs)
    return out


def parse_graph(buf: bytes):
    fields = parse(buf)
    return {
        "name": get_str(fields, 2),
        "nodes": [parse_node(bytes(v)) for v in get_repeated(fields, 1)],
        "initializers": dict(parse_tensor(bytes(v)) for v in get_repeated(fields, 5)),
        "inputs": [parse_value_info(bytes(v)) for v in get_repeated(fields, 11)],
        "outputs": [parse_value_info(bytes(v)) for v in get_repeated(fields, 12)],
    }


def model_proto(graph: bytes, opset_version=13, producer="mxnet_tpu") -> bytes:
    opset = f_str(1, "") + f_varint(2, opset_version)
    out = f_varint(1, 8)  # ir_version 8
    out += f_str(2, producer)
    out += f_str(3, "1.0")
    out += f_bytes(7, graph)
    out += f_bytes(8, opset)
    return out


def parse_model(buf: bytes):
    fields = parse(buf)
    graph = parse_graph(get_bytes(fields, 7))
    opsets = []
    for ob in get_repeated(fields, 8):
        of = parse(bytes(ob))
        opsets.append((get_str(of, 1), get_int(of, 2)))
    return {"ir_version": get_int(fields, 1), "graph": graph, "opsets": opsets,
            "producer": get_str(fields, 2)}

"""The port's ONNX export and import (``mxnet_tpu_torch/contrib/onnx``)
against the JAX package's (``mxnet_tpu/contrib/onnx``): the eight cases of
tests/test_onnx.py on the port (MLP, LeNet and ResNet-18 round trips
through ``HybridBlock.export`` -> ``export_model`` -> ``import_model`` ->
``SymbolBlock``, the protobuf's shape, the tensor and attribute codecs,
an operator with no translator), then the two exporters writing the same
bytes from the same ``-symbol.json`` and ``.params``, and a file of either
exporter importing in the other package to the same outputs.

Tolerances are tests/test_onnx.py's: the round trips rtol 1e-5 / atol
1e-6 (LeNet 1e-4 / 1e-5, ResNet 1e-3 / 1e-4, where the imported graph's
BatchNorm uses its moving statistics); the cross imports the same, since
the two packages sum convolutions in other orders."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib.onnx import export_model, import_model
from mxnet_tpu_torch.contrib.onnx import proto
from mxnet_tpu_torch.gluon import nn

CPU = tmx.cpu()


def _export(net, x, tmp_path, stem="m"):
    with CPU:
        net.initialize(ctx=CPU)
        expected = net(x).asnumpy()
        sym_file, param_file = net.export(str(tmp_path / stem))
    return expected, sym_file, param_file


def _symbolblock(onnx_file, ctx=CPU):
    sym, arg_params, aux_params = import_model(onnx_file)
    inputs = [s for s in sym.list_arguments() if s not in arg_params]
    return gluon.SymbolBlock(sym, inputs, {**arg_params, **aux_params},
                             ctx=ctx)


def _roundtrip(net, x, tmp_path, rtol=1e-5, atol=1e-6):
    expected, sym_file, param_file = _export(net, x, tmp_path)
    onnx_file = export_model(sym_file, param_file, input_shapes={"data": x.shape},
                             onnx_file=str(tmp_path / "m.onnx"))
    with CPU:
        got = _symbolblock(onnx_file)(x).asnumpy()
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=atol)
    return onnx_file


def _x(*shape):
    return nd.array(np.random.RandomState(0).rand(*shape).astype(np.float32),
                    ctx=CPU)


def test_onnx_mlp_roundtrip(tmp_path):
    with CPU:
        net = nn.HybridSequential()
        net.add(nn.Dense(16, activation="relu"), nn.Dense(5))
    _roundtrip(net, _x(4, 10), tmp_path)


def test_onnx_lenet_roundtrip(tmp_path):
    with CPU:
        net = gluon.model_zoo.get_model("lenet")
    _roundtrip(net, _x(2, 1, 28, 28), tmp_path, rtol=1e-4, atol=1e-5)


def test_onnx_batchnorm_residual_roundtrip(tmp_path):
    with CPU:
        net = gluon.model_zoo.get_model("resnet18_v1", classes=4)
    _roundtrip(net, _x(1, 3, 32, 32), tmp_path, rtol=1e-3, atol=1e-4)


def test_onnx_file_is_wellformed_protobuf(tmp_path):
    """The emitted bytes parse as a ModelProto with graph/opset populated."""
    with CPU:
        net = nn.HybridSequential()
        net.add(nn.Dense(3))
    _, sym_file, param_file = _export(net, nd.ones((1, 2), ctx=CPU), tmp_path)
    onnx_file = export_model(sym_file, param_file, input_shapes={"data": (1, 2)},
                             onnx_file=str(tmp_path / "m.onnx"))
    with open(onnx_file, "rb") as f:
        model = proto.parse_model(f.read())
    assert model["ir_version"] == 8
    assert model["opsets"] == [("", 12)]
    g = model["graph"]
    assert any(n["op_type"] == "Gemm" for n in g["nodes"])
    assert len(g["initializers"]) >= 2  # weight + bias
    names = [n for n, _, _ in g["inputs"]]
    assert names == ["data"]
    assert g["inputs"][0][2] == (1, 2)


def test_onnx_tensor_codec_dtypes():
    for dt in ("float32", "int64", "int32", "uint8"):
        arr = (np.random.rand(3, 4) * 10).astype(dt)
        name, back = proto.parse_tensor(proto.tensor_proto("t", arr))
        assert name == "t"
        np.testing.assert_array_equal(back, arr)


def test_onnx_tensor_typed_data_fields():
    """Values in the typed repeated fields (float_data=4, int32_data=5,
    int64_data=7) instead of raw_data; int8/uint8/int32 ride int32_data."""
    cases = [
        (np.arange(6, dtype=np.float32).reshape(2, 3), 4),
        (np.array([[1, -2], [3, 4]], np.int64), 7),
        (np.array([[5, -6], [7, 8]], np.int32), 5),
        (np.array([[0, 255], [1, 2]], np.uint8), 5),
        (np.array([[-1, 2], [-3, 4]], np.int8), 5),
    ]
    for arr, field in cases:
        dt = proto.NP_TO_DT[arr.dtype.name]
        buf = b"".join(proto.f_varint(1, d) for d in arr.shape)
        buf += proto.f_varint(2, dt) + proto.f_str(8, "typed")
        if field == 4:
            buf += b"".join(proto.f_float(4, float(v)) for v in arr.ravel())
        else:
            buf += b"".join(proto.f_varint(field, int(v)) for v in arr.ravel())
        name, back = proto.parse_tensor(buf)
        assert name == "typed"
        assert back.dtype == arr.dtype
        np.testing.assert_array_equal(back, arr)


def test_onnx_attr_codec():
    cases = {"i": 7, "f": 1.5, "s": "hello", "ints": [1, 2, 3],
             "floats": [0.5, 0.25], "neg": -3}
    for k, v in cases.items():
        name, back = proto.parse_attr(proto.attr_proto(k, v))
        assert name == k
        if isinstance(v, list):
            np.testing.assert_allclose(back, v)
        else:
            assert back == v


def test_onnx_unsupported_op_errors(tmp_path):
    weird = tmx.sym.topk(tmx.sym.var("data"), k=2)
    with pytest.raises(MXNetError, match="no translator"):
        export_model(weird, {}, onnx_file=str(tmp_path / "x.onnx"))


def _zoo(name, **kw):
    with CPU:
        return gluon.model_zoo.get_model(name, **kw)


NETS = [("lenet", {}, (2, 1, 28, 28), dict(rtol=1e-4, atol=1e-5)),
        ("resnet18_v1", dict(classes=4), (1, 3, 32, 32),
         dict(rtol=1e-3, atol=1e-4))]


@pytest.mark.parametrize("name,kw,shape,tol", NETS, ids=[n[0] for n in NETS])
def test_exporters_write_the_same_bytes_and_cross_import(name, kw, shape,
                                                         tol, tmp_path):
    x = _x(*shape)
    expected, sym_file, param_file = _export(_zoo(name, **kw), x, tmp_path)
    ours = export_model(sym_file, param_file, input_shapes={"data": shape},
                        onnx_file=str(tmp_path / "port.onnx"))
    theirs = jonnx.export_model(sym_file, param_file,
                                input_shapes={"data": shape},
                                onnx_file=str(tmp_path / "jax.onnx"))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    # the JAX exporter's file in the port
    with CPU:
        got = _symbolblock(theirs)(x).asnumpy()
    np.testing.assert_allclose(got, expected, **tol)
    # the port's file in the JAX package
    sym, arg_params, aux_params = jonnx.import_model(ours)
    inputs = [s for s in sym.list_arguments() if s not in arg_params]
    jsb = jmx.gluon.SymbolBlock(sym, inputs, {**arg_params, **aux_params})
    got = jsb(jmx.nd.array(x.asnumpy())).asnumpy()
    np.testing.assert_allclose(got, expected, **tol)

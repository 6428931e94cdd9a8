"""The port's INT8 quantization (``mxnet_tpu_torch/contrib/quantization.py``)
against the JAX package's (``mxnet_tpu/contrib/quantization.py``) on the
same numpy inputs: the two registered ops (scalar, ``(N,)`` and ``(N, 1)``
weight scales, bias and ``no_bias``, ``flatten``, f32 and bf16 outputs,
stride, padding, dilation and groups), ``quantize_array``, the entropy
calibration, ``convert_to_int8`` on LeNet (minmax and entropy),
``quantize_net`` and the example, ``examples/torch_quantize_model.py``.
On CPU tensors the ops run the kernels' plain versions (float64 patches
and products, exact for these integers).

Tolerances: the int32 accumulator exactly equal (unit scales, no bias,
|acc| < 2^24 so f32 holds it); outputs rtol 1e-6 (the same f32 epilogue
in the same order); ``quantize_array`` bit for bit; a converted LeNet's
weight scales bit for bit and its outputs within 1e-5 (its f32 layers
sum convolutions in other orders, which can move an activation scale by
an ulp)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import quantization as JQ
from mxnet_tpu_torch.contrib import quantization as TQ

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

OUT = dict(rtol=1e-6, atol=0)


def _q(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _scales(rs, kind, n):
    if kind == "scalar":
        return np.float32(rs.uniform(1e-3, 1e-2))
    ws = rs.uniform(1e-3, 1e-2, n).astype(np.float32)
    return ws if kind == "n" else ws.reshape(n, 1)


def _same(got, want):
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **OUT)


FC_CASES = [
    dict(ws="scalar"), dict(ws="n"), dict(ws="n1"),
    dict(ws="n", bias=True), dict(ws="n", bias=True, no_bias=True),
    dict(ws="n", shape=(3, 4, 5), flatten=True),
    dict(ws="n", shape=(3, 4, 20), flatten=False, bias=True),
    dict(ws="n1", bias=True, out_dtype="bfloat16"),
    dict(ws="scalar", shape=(7, 25), n=4),
]


@pytest.mark.parametrize("case", FC_CASES, ids=[str(c) for c in FC_CASES])
def test_quantized_fully_connected(case):
    rs = np.random.RandomState(0)
    shape = case.get("shape", (6, 40))
    n = case.get("n", 9)
    k = int(np.prod(shape[1:])) if case.get("flatten", True) else shape[-1]
    x, w = _q(rs, *shape), _q(rs, n, k)
    ws = _scales(rs, case["ws"], n)
    ds = np.float32(rs.uniform(1e-3, 1e-2))
    bias = rs.randn(n).astype(np.float32) if case.get("bias") else None
    kw = dict(data_scale=float(ds), no_bias=case.get("no_bias", False),
              flatten=case.get("flatten", True),
              out_dtype=case.get("out_dtype", "float32"))
    want = JQ.quantized_fully_connected(
        jnp.asarray(x), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias),
        weight_scale=jnp.asarray(ws), **kw)
    got = TQ.quantized_fully_connected(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias),
        weight_scale=torch.from_numpy(np.asarray(ws)), **kw)
    assert str(got.dtype).split(".")[-1] == kw["out_dtype"]
    _same(got, want)


CONV_CASES = [
    dict(), dict(stride=(2, 2)), dict(pad=(1, 1)), dict(pad=(2, 1), dilate=(2, 2)),
    dict(groups=2, ws="n"), dict(groups=4, stride=(2, 1), pad=(1, 0), bias=True),
    dict(kernel=(1, 1), ws="n1", bias=True),
    dict(kernel=(5, 5), c=1, o=6, pad=(2, 2), ws="n", bias=True),
    dict(ws="n", bias=True, out_dtype="bfloat16"),
    dict(bias=True, no_bias=True),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[str(c) for c in CONV_CASES])
def test_quantized_conv(case):
    rs = np.random.RandomState(1)
    c, o, g = case.get("c", 8), case.get("o", 12), case.get("groups", 1)
    kh, kw_ = case.get("kernel", (3, 3))
    x, w = _q(rs, 2, c, 9, 11), _q(rs, o, c // g, kh, kw_)
    ws = _scales(rs, case.get("ws", "scalar"), o)
    bias = rs.randn(o).astype(np.float32) if case.get("bias") else None
    kw = dict(kernel=(kh, kw_), stride=case.get("stride", (1, 1)),
              pad=case.get("pad", (0, 0)), dilate=case.get("dilate", (1, 1)),
              num_filter=o, num_group=g, no_bias=case.get("no_bias", False),
              data_scale=0.0125, out_dtype=case.get("out_dtype", "float32"))
    want = JQ.quantized_conv(jnp.asarray(x), jnp.asarray(w),
                             None if bias is None else jnp.asarray(bias),
                             weight_scale=jnp.asarray(ws), **kw)
    got = TQ.quantized_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if bias is None else torch.from_numpy(bias),
                            weight_scale=torch.from_numpy(np.asarray(ws)),
                            **kw)
    _same(got, want)


@pytest.mark.parametrize("groups", [1, 3])
def test_int32_accumulator_is_exact(groups):
    """Unit scales and no bias: the output is the accumulator itself, at
    values far from f32's integer limit of 2^24."""
    rs = np.random.RandomState(2)
    x = np.full((2, 6, 10, 10), 127, np.int8)
    x[0] = _q(rs, 6, 10, 10)
    w = np.full((9, 6 // groups, 3, 3), -127, np.int8)
    w[1:] = _q(rs, 8, 6 // groups, 3, 3)
    kw = dict(kernel=(3, 3), pad=(1, 1), num_group=groups)
    want = np.asarray(JQ.quantized_conv(jnp.asarray(x), jnp.asarray(w), **kw))
    got = TQ.quantized_conv(torch.from_numpy(x), torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(want).max() == 127 * 127 * 9 * 6 // groups
    # the same through the two kernels' plain versions, patches first
    cols = TQ.int8_im2col(torch.from_numpy(x), (3, 3), 1, 1, 1, groups, 64)
    assert cols.shape == (groups, 2 * 100, 64) and cols.dtype == torch.int8
    acc = TQ.int8_gemm(cols, torch.from_numpy(w.reshape(9, -1)),
                       6 // groups * 9, 1.0, 1.0, groups=groups,
                       positions=100)
    np.testing.assert_array_equal(acc.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_array_bit_equal(axis):
    rs = np.random.RandomState(3)
    x = (rs.randn(16, 24) * rs.uniform(0.1, 10, (16, 1))).astype(np.float32)
    jq, js = JQ.quantize_array(jnp.asarray(x), axis=axis)
    tq, ts = TQ.quantize_array(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # and with a given scale
    jq, _ = JQ.quantize_array(jnp.asarray(x), scale=0.037)
    tq, _ = TQ.quantize_array(torch.from_numpy(x), scale=0.037)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        TQ.dequantize_array(tq, ts, "float32").numpy(),
        np.asarray(JQ.dequantize_array(jq, js, jnp.float32)))


def test_entropy_calibration_thresholds():
    """tests/test_quantize_example.py's two cases, in both packages: the
    bounded distribution keeps ~amax, the long tail is clipped."""
    rs = np.random.RandomState(0)
    bounded = np.tanh(rs.randn(50000) * 1.5)
    long_tail = np.abs(rs.randn(50000)) ** 2
    for data in (bounded, long_tail):
        assert TQ.calib_entropy([data]) == JQ.calib_entropy([data])
        assert TQ.calib_minmax([data]) == JQ.calib_minmax([data])
    assert TQ.calib_entropy([bounded]) * 127.0 > 0.9
    thr2 = TQ.calib_entropy([long_tail]) * 127.0
    assert thr2 < float(long_tail.max()) * 0.8
    assert thr2 > np.percentile(long_tail, 99) * 0.5


def _lenets(tmp_path, classes=3):
    """LeNet in both packages with the port's Xavier weights, carried to
    JAX through a .params file, and an input batch."""
    with tmx.cpu():
        tmx.random.seed(0)
        tnet = tmx.gluon.model_zoo.get_model("lenet", classes=classes)
        tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        x = np.random.RandomState(0).rand(4, 1, 28, 28).astype(np.float32)
        tnet(tmx.nd.array(x))
    f = str(tmp_path / "lenet.params")
    tnet.save_parameters(f)
    jnet = jmx.gluon.model_zoo.get_model("lenet", classes=classes)
    jnet.load_parameters(f)
    return jnet, tnet, x


def _follow_children(jnet):
    """Point the JAX net's attribute-held children (LeNet's ``output``) at
    what ``convert_to_int8`` put in their ``_children`` slots. The JAX
    conversion replaces only the slot, so the JAX forward still runs the
    f32 ``Dense`` there; the port's children are the attributes (torch
    modules), so its forward runs the int8 layer (ROADMAP §3)."""
    for blk in [jnet] + [c for _, c in JQ._walk_blocks(jnet)]:
        for key, child in getattr(blk, "_children", {}).items():
            if key in vars(blk) and vars(blk)[key] is not child:
                object.__setattr__(blk, key, child)


@pytest.mark.parametrize("mode", ["minmax", "entropy", None])
def test_convert_to_int8_lenet(mode, tmp_path):
    jnet, tnet, x = _lenets(tmp_path)
    calib = None if mode is None else [x[:2], x[2:]]
    jnet, jscales = JQ.convert_to_int8(
        jnet, calib_data=None if calib is None else
        [jmx.nd.array(c) for c in calib], calib_mode=mode or "minmax")
    assert type(jnet.output).__name__ == "Dense"
    _follow_children(jnet)
    with tmx.cpu():
        tnet, tscales = TQ.convert_to_int8(
            tnet, calib_data=None if calib is None else
            [tmx.nd.array(c) for c in calib], calib_mode=mode or "minmax")
        got = tnet(tmx.nd.array(x)).asnumpy()
    assert sorted(tscales) == sorted(jscales)
    assert len(tscales) == 5 and "features.0" in tscales
    for k in jscales:
        np.testing.assert_array_equal(tscales[k], np.asarray(jscales[k]))
    assert isinstance(tnet.features[0], TQ.QuantizedConv2D)
    assert isinstance(tnet.output, TQ.QuantizedDense)
    want = jnet(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantize_net_lenet(tmp_path):
    jnet, tnet, _ = _lenets(tmp_path)
    jnet, jscales = JQ.quantize_net(jnet)
    tnet, tscales = TQ.quantize_net(tnet)
    assert sorted(tscales) == sorted(jscales)
    for k in jscales:
        np.testing.assert_array_equal(tscales[k], np.asarray(jscales[k]))
    jp = {k[len(jnet.prefix):]: p.data().asnumpy()
          for k, p in jnet.collect_params().items()}
    tp = {k[len(tnet.prefix):]: p.data().asnumpy()
          for k, p in tnet.collect_params().items()}
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])


def test_quantize_model_example():
    """examples/torch_quantize_model.py at --epochs 1, held as
    tests/test_quantize_example.py holds the JAX example."""
    import torch_quantize_model

    fp32_acc, int8_acc = torch_quantize_model.main(
        ["--epochs", "1", "--calib-batches", "2", "--device", "cpu"])
    assert fp32_acc > 0.5
    assert int8_acc >= fp32_acc - 0.05


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros((1, 2, 4, 4), dtype=torch.int8)
    with pytest.raises(tmx.MXNetError):
        TQ.int8_im2col(x.float().to("meta"), (3, 3), 1, 0, 1, 1, 32)


def _float_act(rs, shape, scale):
    """Activations on the quantisation's edges: (n + 0.5) * scale ties for
    half of them (scale a power of two, so x / scale is exactly n + 0.5),
    |n| up to 160 (clamped past 127), the rest arbitrary."""
    n = rs.randint(-160, 161, shape).astype(np.float32)
    tie = n + np.float32(0.5)
    wild = (rs.randn(*shape) * 60).astype(np.float32)
    pick = rs.randint(0, 3, shape)
    return np.where(pick == 0, n, np.where(pick == 1, tie, wild)) \
        .astype(np.float32) * np.float32(scale)


# (C, H, W, kernel, stride, pad, dilate, groups): padding, stride 2,
# dilation 2 and 6 (taps mostly in the padding), groups 1 and 3, C = 1
# and 3, 1x1 layers
FUSED_CASES = [(3, 9, 11, (7, 7), 2, 3, 1, 1), (1, 8, 8, (5, 5), 1, 2, 1, 1),
               (6, 9, 10, (3, 3), 1, 1, 2, 3), (6, 7, 9, (3, 3), 2, 1, 1, 1),
               (12, 5, 6, (1, 1), 1, 0, 1, 1), (12, 6, 7, (1, 1), 2, 0, 1, 3),
               (4, 13, 13, (3, 3), 1, 6, 6, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FUSED_CASES, ids=[str(c) for c in FUSED_CASES])
def test_fused_im2col_plain_is_quantise_then_im2col(case, dtype):
    """The im2col that quantises a float activation itself, on the CPU,
    equals quantising first (``_QuantizedLayer``'s quantisation, written
    out here) then ``int8_im2col_plain``, bit for bit; and the quantised
    values are JAX's ``jnp.clip(jnp.round(xf / a_scale), -127, 127)``."""
    c, h, w, kernel, s, p, d, g = case
    rs = np.random.RandomState(4)
    scale = 2.0 ** -5
    x = torch.from_numpy(_float_act(rs, (2, c, h, w), scale)) \
        .to(getattr(torch, dtype))
    a_scale = torch.tensor(scale, dtype=torch.float32)
    k = c // g * kernel[0] * kernel[1]
    kp = TQ.k_padded(k)
    got = TQ.int8_im2col(x, kernel, s, p, d, g, kp, a_scale)
    xf = x.to(torch.float32)
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    want = TQ.int8_im2col_plain(xq, TQ._pair(kernel), TQ._pair(s),
                                TQ._pair(p), TQ._pair(d), g, kp)
    assert got.dtype == torch.int8 and torch.equal(got, want)
    jq = np.asarray(jnp.clip(jnp.round(jnp.asarray(xf.numpy()) / jnp.float32(
        scale)), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(xq.numpy(), jq)
    # the edges were there: ties that round to even, clamped values, and
    # the zero padding past K
    ratio = (xf / a_scale).numpy()
    assert (ratio == np.floor(ratio) + 0.5).any() and (np.abs(ratio) > 127).any()
    assert (got[..., k:] == 0).all()


@pytest.mark.parametrize("static", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_conv2d_forward_matches_jax(static, dtype):
    """``QuantizedConv2D`` hands its float input and scale to the im2col;
    its forward equals the JAX layer's on the same numpy input, with a
    calibrated (static) and with a dynamic activation scale."""
    rs = np.random.RandomState(5)
    x = _float_act(rs, (2, 6, 9, 10), 2.0 ** -6)
    w = _q(rs, 8, 3, 3, 3)
    ws = rs.uniform(1e-3, 1e-2, 8).astype(np.float32)
    bias = rs.randn(8).astype(np.float32)
    act_scale = np.float32(2.0 ** -6) if static else None
    geo = ((3, 3), (1, 2), (1, 1), (2, 1), 2)
    jl = JQ.QuantizedConv2D(jnp.asarray(w), jnp.asarray(ws), jnp.asarray(bias),
                            *geo, activation="relu", act_scale=act_scale)
    tl = TQ.QuantizedConv2D(torch.from_numpy(w), torch.from_numpy(ws),
                            torch.from_numpy(bias), *geo, activation="relu",
                            act_scale=act_scale)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jl(jnp.asarray(xt.to(torch.float32).numpy()).astype(dtype))
    got = tl(xt)
    assert got.dtype == xt.dtype
    _same(got, want._data)


def test_im2col_refuses_a_scale_that_does_not_fit():
    x = torch.zeros((1, 2, 4, 4))
    with pytest.raises(tmx.MXNetError):
        TQ.int8_im2col(x, (3, 3), 1, 0, 1, 1, 32)            # float, no scale
    with pytest.raises(tmx.MXNetError):
        TQ.int8_im2col(x.to(torch.int8), (3, 3), 1, 0, 1, 1, 32, 0.5)
    with pytest.raises(tmx.MXNetError):
        TQ.int8_im2col(x.to(torch.float16), (3, 3), 1, 0, 1, 1, 32, 0.5)


# (name, M, N, K, groups, row bytes, route, tile width, K splits) on 132
# SMs: resnet50_v1's layers at B=32 (res5's 3x3 in 64-wide tiles, 104 of
# them, rather than 52 of 128; its Dense split in four), ResNeXt's 32
# groups, LeNet's Dense (K = 120 and 84 on mma.sync)
GEMM_PLANS = [("res4 3x3", 6272, 256, 2304, 1, 2304, "wgmma", 128, 1),
              ("res5 3x3", 1568, 512, 4608, 1, 4608, "wgmma", 64, 1),
              ("stem", 401408, 64, 147, 1, 160, "wgmma", 64, 1),
              ("res2 3x3", 100352, 64, 576, 1, 576, "wgmma", 64, 1),
              ("res3 1x1", 25088, 128, 512, 1, 512, "wgmma", 128, 1),
              ("res5 1x1 2048->512", 1568, 512, 2048, 1, 2048, "wgmma", 64,
               1),
              ("dense 2048->1000", 32, 1000, 2048, 1, 2048, "wgmma", 64, 4),
              ("grouped 32", 25088, 8, 72, 32, 96, "wgmma", 64, 1),
              ("lenet dense 400->120", 32, 120, 400, 1, 400, "wgmma", 64, 1),
              ("lenet dense 120->84", 32, 84, 120, 1, 120, "mma", 0, 1),
              ("lenet dense 84->4", 32, 4, 84, 1, 84, "mma", 0, 1)]


@pytest.mark.parametrize("case", GEMM_PLANS, ids=[c[0] for c in GEMM_PLANS])
def test_gemm_plan_at_the_path_shapes(case):
    _, m, n, k, g, ld, route, bn, splits = case
    assert TQ.gemm_plan(m, n, k, g, ld, ld, True, 132) == (route, bn, splits)
    # a base that is not 16-byte aligned takes the mma.sync route
    assert TQ.gemm_plan(m, n, k, g, ld, ld, False, 132) == ("mma", 0, 1)

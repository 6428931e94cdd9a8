"""The vision operators of the port (``mxnet_tpu_torch/ops/nn.py``:
convolution, deconvolution, pooling, adaptive average pooling, LeakyReLU,
batch_norm, instance_norm) against the JAX package's on the same seeded
numpy inputs: outputs, and gradients against ``jax.vjp`` (of the JAX op
under ``jax.jit``, one compilation a case) with the same
cotangent, in f32, under a global bfloat16 ``amp.init`` (f32 inputs
computed in bf16) and for float16 inputs (computed in f32); the ops by
their registry names through ``nd``; the pooling cases ``F.max_pool2d`` /
``F.avg_pool2d`` refuse (a pad over half the kernel) and integer max
pooling; the f32 convolution's precision flags."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.ops import nn as tops

# f32: the two packages sum a convolution's products in different orders
F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 results: both round the same bf16 operands and sum in f32; a
# result may land one bf16 ulp apart (2^-8), a gradient summed over many
# bf16 products a little more
BF16 = dict(rtol=2 ** -6, atol=2 ** -6)
# f16 results: computed in f32 on both sides and rounded to f16; the bias
# gradient sums f16 cotangents, rounded in different orders (two f16 ulps)
F16 = dict(rtol=2 ** -8, atol=2 ** -8)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.fixture
def amp_bf16():
    """A global bfloat16 amp.init in both packages, reset afterwards."""
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        yield
    finally:
        jamp._reset()
        tamp._reset()


def _both(jfn, tfn, arrays, kw, dtype=None, grad=True, tol=F32, seed=9):
    """Run the JAX function and the port's on ``arrays`` (numpy f32, cast
    to ``dtype`` on both sides), compare outputs, then the gradients of
    every float input for one seeded cotangent."""
    jd = {None: None, "bfloat16": jnp.bfloat16, "float16": jnp.float16}[dtype]
    td = {None: None, "bfloat16": torch.bfloat16,
          "float16": torch.float16}[dtype]
    jin = [jnp.asarray(a, jd) if jd is not None else jnp.asarray(a)
           for a in arrays]
    tin = [torch.from_numpy(a).to(td) if td is not None
           else torch.from_numpy(a) for a in arrays]
    want, vjp = jax.vjp(jax.jit(lambda *a: jfn(*a, **kw)), *jin)
    for t in tin:
        t.requires_grad_(grad and t.is_floating_point())
    got = tfn(*tin, **kw)
    assert got.dtype == tin[0].dtype, (got.dtype, tin[0].dtype)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)
    if not grad:
        return
    ct = _x(tuple(want.shape), seed)
    jgrads = vjp(jnp.asarray(ct, want.dtype))
    got.backward(torch.from_numpy(ct).to(got.dtype))
    for i, (t, g) in enumerate(zip(tin, jgrads)):
        if t.requires_grad:
            # an input the output does not depend on gets no gradient
            tg = torch.zeros_like(t) if t.grad is None else t.grad
            np.testing.assert_allclose(_np(tg), _jnp(g), err_msg=f"d{i}",
                                       **tol)


CONV_CASES = {
    "3x3 s2 p1": ((2, 4, 9, 9), (6, 4, 3, 3), dict(stride=(2, 2),
                                                    pad=(1, 1))),
    "dilate 2": ((2, 4, 11, 11), (5, 4, 3, 3), dict(dilate=(2, 2),
                                                     pad=(2, 2))),
    "groups 2": ((2, 4, 8, 8), (6, 2, 3, 3), dict(num_group=2, pad=(1, 1))),
    "depthwise 5x1": ((1, 4, 10, 7), (4, 1, 5, 1),
                      dict(num_group=4, stride=(2, 1), pad=(2, 0))),
    "1-D": ((2, 3, 17), (4, 3, 5), dict(stride=2, pad=2)),
}


def _conv_inputs(case):
    xs, ws, kw = CONV_CASES[case]
    return [_x(xs, 1), _x(ws, 2, 0.3), _x((ws[0],), 3, 0.1)], kw


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    arrays, kw = _conv_inputs(case)
    _both(jops.convolution, tops.convolution, arrays, kw)


@pytest.mark.parametrize("case", ["3x3 s2 p1", "groups 2", "1-D"])
def test_convolution_under_bf16_amp(case, amp_bf16):
    """f32 input and weight computed in bf16, the output back in f32."""
    arrays, kw = _conv_inputs(case)
    _both(jops.convolution, tops.convolution, arrays, kw, tol=BF16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_convolution_low_precision_inputs(dtype):
    """bf16 operands compute in bf16; f16 ones in f32, rounded once."""
    arrays, kw = _conv_inputs("3x3 s2 p1")
    _both(jops.convolution, tops.convolution, arrays, kw, dtype=dtype,
          tol=BF16 if dtype == "bfloat16" else F16)


@pytest.mark.parametrize("kw", [dict(stride=(2, 2), pad=(1, 1), adj=(1, 1)),
                                dict(stride=(1, 1), pad=(0, 0)),
                                dict(stride=(3, 2), pad=(1, 0), adj=(2, 1))],
                         ids=["s2p1a1", "s1", "s32p10a21"])
def test_deconvolution_matches_jax(kw):
    arrays = [_x((2, 4, 5, 6), 1), _x((4, 3, 3, 3), 2, 0.3),
              _x((3,), 3, 0.1)]
    _both(jops.deconvolution, tops.deconvolution, arrays, kw)


def test_deconvolution_under_bf16_amp(amp_bf16):
    arrays = [_x((2, 4, 5, 6), 1), _x((4, 3, 3, 3), 2, 0.3),
              _x((3,), 3, 0.1)]
    _both(jops.deconvolution, tops.deconvolution, arrays,
          dict(stride=(2, 2), pad=(1, 1), adj=(1, 1)), tol=BF16)


POOL_CASES = {
    "max k3 s2 p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "max k2": dict(kernel=(2, 2)),
    "max k2 p2 (wide pad)": dict(kernel=(2, 2), stride=(1, 1), pad=(2, 2)),
    "avg k3 s1 p1": dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                         pool_type="avg"),
    "avg k3 s2 p1 exclude": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 pool_type="avg", count_include_pad=False),
    "avg k2 p2 (wide pad)": dict(kernel=(2, 2), stride=(1, 1), pad=(2, 1),
                                 pool_type="avg"),
    "avg k2 p2 exclude (wide pad)": dict(kernel=(2, 2), stride=(2, 1),
                                         pad=(2, 2), pool_type="avg",
                                         count_include_pad=False),
    "avg k(1,3)": dict(kernel=(1, 3), stride=(1, 2), pool_type="avg"),
    "global max": dict(global_pool=True),
    "global avg": dict(global_pool=True, pool_type="avg"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    _both(jops.pooling, tops.pooling, [_x((2, 3, 9, 8), 4)],
          POOL_CASES[case])


@pytest.mark.parametrize("case", ["max k3 s2 p1", "avg k3 s2 p1 exclude",
                                  "global avg"])
def test_pooling_bf16(case):
    _both(jops.pooling, tops.pooling, [_x((2, 3, 9, 8), 4)],
          POOL_CASES[case], dtype="bfloat16", tol=BF16)


@pytest.mark.parametrize("pad", [(1, 1), (2, 2)], ids=["p1", "p2"])
def test_integer_max_pool_pads_with_the_least_value(pad):
    x = np.random.RandomState(5).randint(-100, 100, (1, 2, 6, 7)).astype(
        np.int32)
    kw = dict(kernel=(2, 3), stride=(1, 1), pad=pad)
    want = np.asarray(jops.pooling(jnp.asarray(x), **kw))
    got = tops.pooling(torch.from_numpy(x), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a window wholly in the padding keeps the least value (pad 2, kernel 2)
    lowest = (got == torch.iinfo(torch.int32).min).any().item()
    assert lowest == (pad[0] >= kw["kernel"][0])


def test_pooling_refuses_other_conventions():
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError, match="valid"):
        tops.pooling(x, kernel=(3, 3), pooling_convention="full")


@pytest.mark.parametrize("size", [1, 2, (3, 2)])
def test_adaptive_avg_pooling_matches_jax(size):
    _both(jops.adaptive_avg_pooling, tops.adaptive_avg_pooling,
          [_x((2, 3, 6, 8), 6)], dict(output_size=size))


LEAKY = ["leaky", "elu", "selu", "gelu", "rrelu"]


@pytest.mark.parametrize("act", LEAKY)
def test_leaky_relu_matches_jax(act):
    _both(jops.leaky_relu, tops.leaky_relu, [_x((3, 4, 5), 7, 2.0)],
          dict(act_type=act, slope=0.3))


@pytest.mark.parametrize("gshape", [(4,), (1, 4, 1, 1)], ids=["1d", "full"])
def test_prelu_matches_jax(gshape):
    arrays = [_x((2, 4, 3, 3), 8, 2.0), _x(gshape, 9, 0.5)]
    _both(lambda x, g: jops.leaky_relu(x, g, act_type="prelu"),
          lambda x, g: tops.leaky_relu(x, g, act_type="prelu"), arrays, {})


def test_leaky_relu_refuses_unknown():
    with pytest.raises(ValueError, match="act_type"):
        tops.leaky_relu(torch.zeros(2), act_type="swish")


BN_CASES = {
    "training": dict(training=True),
    "eval": dict(training=False),
    "fix_gamma": dict(training=True, fix_gamma=True),
    "use_global_stats": dict(training=True, use_global_stats=True),
    "axis -1": dict(training=True, axis=-1),
}


def _bn_arrays(c=4, shape=(3, 4, 5, 6)):
    return [_x(shape, 10, 2.0) + 0.5, _x((c,), 11, 0.5) + 1.0,
            _x((c,), 12, 0.5), _x((c,), 13, 0.3),
            np.abs(_x((c,), 14)) + 0.5]


def _bn_out(fn):
    """The op's normalized output (its statistics are compared apart)."""
    return lambda *a, **kw: fn(*a, **kw)[0]


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm_matches_jax(case):
    kw = dict(BN_CASES[case], eps=1e-5)
    shape = (3, 5, 6, 4) if kw.get("axis") == -1 else (3, 4, 5, 6)
    arrays = _bn_arrays(4, shape)
    _both(_bn_out(jops.batch_norm), _bn_out(tops.batch_norm), arrays, kw)
    jout = jops.batch_norm(*[jnp.asarray(a) for a in arrays], **kw)
    tout = tops.batch_norm(*[torch.from_numpy(a) for a in arrays], **kw)
    for j, t, what in zip(jout[1:], tout[1:], ("mean", "var")):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(_np(t), _jnp(j), err_msg=what, **F32)


def test_batch_norm_variance_is_the_biased_one():
    x = torch.from_numpy(_x((8, 3, 2, 2), 15))
    _, mean, var = tops.batch_norm(x, torch.ones(3), torch.zeros(3),
                                   torch.zeros(3), torch.ones(3),
                                   training=True)
    want = x.permute(1, 0, 2, 3).reshape(3, -1).var(dim=1, unbiased=False)
    torch.testing.assert_close(var, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_batch_norm_low_precision_input(dtype):
    """A bf16 / f16 input with f32 gamma, beta and statistics (a cast net's
    BatchNorm): f32 statistics, the output in the input's dtype."""
    arrays = _bn_arrays()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float16
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float16
    jx = [jnp.asarray(arrays[0], jd)] + [jnp.asarray(a) for a in arrays[1:]]
    tx = [torch.from_numpy(arrays[0]).to(td).requires_grad_()] + \
        [torch.from_numpy(a).requires_grad_() for a in arrays[1:3]] + \
        [torch.from_numpy(a) for a in arrays[3:]]
    (want, jmean, jvar), vjp = jax.vjp(
        lambda x, g, b: jops.batch_norm(x, g, b, jx[3], jx[4], training=True),
        *jx[:3])
    got, tmean, tvar = tops.batch_norm(*tx, training=True)
    assert got.dtype == td and tmean.dtype == torch.float32
    tol = BF16 if dtype == "bfloat16" else F16
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)
    np.testing.assert_allclose(_np(tvar), _jnp(jvar), **F32)
    ct = _x(tuple(want.shape), 16)
    jg = vjp((jnp.asarray(ct, jd), jnp.zeros_like(jmean),
              jnp.zeros_like(jvar)))
    got.backward(torch.from_numpy(ct).to(td))
    for t, g in zip(tx[:3], jg):
        np.testing.assert_allclose(_np(t.grad), _jnp(g), **tol)


def test_instance_norm_matches_jax():
    arrays = [_x((2, 3, 5, 4), 17, 2.0), _x((3,), 18, 0.5) + 1.0,
              _x((3,), 19, 0.5)]
    _both(jops.instance_norm, tops.instance_norm, arrays, dict(eps=1e-3))


REGISTRY = [
    ("Convolution", lambda: ([_x((1, 2, 5, 5)), _x((3, 2, 3, 3), 1, 0.3),
                              _x((3,), 2)], dict(kernel=(3, 3), pad=(1, 1),
                                                 num_filter=3))),
    ("Deconvolution", lambda: ([_x((1, 2, 4, 4)), _x((2, 3, 2, 2), 1, 0.3)],
                               dict(kernel=(2, 2), stride=(2, 2),
                                    num_filter=3, no_bias=True))),
    ("Pooling", lambda: ([_x((1, 2, 6, 6))], dict(kernel=(2, 2),
                                                  pool_type="avg"))),
    ("_contrib_AdaptiveAvgPooling2D", lambda: ([_x((1, 2, 6, 6))],
                                               dict(output_size=3))),
    ("LeakyReLU", lambda: ([_x((2, 5))], dict(act_type="elu", slope=0.5))),
    ("InstanceNorm", lambda: ([_x((2, 3, 4)), _x((3,), 1), _x((3,), 2)],
                              {})),
]


@pytest.mark.parametrize("name", [n for n, _ in REGISTRY])
def test_nd_registry_names_match_jax(name):
    arrays, kw = dict(REGISTRY)[name]()
    want = getattr(jmx.nd, name)(*[jmx.nd.array(a) for a in arrays], **kw)
    with tmx.cpu():
        got = getattr(tmx.nd, name)(*[tmx.nd.array(a) for a in arrays],
                                    **kw)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)


def test_nd_batch_norm_returns_three_outputs():
    arrays = _bn_arrays()
    want = jmx.nd.BatchNorm(*[jmx.nd.array(a) for a in arrays],
                            training=True)
    with tmx.cpu():
        got = tmx.nd.BatchNorm(*[tmx.nd.array(a) for a in arrays],
                               training=True)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **F32)


def test_nd_convolution_records_gradients():
    x, w, b = _conv_inputs("3x3 s2 p1")[0]
    jx, jw = jmx.nd.array(x), jmx.nd.array(w)
    jx.attach_grad()
    jw.attach_grad()
    with jmx.autograd.record():
        jy = jmx.nd.Convolution(jx, jw, kernel=(3, 3), pad=(1, 1),
                                num_filter=6, no_bias=True)
    jy.backward()
    with tmx.cpu():
        tx, tw = tmx.nd.array(x), tmx.nd.array(w)
        tx.attach_grad()
        tw.attach_grad()
        with tmx.autograd.record():
            ty = tmx.nd.Convolution(tx, tw, kernel=(3, 3), pad=(1, 1),
                                    num_filter=6, no_bias=True)
        ty.backward()
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), **F32)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(), **F32)
    np.testing.assert_allclose(tw.grad.asnumpy(), jw.grad.asnumpy(), **F32)


def test_convolution_refuses_3d_input_as_jax_does():
    x = _x((1, 2, 3, 4, 4))
    w = _x((2, 2, 1, 1, 1))
    with pytest.raises(Exception):
        jops.convolution(jnp.asarray(x), jnp.asarray(w), stride=(1, 1, 1),
                         pad=(0, 0, 0), dilate=(1, 1, 1))
    with pytest.raises(ValueError, match="1-D and 2-D"):
        tops.convolution(torch.from_numpy(x), torch.from_numpy(w),
                         stride=(1, 1, 1), pad=(0, 0, 0), dilate=(1, 1, 1))


def test_conv_precision_flags():
    """The port's convolutions take cuDNN's deterministic algorithms (and
    no TF32, held on the card by chip_smoke.py's ``conv f32``); on the CPU
    the flags are not touched."""
    assert tops.DETERMINISTIC is True
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32, cudnn.deterministic
    with tops._conv_precision(torch.zeros(1)):
        assert (cudnn.allow_tf32, cudnn.deterministic) == before
    assert (cudnn.allow_tf32, cudnn.deterministic) == before


"""The port's convolution, pooling, normalization and activation layers
(``gluon/nn/conv_layers.py``, ``gluon/nn/basic_layers.py``) and
``gluon.contrib.nn`` against the JAX package's: parameter names, shapes
inferred at the first forward (``in_channels=0``), the same outputs and
input gradients from carried weights, BatchNorm's moving statistics after
imperative training calls, ``cast("bfloat16")`` (BatchNorm's parameters
stay f32), and the layers the JAX package constructs but cannot run
(Conv3D)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -6, atol=2 ** -6)
SIDES = (jmx, tmx)


@pytest.fixture(autouse=True, scope="module")
def name_counters():
    """Both packages' block-name counters are process-wide: put them back
    after the module, so that the files a test worker runs after it name
    their blocks as they would without it (tests elsewhere pair two nets'
    parameters by sorted name, which a counter crossing a digit boundary
    reorders)."""
    from mxnet_tpu.gluon import block as jblock
    from mxnet_tpu_torch.gluon import block as tblock

    saved = [(m._GLOBAL_COUNT, dict(m._GLOBAL_COUNT))
             for m in (jblock, tblock)]
    yield
    for counts, before in saved:
        counts.clear()
        counts.update(before)


def _x(shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _ctx(mx):
    return mx.cpu()


def _build(mx, factory):
    """The port's net with Xavier weights; JAX's with zeros (a JAX draw
    compiles a program per shape), until :func:`_carry` copies the
    port's values in."""
    with _ctx(mx):
        net = factory(mx)
        net.initialize(mx.init.Xavier() if mx is tmx else mx.init.Zero())
    return net


def _carry(jnet, tnet):
    """Every parameter of the port's net into JAX's, by structural
    name."""
    jparams = jnet._collect_params_with_prefix()
    for name, p in tnet._collect_params_with_prefix().items():
        jparams[name].set_data(np.asarray(p.data().asnumpy(), np.float32))


def _call(mx, net, x, record=False, dtype=None):
    """One imperative call; with ``record`` under ``autograd.record()`` and
    the input's gradient returned (for a cotangent of ones)."""
    with _ctx(mx):
        a = mx.nd.array(x)
        if dtype is not None:
            a = a.astype(dtype)
        if not record:
            return net(a).asnumpy(), None
        a.attach_grad()
        with mx.autograd.record():
            out = net(a)
        out.backward(mx.nd.ones_like(out))
        return out.asnumpy(), a.grad.asnumpy()


def _names(net):
    return list(net.collect_params().keys()), \
        sorted(net._collect_params_with_prefix().keys())


LAYERS = {
    "Conv2D": (lambda mx: mx.gluon.nn.Conv2D(5, 3, strides=2, padding=1,
                                             activation="relu"),
               (2, 3, 9, 9)),
    "Conv2D groups dilation": (
        lambda mx: mx.gluon.nn.Conv2D(4, (3, 2), dilation=(2, 1), groups=2,
                                      use_bias=False), (2, 4, 9, 7)),
    "Conv1D": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               (2, 3, 11)),
    "Conv2DTranspose": (
        lambda mx: mx.gluon.nn.Conv2DTranspose(3, 3, strides=2, padding=1,
                                               output_padding=1),
        (2, 4, 5, 5)),
    "Conv2D in_channels": (
        lambda mx: mx.gluon.nn.Conv2D(3, 1, in_channels=4), (2, 4, 5, 5)),
    "MaxPool2D": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1), (2, 3, 9, 9)),
    "AvgPool2D": (lambda mx: mx.gluon.nn.AvgPool2D(3, 2, 1,
                                                   count_include_pad=False),
                  (2, 3, 9, 9)),
    "MaxPool1D": (lambda mx: mx.gluon.nn.MaxPool1D(3, 2, 1), (2, 3, 10)),
    "AvgPool1D": (lambda mx: mx.gluon.nn.AvgPool1D(2), (2, 3, 10)),
    "GlobalMaxPool2D": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(),
                        (2, 3, 5, 6)),
    "GlobalAvgPool2D": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(),
                        (2, 3, 5, 6)),
    "GlobalAvgPool1D": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(), (2, 3, 7)),
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(), (2, 3, 4, 5)),
    "Flatten": (lambda mx: mx.gluon.nn.Flatten(), (2, 3, 4, 5)),
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), (3, 7)),
    "PReLU": (lambda mx: mx.gluon.nn.PReLU(in_channels=3), (2, 3, 4)),
    "ELU": (lambda mx: mx.gluon.nn.ELU(0.7), (3, 7)),
    "SELU": (lambda mx: mx.gluon.nn.SELU(), (3, 7)),
    "Swish": (lambda mx: mx.gluon.nn.Swish(1.5), (3, 7)),
    "GELU": (lambda mx: mx.gluon.nn.GELU(), (3, 7)),
    "GELU tanh": (lambda mx: mx.gluon.nn.GELU("tanh"), (3, 7)),
    "HybridLambda": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.relu(x) * 2), (3, 7)),
    "HybridLambda name": (lambda mx: mx.gluon.nn.HybridLambda("tanh"),
                          (3, 7)),
    "Lambda": (lambda mx: mx.gluon.nn.Lambda("sigmoid"), (3, 7)),
    "Identity": (lambda mx: mx.gluon.contrib.nn.Identity(), (3, 7)),
    "PixelShuffle2D": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D((2, 3)),
                       (2, 12, 3, 4)),
    "HybridConcurrent": (lambda mx: _concurrent(mx, "HybridConcurrent"),
                         (2, 3, 6, 6)),
    "Concurrent": (lambda mx: _concurrent(mx, "Concurrent"), (2, 3, 6, 6)),
}


def _concurrent(mx, cls):
    net = getattr(mx.gluon.contrib.nn, cls)(axis=1)
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(2, 1), mx.gluon.nn.MaxPool2D(3, 1, 1),
                mx.gluon.contrib.nn.Identity())
    return net


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    factory, shape = LAYERS[name]
    jnet, tnet = (_build(mx, factory) for mx in SIDES)
    x = _x(shape, 1)
    jout, _ = _call(jmx, jnet, x)  # deferred shapes resolve here
    _call(tmx, tnet, x)
    assert _names(tnet) == _names(jnet)
    for k, p in tnet.collect_params().items():
        assert p.shape == jnet.collect_params()[k].shape, k
    _carry(jnet, tnet)
    jout, jgrad = _call(jmx, jnet, x, record=True)
    tout, tgrad = _call(tmx, tnet, x, record=True)
    np.testing.assert_allclose(tout, jout, **F32)
    np.testing.assert_allclose(tgrad, jgrad, **F32)


@pytest.mark.parametrize("name", ["Conv2D", "Conv2DTranspose", "MaxPool2D",
                                  "InstanceNorm", "PReLU"])
def test_layer_cast_bfloat16_matches_jax(name):
    factory, shape = LAYERS[name]
    jnet, tnet = (_build(mx, factory) for mx in SIDES)
    x = _x(shape, 2)
    _call(jmx, jnet, x)
    _call(tmx, tnet, x)
    _carry(jnet, tnet)
    for net in (jnet, tnet):
        net.cast("bfloat16")
    assert [p.dtype for p in tnet.collect_params().values()] == \
        [str(p.dtype) for p in jnet.collect_params().values()]
    jout, _ = _call(jmx, jnet, x, dtype="bfloat16")
    tout, _ = _call(tmx, tnet, x, dtype="bfloat16")
    np.testing.assert_allclose(tout, jout, **BF16)


def _bn(mx, **kw):
    net = mx.gluon.nn.HybridSequential(prefix="bnnet_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, use_bias=False),
                mx.gluon.nn.BatchNorm(**kw), mx.gluon.nn.Activation("relu"))
    return net


BN = {"default": {}, "momentum 0.7": dict(momentum=0.7, epsilon=1e-3),
      "no scale, no center": dict(scale=False, center=False),
      "use_global_stats": dict(use_global_stats=True),
      "SyncBatchNorm": None}


@pytest.mark.parametrize("case", sorted(BN))
def test_batchnorm_training_moves_statistics_as_jax(case):
    """Three recorded training calls, then an inference call: the outputs,
    input gradients and the moving statistics of both packages agree."""
    kw = BN[case]
    if kw is None:
        def factory(mx):
            net = mx.gluon.nn.HybridSequential(prefix="bnnet_")
            with net.name_scope():
                net.add(mx.gluon.nn.Conv2D(4, 3, padding=1),
                        mx.gluon.contrib.nn.SyncBatchNorm(num_devices=1))
            return net
    else:
        def factory(mx):
            return _bn(mx, **kw)
    jnet, tnet = (_build(mx, factory) for mx in SIDES)
    x0 = _x((4, 3, 6, 6), 3, 2.0) + 1.0
    _call(jmx, jnet, x0)
    _call(tmx, tnet, x0)
    assert _names(tnet) == _names(jnet)
    _carry(jnet, tnet)
    for step in range(3):
        x = _x((4, 3, 6, 6), 10 + step, 2.0) + 1.0
        jout, jgrad = _call(jmx, jnet, x, record=True)
        tout, tgrad = _call(tmx, tnet, x, record=True)
        np.testing.assert_allclose(tout, jout, **F32)
        np.testing.assert_allclose(tgrad, jgrad, **F32)
    jp = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    moved = False
    for k, p in tnet.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), jp[k], err_msg=k,
                                   **F32)
        if k.endswith("running_mean"):
            moved = bool(np.any(jp[k] != 0))
    assert moved == (kw is None or not kw.get("use_global_stats"))
    jout, _ = _call(jmx, jnet, x0)
    tout, _ = _call(tmx, tnet, x0)
    np.testing.assert_allclose(tout, jout, **F32)


def test_batchnorm_statistics_update_in_place_and_only_in_training():
    with tmx.cpu():
        net = _bn(tmx)
        net.initialize()
        x = tmx.nd.array(_x((4, 3, 5, 5), 4))
        net(x)
    rm = net.collect_params()["bnnet_batchnorm0_running_mean"]
    var, before = rm.tensor(), rm.data().asnumpy().copy()
    with tmx.cpu():
        net(x)  # an inference call: the statistics stay
        np.testing.assert_array_equal(rm.data().asnumpy(), before)
        with tmx.autograd.record():
            net(x)
    assert rm.tensor() is var and rm.tensor().dtype == torch.float32
    assert not np.array_equal(rm.data().asnumpy(), before)
    assert rm.is_state and not rm.tensor().requires_grad
    assert not net.collect_params()["bnnet_batchnorm0_gamma"].is_state


def test_batchnorm_cast_keeps_f32_parameters_as_jax():
    jnet, tnet = (_build(mx, _bn) for mx in SIDES)
    x = _x((4, 3, 6, 6), 5)
    _call(jmx, jnet, x)
    _call(tmx, tnet, x)
    _carry(jnet, tnet)
    for net in (jnet, tnet):
        net.cast("bfloat16")
    want = {k: str(p.dtype) for k, p in jnet.collect_params().items()}
    assert {k: p.dtype for k, p in tnet.collect_params().items()} == want
    assert want["bnnet_batchnorm0_running_var"] == "float32"
    assert want["bnnet_conv2d0_weight"] == "bfloat16"
    jout, jgrad = _call(jmx, jnet, x, record=True, dtype="bfloat16")
    tout, tgrad = _call(tmx, tnet, x, record=True, dtype="bfloat16")
    np.testing.assert_allclose(tout, jout, **BF16)
    np.testing.assert_allclose(tgrad, jgrad, **BF16)
    for k, p in tnet.collect_params().items():
        if "running" in k:
            np.testing.assert_allclose(
                p.data().asnumpy(), jnet.collect_params()[k].data().asnumpy(),
                err_msg=k, **BF16)


def test_batchnorm_axis_and_deferred_shape():
    jnet, tnet = (_build(mx, lambda m: m.gluon.nn.BatchNorm(axis=-1))
                  for mx in SIDES)
    x = _x((3, 5, 6), 6)
    _call(jmx, jnet, x)
    _call(tmx, tnet, x)
    assert [p.shape for p in tnet.collect_params().values()] == [(6,)] * 4
    _carry(jnet, tnet)
    jout, jgrad = _call(jmx, jnet, x, record=True)
    tout, tgrad = _call(tmx, tnet, x, record=True)
    np.testing.assert_allclose(tout, jout, **F32)
    np.testing.assert_allclose(tgrad, jgrad, **F32)


def test_sparse_embedding_matches_jax():
    jnet, tnet = (_build(mx, lambda m: m.gluon.contrib.nn.SparseEmbedding(
        10, 4)) for mx in SIDES)
    assert _names(tnet) == _names(jnet)
    _carry(jnet, tnet)
    x = np.array([[1, 3], [9, 0]], np.float32)
    np.testing.assert_allclose(_call(tmx, tnet, x)[0],
                               _call(jmx, jnet, x)[0], **F32)


def test_conv3d_constructs_and_its_forward_raises_as_jax():
    jnet, tnet = (_build(mx, lambda m: m.gluon.nn.Conv3D(2, 3, in_channels=2))
                  for mx in SIDES)
    assert _names(tnet) == _names(jnet)
    assert tnet.collect_params()[list(tnet.collect_params())[0]].shape == \
        (2, 2, 3, 3, 3)
    x = _x((1, 2, 4, 4, 4), 7)
    with pytest.raises(Exception):
        _call(jmx, jnet, x)
    with pytest.raises(ValueError, match="1-D and 2-D"):
        _call(tmx, tnet, x)

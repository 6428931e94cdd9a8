"""The port's ``L2Normalization``, ``RMSNorm`` (and ``_contrib_rms_norm``),
``UpSampling`` and ``BilinearResize2D`` (and ``_contrib_BilinearResize2D``)
against the JAX package's ops on the same seeded numpy inputs, values and
gradients. ``UpSampling(sample_type="bilinear")`` raises in the port (the
JAX op computes nearest whatever it is given). ``BilinearResize2D`` follows
``jax.image.resize(method="linear")``: half-pixel centres, antialiased on a
downscale. Tolerances: f32 1e-5 relative; bf16 RMSNorm one bf16 ulp
(2^-7 relative)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-6)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _both(jfn, tfn, x, cot, **kw):
    jo, vjp = jax.vjp(lambda a: jfn(a, **kw), jnp.asarray(x))
    jg = vjp(jnp.asarray(cot))[0]
    t = torch.from_numpy(x).requires_grad_()
    to = tfn(t, **kw)
    to.backward(torch.from_numpy(cot))
    return (to.detach().numpy(), np.asarray(jo)), (t.grad.numpy(),
                                                   np.asarray(jg))


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (3, 6, 7)])
def test_l2_normalization_matches_jax(mode, shape):
    x, cot = _x(shape, 1), _x(shape, 2)
    (to, jo), (tg, jg) = _both(jnn.l2_normalization, tnn.l2_normalization, x,
                               cot, mode=mode, eps=1e-6)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    with tmx.cpu():
        got = tnd.L2Normalization(tnd.array(x), mode=mode).asnumpy()
    np.testing.assert_allclose(
        got, np.asarray(jnn.l2_normalization(jnp.asarray(x), mode=mode)),
        **F32)


@pytest.mark.parametrize("name", ["RMSNorm", "_contrib_rms_norm"])
def test_rms_norm_matches_jax(name):
    x, g, cot = _x((4, 6, 16), 3), _x((16,), 4), _x((4, 6, 16), 5)
    (to, jo), (tg, jg) = _both(lambda a: jnn.rms_norm(a, jnp.asarray(g)),
                               lambda a: tnn.rms_norm(a, torch.from_numpy(g)),
                               x, cot)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    with tmx.cpu():
        got = getattr(tnd, name)(tnd.array(x), tnd.array(g), eps=1e-5)
    np.testing.assert_allclose(
        got.asnumpy(), np.asarray(jnn.rms_norm(jnp.asarray(x),
                                               jnp.asarray(g), eps=1e-5)),
        **F32)


def test_rms_norm_bf16_matches_jax():
    x, g = _x((8, 32), 6), _x((32,), 7)
    want = np.asarray(jnn.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(g, jnp.bfloat16))
                      .astype(jnp.float32))
    got = tnn.rms_norm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("scale", [2, 3])
def test_upsampling_matches_jax(scale):
    x, cot = _x((2, 3, 4, 5), 8), _x((2, 3, 4 * scale, 5 * scale), 9)
    (to, jo), (tg, jg) = _both(jnn.upsampling, tnn.upsampling, x, cot,
                               scale=scale)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg, jg, **F32)
    with tmx.cpu():
        got = tnd.UpSampling(tnd.array(x), scale=scale, sample_type="nearest")
    np.testing.assert_array_equal(got.asnumpy(), jo)


def test_upsampling_bilinear_raises():
    with pytest.raises(NotImplementedError, match="bilinear"):
        tnn.upsampling(torch.zeros(1, 1, 2, 2), scale=2,
                       sample_type="bilinear")


RESIZES = [dict(height=34, width=46), dict(height=40, width=31),
           dict(height=8, width=11), dict(height=5, width=7),
           dict(scale_height=2.0, scale_width=0.5)]


@pytest.mark.parametrize("kw", RESIZES, ids=[str(r) for r in RESIZES])
@pytest.mark.parametrize("name", ["BilinearResize2D",
                                  "_contrib_BilinearResize2D"])
def test_bilinear_resize_up_and_down_matches_jax(kw, name):
    x = _x((2, 3, 17, 23), 10)
    jo = np.asarray(jnn.bilinear_resize(jnp.asarray(x), **kw))
    cot = _x(jo.shape, 11)
    (to, jo2), (tg, jg) = _both(jnn.bilinear_resize, tnn.bilinear_resize, x,
                                cot, **kw)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-5)
    with tmx.cpu():
        got = getattr(tnd, name)(tnd.array(x), **kw).asnumpy()
    np.testing.assert_allclose(got, jo, **F32)


def test_bilinear_resize_keeps_a_low_precision_dtype():
    x = torch.from_numpy(_x((1, 2, 9, 9), 12)).bfloat16()
    out = tnn.bilinear_resize(x, height=4, width=4)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 4, 4)

"""``gluon.utils`` of the port against the JAX package's on the same seeded
numpy inputs: ``split_data`` (even and uneven, any batch axis),
``split_and_load`` (one context: one array on it; several: a slice on
each), ``clip_global_norm`` (the returned norm, the arrays scaled in place,
a warning for a norm that is not finite; f32 1e-6 relative) and
``check_sha1``. ``download`` is not ported."""
import hashlib
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import utils as tutils

JU = jmx.gluon.utils


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,num,axis,even", [
    ((6, 4), 3, 0, True), ((4, 7), 2, 1, False), ((5, 2, 3), 2, 0, False)])
def test_split_data_matches_jax(shape, num, axis, even):
    x = _x(shape, 1)
    want = [s.asnumpy() for s in JU.split_data(jnd.array(x), num, axis, even)]
    with tmx.cpu():
        got = [s.asnumpy() for s in tutils.split_data(tnd.array(x), num, axis,
                                                      even)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_split_data_refuses_an_uneven_even_split():
    with tmx.cpu():
        with pytest.raises(ValueError, match="not divisible"):
            tutils.split_data(tnd.zeros((5, 2)), 2)


def test_split_and_load_on_one_and_several_contexts():
    x = _x((4, 3), 2)
    one = tutils.split_and_load(x, [tmx.cpu()])
    assert len(one) == 1 and one[0].context == tmx.cpu()
    np.testing.assert_array_equal(one[0].asnumpy(), x)
    parts = tutils.split_and_load(x, [tmx.cpu(0), tmx.cpu(1)])
    assert [p.shape for p in parts] == [(2, 3), (2, 3)]
    np.testing.assert_array_equal(np.concatenate([p.asnumpy() for p in parts]),
                                  x)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches_jax(max_norm):
    arrays = [_x((3, 4), 3), _x((5,), 4), _x((2, 2, 2), 5)]
    jarr = [jnd.array(a) for a in arrays]
    jnorm = JU.clip_global_norm(jarr, max_norm)
    with tmx.cpu():
        tarr = [tnd.array(a) for a in arrays]
        handles = [t._data for t in tarr]
        tnorm = tutils.clip_global_norm(tarr, max_norm)
    assert isinstance(tnorm, float)
    assert abs(tnorm - jnorm) <= 1e-6 * jnorm
    for t, j, h in zip(tarr, jarr, handles):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   atol=1e-7)
        assert t._data is h  # scaled in place


def test_clip_global_norm_warns_on_a_norm_that_is_not_finite():
    with tmx.cpu():
        arrays = [tnd.array(np.array([1.0, np.inf], np.float32))]
        with pytest.warns(UserWarning, match="nan or inf"):
            norm = tutils.clip_global_norm(arrays, 1.0)
        assert not np.isfinite(norm)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            tutils.clip_global_norm(arrays, 1.0, check_isfinite=False)


def test_check_sha1(tmp_path):
    f = tmp_path / "blob.bin"
    f.write_bytes(b"mxnet" * 1000)
    digest = hashlib.sha1(b"mxnet" * 1000).hexdigest()
    assert tutils.check_sha1(str(f), digest) and JU.check_sha1(str(f), digest)
    assert not tutils.check_sha1(str(f), "0" * 40)


def test_the_module_has_the_jax_names_but_download():
    assert set(tutils.__all__) == set(JU.__all__) - {"download"}
    assert tmx.gluon.utils is tutils

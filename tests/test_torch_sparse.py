"""The port's row-sparse and CSR storage (``nd.sparse``), its storage
dispatch, the lazy optimizer updates, ``Embedding(sparse_grad=True)``,
``SparseEmbedding`` and sparse ``.params`` against the JAX package's
(``mxnet_tpu/ndarray/sparse.py`` and its hooks) on the same numpy inputs:
every case of tests/test_sparse.py that needs no kvstore, run in both
packages, plus the Trainer's lazy SGD, SGD-momentum and Adam against the
JAX Trainer from the same weights, a sparse-gradient word LM at a narrow
width against the JAX one, ``TrainStep`` on a sparse-gradient net against
its dense twin, and ``.params`` files byte-equal both ways.

Tolerances: storage casts, slicing, retain, the lazy rows and every
untouched row exact; ``dot(csr, dense)`` rtol 1e-5, atol 1e-5 (the
products are summed in another order than numpy's matmul); the lazy
updates and three Trainer steps rtol 1e-6, atol 1e-6 (the port's Adam
folds the bias correction into the rate, as its kernel does); the word
LM's losses rtol 1e-5 and its weights within the Adam sign-flip bound of
tests/test_torch_word_lm.py."""
import struct
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.ndarray import sparse as tsp

from test_torch_vision_layers import name_counters  # noqa: F401

LAZY = dict(rtol=1e-6, atol=1e-6)
DOT = dict(rtol=1e-5, atol=1e-5)


def _rand_dense_rows(shape, density=0.3, seed=0):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-1, 1, shape).astype(np.float32)
    a[rs.uniform(size=shape[0]) >= density] = 0
    return a


def _both(fn):
    """``fn(mx, sparse)`` in the JAX package, then in the port on the
    CPU."""
    j = fn(jmx, jsp)
    with tmx.cpu():
        t = fn(tmx, tsp)
    return j, t


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# -- tests/test_sparse.py, case by case ----------------------------------------
def test_cast_storage_row_sparse_roundtrip():
    a = _rand_dense_rows((10, 4))

    def run(mx, sp):
        rsp = mx.nd.array(a).tostype("row_sparse")
        back = rsp.tostype("default")
        return rsp.stype, rsp.shape, rsp.asnumpy(), _np(rsp.indices), \
            back.stype, back.asnumpy()
    j, t = _both(run)
    assert t[0] == j[0] == "row_sparse" and t[1] == j[1] == (10, 4)
    assert t[4] == j[4] == "default"
    for x, y in zip(t[2:], j[2:]):
        if not isinstance(x, str):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t[2], a)
    assert _np(t[3]).dtype == np.int32


def test_cast_storage_csr_roundtrip():
    rs = np.random.RandomState(1)
    a = rs.uniform(-1, 1, (6, 8)).astype(np.float32)
    a[a < 0.3] = 0

    def run(mx, sp):
        csr = mx.nd.array(a).tostype("csr")
        return (csr.stype, csr.asnumpy(), _np(csr.indptr), _np(csr.indices),
                _np(csr.data), csr.tostype("default").asnumpy())
    j, t = _both(run)
    assert t[0] == j[0] == "csr"
    for x, y in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t[1], a)
    assert t[2][0] == 0 and t[2][-1] == t[4].shape[0]
    assert t[2].dtype == t[3].dtype == np.int32


def test_row_sparse_array_from_tuple():
    data = np.arange(6, dtype=np.float32).reshape(3, 2)
    idx = np.array([4, 1, 7])

    def run(mx, sp):
        rsp = sp.row_sparse_array((data, idx), shape=(9, 2))
        return rsp.asnumpy(), _np(rsp.indices), _np(rsp.data)
    j, t = _both(run)
    dense = np.zeros((9, 2), np.float32)
    dense[idx] = data
    np.testing.assert_array_equal(t[0], dense)
    np.testing.assert_array_equal(t[1], [1, 4, 7])
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)


def test_csr_matrix_from_tuple_and_row_slice():
    expect = np.array([[1, 0, 2], [0, 0, 0], [0, 3, 0]], np.float32)

    def run(mx, sp):
        csr = sp.csr_matrix((np.array([1., 2., 3.], np.float32),
                             np.array([0, 2, 1]), np.array([0, 2, 2, 3])),
                            shape=(3, 3))
        sl = csr[1:3]
        return csr.asnumpy(), sl.asnumpy(), _np(sl.indptr)
    j, t = _both(run)
    np.testing.assert_array_equal(t[0], expect)
    np.testing.assert_array_equal(t[1], expect[1:3])
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)
    with tmx.cpu(), pytest.raises(TError, match="step=1"):
        tsp.csr_matrix(tmx.nd.array(expect))[::2]


def test_sparse_retain():
    a = _rand_dense_rows((8, 3), density=1.0, seed=2)

    def run(mx, sp):
        rsp = sp.row_sparse_array(mx.nd.array(a))
        kept = sp.retain(rsp, mx.nd.array([1, 5], dtype="int64"))
        return kept.asnumpy(), _np(kept.indices), rsp.retain([0]).asnumpy()
    j, t = _both(run)
    expect = np.zeros_like(a)
    expect[[1, 5]] = a[[1, 5]]
    np.testing.assert_array_equal(t[0], expect)
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_dense(transpose_a):
    rs = np.random.RandomState(3)
    a = rs.uniform(-1, 1, (5, 7)).astype(np.float32)
    a[np.abs(a) < 0.5] = 0
    a[2] = 0  # a row with no nonzero
    b = rs.uniform(-1, 1, (5 if transpose_a else 7, 4)).astype(np.float32)

    def run(mx, sp):
        csr = mx.nd.array(a).tostype("csr")
        return (sp.dot(csr, mx.nd.array(b), transpose_a=transpose_a)
                .asnumpy(),
                mx.nd.dot(csr, mx.nd.array(b), transpose_a=transpose_a)
                .asnumpy())
    j, t = _both(run)
    expect = (a.T if transpose_a else a) @ b
    for x in (*t, *j):
        np.testing.assert_allclose(x, expect, **DOT)
    np.testing.assert_allclose(t[0], j[0], **DOT)
    np.testing.assert_array_equal(t[0], t[1])


def test_csr_dot_transpose_b_and_other_storages_densify():
    rs = np.random.RandomState(4)
    a = rs.uniform(-1, 1, (4, 6)).astype(np.float32)
    a[a < 0] = 0
    b = rs.uniform(-1, 1, (3, 6)).astype(np.float32)
    with tmx.cpu():
        csr = tmx.nd.array(a).tostype("csr")
        out = tsp.dot(csr, tmx.nd.array(b), transpose_b=True).asnumpy()
        rsp = tmx.nd.array(a).tostype("row_sparse")
        dense = tsp.dot(rsp, tmx.nd.array(b.T)).asnumpy()
    np.testing.assert_allclose(out, a @ b.T, **DOT)
    np.testing.assert_allclose(dense, a @ b.T, **DOT)


def test_rsp_add_rsp():
    a = _rand_dense_rows((10, 3), seed=5)
    b = _rand_dense_rows((10, 3), seed=6)

    def run(mx, sp):
        ra = mx.nd.array(a).tostype("row_sparse")
        rb = mx.nd.array(b).tostype("row_sparse")
        out, out2 = sp.add(ra, rb), ra + rb
        return (out.stype, out2.stype, out.asnumpy(), out2.asnumpy(),
                _np(out.indices), sp.subtract(ra, rb).asnumpy(),
                sp.multiply(ra, rb).asnumpy())
    j, t = _both(run)
    assert t[:2] == j[:2] == ("row_sparse", "row_sparse")
    np.testing.assert_allclose(t[2], a + b, rtol=1e-6)
    for x, y in zip(t[2:], j[2:]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(t[5], a - b)
    np.testing.assert_array_equal(t[6], a * b)


def test_sparse_zeros():
    def run(mx, sp):
        z = sp.zeros("row_sparse", (4, 2))
        zc = sp.zeros("csr", (3, 5))
        return (z.stype, z.shape, z.asnumpy(), zc.stype, zc.shape,
                zc.asnumpy(), sp.zeros("default", (2,)).asnumpy())
    j, t = _both(run)
    assert t[0] == "row_sparse" and t[1] == (4, 2) and t[3] == "csr"
    for x, y in zip(t, j):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with tmx.cpu(), pytest.raises(TError, match="unknown storage"):
        tsp.zeros("coo", (2, 2))


def _sparse_dict(mx, a, b):
    return {"rsp": mx.nd.array(a).tostype("row_sparse"),
            "csr": mx.nd.array(b).tostype("csr"), "dense": mx.nd.array(b)}


def _save_load_inputs():
    a = _rand_dense_rows((6, 2), seed=7)
    b = np.random.RandomState(8).uniform(size=(3, 3)).astype(np.float32)
    b[b < 0.5] = 0
    return a, b


def test_sparse_save_load(tmp_path):
    a, b = _save_load_inputs()
    fname = str(tmp_path / "mixed.params")
    with tmx.cpu():
        tmx.nd.save(fname, _sparse_dict(tmx, a, b))
        loaded = tmx.nd.load(fname)
    assert loaded["rsp"].stype == "row_sparse"
    assert loaded["csr"].stype == "csr"
    assert loaded["dense"].stype == "default"
    np.testing.assert_array_equal(loaded["rsp"].asnumpy(), a)
    np.testing.assert_array_equal(loaded["csr"].asnumpy(), b)
    assert loaded["rsp"]._aux[0].dtype == torch.int32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sparse_params_files_are_byte_equal(writer, tmp_path):
    """Both packages write the same bytes for the same arrays, and each
    reads the other's file."""
    a, b = _save_load_inputs()
    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jmx.nd.save(jf, _sparse_dict(jmx, a, b))
    with tmx.cpu():
        tmx.nd.save(tf, _sparse_dict(tmx, a, b))
    with open(jf, "rb") as f1, open(tf, "rb") as f2:
        assert f1.read() == f2.read()
    src = jf if writer == "jax" else tf
    with tmx.cpu():
        got = tmx.nd.load(src)
    want = jmx.nd.load(src)
    for k in want:
        assert got[k].stype == want[k].stype
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())


def test_upstream_sparse_magic_is_refused(tmp_path):
    fname = str(tmp_path / "up.params")
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, 1))
        f.write(struct.pack("<I", 0xF993FACA))
    with pytest.raises(JError, match="0xf993faca"):
        jmx.nd.load(fname)
    with pytest.raises(TError, match="0xf993faca"):
        tmx.nd.load(fname)


def test_optimizer_lazy_update_rows_only():
    """Rows absent from a row_sparse gradient are not touched (SGD with
    momentum, two updates: the momentum state is scattered back)."""
    def run(mx, sp):
        opt = mx.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                               rescale_grad=1.0, wd=0.0)
        w = mx.nd.array(np.ones((6, 3), np.float32))
        state = opt.create_state(0, w if mx is jmx else w._data)
        g = sp.row_sparse_array((np.full((2, 3), 2.0, np.float32),
                                 np.array([1, 4])), shape=(6, 3))
        state = opt.update(0, w, g, state)
        got = w.asnumpy().copy()
        opt.update(0, w, g, state)
        return got, w.asnumpy()
    (j1, j2), (t1, t2) = _both(run)
    np.testing.assert_allclose(t1[[0, 2, 3, 5]], 1.0)
    np.testing.assert_allclose(t1[[1, 4]], 1.0 - 0.5 * 2.0)
    np.testing.assert_allclose(t2[[0, 2, 3, 5]], 1.0)
    assert np.all(t2[[1, 4]] < t1[[1, 4]])
    np.testing.assert_allclose(t1, j1, **LAZY)
    np.testing.assert_allclose(t2, j2, **LAZY)


def test_sparse_errors():
    with tmx.cpu():
        with pytest.raises(TError):
            tmx.nd.array(np.ones((3,))).tostype("row_sparse")  # ndim < 2
        with pytest.raises(TError):
            tsp.csr_matrix((np.ones(1), np.zeros(1), np.array([0, 1])))
        with pytest.raises(TError):
            tmx.nd.array(np.ones((2, 2, 2))).tostype("csr")
        with pytest.raises(TError, match="immutable"):
            tmx.nd.array(np.eye(2)).tostype("row_sparse")[0] = 1
        with pytest.raises(TError, match="sparse input"):
            tsp.array(np.ones((2, 2)))


def test_int64_indices_narrow_cleanly():
    data = np.ones((3, 2), np.float32)
    idx = np.array([0, 2, 5], np.int64)
    with tmx.cpu(), warnings.catch_warnings():
        warnings.simplefilter("error")
        rsp = tsp.row_sparse_array((data, idx), shape=(6, 2))
        rsp_t = tsp.row_sparse_array((torch.ones(3, 2),
                                      torch.tensor([0, 2, 5])), shape=(6, 2))
    for r in (rsp, rsp_t):
        assert r._aux[0].dtype == torch.int32
        np.testing.assert_array_equal(r._aux[0].numpy(), [0, 2, 5])


def test_int64_indices_overflow_raises():
    data = np.ones((2, 2), np.float32)
    for idx in (np.array([0, 2 ** 40], np.int64), torch.tensor([0, 2 ** 40])):
        with tmx.cpu(), pytest.raises(TError, match="int32 range"):
            tsp.row_sparse_array((data, idx), shape=(2 ** 40 + 1, 2))


def test_int64_csr_narrow_and_overflow():
    data = np.array([1.0, 2.0], np.float32)
    indices = np.array([0, 1], np.int64)
    indptr = np.array([0, 1, 2], np.int64)
    with tmx.cpu():
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            csr = tsp.csr_matrix((data, indices, indptr), shape=(2, 2))
        assert csr._aux[0].dtype == csr._aux[1].dtype == torch.int32
        with pytest.raises(TError, match="int32 range"):
            tsp.csr_matrix((data, np.array([0, 2 ** 35], np.int64), indptr),
                           shape=(2, 2 ** 35 + 1))


def test_int64_params_roundtrip(tmp_path):
    """An int64 payload stays int64 on disk (the same bytes as the JAX
    package's file); ``nd.load`` narrows it with a check and raises on a
    value out of the int32 range, as the JAX load does."""
    from mxnet_tpu.serialization import save_ndarrays as jsave
    from mxnet_tpu_torch.serialization import save_ndarrays as tsave

    jf, tf = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    vals = np.array([1, 2 ** 20, -5], np.int64)
    jsave(jf, {"x": vals})
    tsave(tf, {"x": vals})
    with open(jf, "rb") as f1, open(tf, "rb") as f2:
        assert f1.read() == f2.read()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = tmx.nd.load(tf)
    assert back["x"]._data.dtype == torch.int32
    np.testing.assert_array_equal(back["x"].asnumpy(), vals)
    tsave(tf, {"big": np.array([2 ** 40], np.int64)})
    with pytest.raises(TError, match="int32 range"):
        tmx.nd.load(tf)


def test_storage_fallback_warns_once():
    """An op without a sparse handler densifies its sparse inputs and
    warns once per op name; the knob silences it."""
    from mxnet_tpu_torch import config
    from mxnet_tpu_torch.ndarray import _DENSIFY_WARNED

    _DENSIFY_WARNED.discard("tanh")
    _DENSIFY_WARNED.discard("sigmoid")
    with tmx.cpu():
        rsp = tsp.row_sparse_array(
            (np.ones((2, 3), np.float32), np.array([0, 2], np.int64)),
            shape=(4, 3))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out = tmx.nd.tanh(rsp)
            tmx.nd.tanh(rsp)  # second call: no new warning
        config.set("storage_fallback_warn", False)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                tmx.nd.sigmoid(rsp)
        finally:
            config.set("storage_fallback_warn", True)
    fallback = [x for x in w
                if "storage type fallback" in str(x.message).lower()]
    assert len(fallback) == 1
    assert out.stype == "default"
    np.testing.assert_allclose(out.asnumpy(), np.tanh(rsp.asnumpy()),
                               rtol=1e-6)


def test_storage_dispatch_dot_csr_no_densify_warning():
    dense = np.zeros((4, 3), np.float32)
    dense[0, 1] = 2.0
    dense[2, 2] = 3.0
    rhs = np.random.RandomState(0).rand(3, 5).astype(np.float32)
    with tmx.cpu(), warnings.catch_warnings():
        warnings.simplefilter("error")  # any densify warning fails
        csr = tsp.cast_storage(tmx.nd.array(dense), "csr")
        out = tmx.nd.dot(csr, tmx.nd.array(rhs))
        same = tmx.nd.cast_storage(csr, "csr")
    np.testing.assert_allclose(out.asnumpy(), dense @ rhs, rtol=1e-5)
    assert same is csr


def test_registry_lazy_sgd_touches_only_live_rows():
    """``nd.sgd_update(..., lazy_update=True)`` with a row-sparse gradient:
    rows it does not hold see no update, not even weight decay."""
    def run(mx, sp):
        w = mx.nd.array(np.ones((6, 3), np.float32))
        grad = sp.row_sparse_array((np.full((2, 3), 1.0, np.float32),
                                    [1, 4]), shape=(6, 3))
        return (mx.nd.sgd_update(w, grad, lr=0.5, wd=0.1, lazy_update=True)
                .asnumpy(),
                mx.nd.sgd_update(w, grad, lr=0.5, wd=0.1).asnumpy())
    (j, jd), (t, td) = _both(run)
    np.testing.assert_allclose(t[[1, 4]], 0.45, rtol=1e-6)
    np.testing.assert_array_equal(t[[0, 2, 3, 5]], 1.0)
    np.testing.assert_allclose(t, j, **LAZY)
    # without lazy_update the densified gradient decays every row
    np.testing.assert_allclose(td[[0, 2, 3, 5]], 0.95, rtol=1e-6)
    np.testing.assert_allclose(td, jd, **LAZY)


def test_registry_lazy_sgd_mom_and_out():
    """``sgd_mom_update(lazy_update=True)``: the momentum's rows outside
    the gradient stay as they were; ``out=`` writes weight and state."""
    rs = np.random.RandomState(9)
    w0 = rs.randn(5, 2).astype(np.float32)
    m0 = rs.randn(5, 2).astype(np.float32)
    g = rs.randn(2, 2).astype(np.float32)

    def run(mx, sp):
        grad = sp.row_sparse_array((g, [0, 3]), shape=(5, 2))
        new_w, new_m = mx.nd.sgd_mom_update(
            mx.nd.array(w0), grad, mx.nd.array(m0), lr=0.1, momentum=0.9,
            wd=0.01, lazy_update=True)
        return new_w.asnumpy(), new_m.asnumpy()
    (jw, jm), (tw, tm) = _both(run)
    np.testing.assert_array_equal(tw[[1, 2, 4]], w0[[1, 2, 4]])
    np.testing.assert_array_equal(tm[[1, 2, 4]], m0[[1, 2, 4]])
    np.testing.assert_allclose(tw, jw, **LAZY)
    np.testing.assert_allclose(tm, jm, **LAZY)
    with tmx.cpu():
        w, m = tmx.nd.array(w0), tmx.nd.array(m0)
        grad = tsp.row_sparse_array((g, [0, 3]), shape=(5, 2))
        tmx.nd.sgd_mom_update(w, grad, m, lr=0.1, momentum=0.9, wd=0.01,
                              lazy_update=True, out=w)
    np.testing.assert_array_equal(w.asnumpy(), tw)
    np.testing.assert_array_equal(m.asnumpy(), tm)


def test_registry_lazy_adam_states_rows_only():
    def run(mx, sp):
        w = mx.nd.array(np.ones((5, 2), np.float32))
        mean = mx.nd.array(np.zeros((5, 2), np.float32))
        var = mx.nd.array(np.zeros((5, 2), np.float32))
        grad = sp.row_sparse_array((np.full((1, 2), 2.0, np.float32), [3]),
                                   shape=(5, 2))
        return [x.asnumpy() for x in mx.nd.adam_update(
            w, grad, mean, var, lr=0.1, wd=0.01, lazy_update=True)]
    j, (tw, tm, tv) = _both(run)
    assert not np.allclose(tw[3], 1.0)
    np.testing.assert_array_equal(tw[[0, 1, 2, 4]], 1.0)
    np.testing.assert_array_equal(tm[[0, 1, 2, 4]], 0.0)
    assert np.all(tm[3] != 0.0)
    for x, y in zip((tw, tm, tv), j):
        np.testing.assert_allclose(x, y, **LAZY)


# -- Embedding(sparse_grad=True) and the Trainer --------------------------------
def _emb_net(mx, vocab, dim, w_emb, w_out, b_out, sparse=True):
    with (jmx.cpu() if mx is jmx else tmx.cpu()):
        emb = mx.gluon.nn.Embedding(vocab, dim, sparse_grad=sparse)
        out = mx.gluon.nn.Dense(1, in_units=2 * dim)
        emb.initialize()
        out.initialize()
        emb.collect_params()[emb.prefix + "weight"].set_data(
            mx.nd.array(w_emb))
        po = out.collect_params()
        po[out.prefix + "weight"].set_data(mx.nd.array(w_out))
        po[out.prefix + "bias"].set_data(mx.nd.array(b_out))
    return emb, out


def _emb_weights(vocab, dim, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(vocab, dim).astype(np.float32),
            rs.randn(1, 2 * dim).astype(np.float32) * 0.3,
            rs.randn(1).astype(np.float32) * 0.1)


ID_BATCHES = [np.array([[1, 3], [3, 7]]), np.array([[7, 9], [2, 9]]),
              np.array([[3, 1], [11, 3]])]


def _emb_train(mx, opt, kw, vocab=20, dim=4, steps=3, sparse=True):
    emb, out = _emb_net(mx, vocab, dim, *_emb_weights(vocab, dim),
                        sparse=sparse)
    params = {**emb.collect_params(), **out.collect_params()}
    trainer = mx.gluon.Trainer(params, opt, dict(kw))
    losses = []
    with (jmx.cpu() if mx is jmx else tmx.cpu()):
        for ids in ID_BATCHES[:steps]:
            with mx.autograd.record():
                h = emb(mx.nd.array(ids, dtype="int32")).reshape((2, -1))
                loss = (out(h) ** 2).sum()
            loss.backward()
            trainer.step(2)
            losses.append(float(loss.asnumpy()))
    w = emb.collect_params()[emb.prefix + "weight"].data().asnumpy()
    return losses, w, out.collect_params()[out.prefix + "weight"] \
        .data().asnumpy(), trainer


LAZY_OPTS = {"sgd": {"learning_rate": 0.5, "wd": 0.01},
             "sgd_momentum": {"learning_rate": 0.5, "momentum": 0.9,
                              "wd": 0.01},
             "adam": {"learning_rate": 0.05, "wd": 0.01}}


@pytest.mark.parametrize("name", sorted(LAZY_OPTS))
def test_trainer_lazy_update_matches_jax(name, name_counters):  # noqa: F811
    """3 steps of the Trainer on an Embedding(sparse_grad=True) + Dense
    net from the same weights: losses and weights as the JAX Trainer's;
    rows no batch touched bit-identical to their start despite wd > 0
    (the dense Dense takes the dense update as in JAX)."""
    opt = "sgd" if name.startswith("sgd") else name
    jl, jw, jo, jtr = _emb_train(jmx, opt, LAZY_OPTS[name])
    tl, tw, to, ttr = _emb_train(tmx, opt, LAZY_OPTS[name])
    np.testing.assert_allclose(tl, jl, **LAZY)
    np.testing.assert_allclose(tw, jw, **LAZY)
    np.testing.assert_allclose(to, jo, **LAZY)
    w0 = _emb_weights(20, 4)[0]
    touched = sorted(set(np.concatenate([b.ravel() for b in ID_BATCHES])))
    untouched = [r for r in range(20) if r not in touched]
    np.testing.assert_array_equal(tw[untouched], w0[untouched])
    assert not np.allclose(tw[touched], w0[touched])
    assert ttr.optimizer._index_update_count == \
        jtr.optimizer._index_update_count


def test_embedding_sparse_grad_end_to_end_no_densify(
        name_counters):  # noqa: F811
    """No densify warning on the whole path, untouched rows exact under
    wd > 0, and the loss falls."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        losses, w, _, _ = _emb_train(tmx, "sgd",
                                     {"learning_rate": 0.1, "wd": 0.01})
    assert losses[-1] < losses[0]
    w0 = _emb_weights(20, 4)[0]
    untouched = [0, 4, 5, 6, 8, 10] + list(range(12, 20))
    np.testing.assert_array_equal(w[untouched], w0[untouched])


def test_sparse_rows_are_a_sorted_union_until_the_update(
        name_counters):  # noqa: F811
    """Rows recorded by several forwards before one update are their
    sorted union (int32, np.union1d's); the update clears them."""
    emb, out = _emb_net(tmx, 20, 4, *_emb_weights(20, 4))
    p = emb.collect_params()[emb.prefix + "weight"]
    tr = tmx.gluon.Trainer({**emb.collect_params(), **out.collect_params()},
                           "sgd", {"learning_rate": 0.1})
    with tmx.cpu():
        with tmx.autograd.record():
            a = emb(tmx.nd.array(np.array([[9, 3]]), dtype="int32"))
            b = emb(tmx.nd.array(np.array([[3, 1], [12, 9]]),
                                 dtype="int32"))
            loss = (a.sum() + b.sum()) * 1.0
        loss.backward()
        assert p._sparse_rows.dtype == torch.int32
        np.testing.assert_array_equal(p._sparse_rows.numpy(),
                                      np.union1d([9, 3], [3, 1, 12, 9]))
        tr.step(1)
    assert p._sparse_rows is None


def test_embedding_sparse_grad_symbolic_export(tmp_path):
    """Exporting a sparse_grad Embedding traces it on Symbols, which
    ``_record_rows`` leaves alone; the exported graph loads in JAX."""
    with tmx.cpu():
        emb = tmx.gluon.nn.Embedding(20, 4, sparse_grad=True)
        emb.initialize()
        emb.hybridize()
        ids = tmx.nd.array(np.array([[1, 2]]), dtype="int32")
        want = emb(ids).asnumpy()
        emb.export(str(tmp_path / "emb"))
    assert (tmp_path / "emb-symbol.json").exists()
    assert emb.collect_params()[emb.prefix + "weight"]._sparse_rows is None
    blk = jmx.gluon.SymbolBlock.imports(str(tmp_path / "emb-symbol.json"),
                                        ["data"],
                                        str(tmp_path / "emb-0000.params"))
    np.testing.assert_array_equal(
        blk(jmx.nd.array(np.array([[1, 2]]), dtype="int32")).asnumpy(), want)


def test_embedding_sparse_rows_skip_inference_forwards():
    """Rows touched only by inference batches are not in the next lazy
    update; only recorded forwards count."""
    with tmx.cpu():
        emb = tmx.gluon.nn.Embedding(20, 4, sparse_grad=True)
        emb.initialize()
        p = emb.collect_params()[emb.prefix + "weight"]
        emb(tmx.nd.array(np.array([[5, 6]]), dtype="int32"))
        with tmx.autograd.pause():
            emb(tmx.nd.array(np.array([[7]]), dtype="int32"))
        assert p._sparse_rows is None
        with tmx.autograd.record():
            emb(tmx.nd.array(np.array([[1, 2]]), dtype="int32"))
    assert set(p._sparse_rows.tolist()) == {1, 2}
    assert p.grad_stype == "row_sparse" and p.stype == "default"


def test_parameter_storage_types():
    for side, err in ((jmx, None), (tmx, TError)):
        p = side.gluon.Parameter("w", shape=(3, 2), stype="row_sparse",
                                 grad_stype="row_sparse")
        assert (p.stype, p.grad_stype, p._sparse_rows) == \
            ("row_sparse", "row_sparse", None)
    with pytest.raises(TError, match="grad_stype"):
        tmx.gluon.Parameter("w", shape=(3, 2), grad_stype="coo")


def test_sparse_embedding_has_a_row_sparse_gradient(
        name_counters):  # noqa: F811
    """``gluon.contrib.nn.SparseEmbedding``: JAX's names and forward; its
    weight's gradient is row-sparse, so a Trainer step updates only the
    touched rows, as JAX's ``Embedding(sparse_grad=True)`` does (the JAX
    alias itself builds a dense Embedding)."""
    w0 = _emb_weights(12, 3, seed=4)[0]
    ids = np.array([[2, 5, 5]])
    jnames = jmx.gluon.contrib.nn.SparseEmbedding(
        12, 3)._collect_params_with_prefix()
    with tmx.cpu():
        tnames = tmx.gluon.contrib.nn.SparseEmbedding(
            12, 3)._collect_params_with_prefix()
    assert list(jnames) == ["embedding.weight"] == list(tnames)
    assert tnames["embedding.weight"].grad_stype == "row_sparse"
    outs, weights = {}, {}
    for mx in (jmx, tmx):
        with (jmx.cpu() if mx is jmx else tmx.cpu()):
            blk = mx.gluon.nn.Embedding(12, 3, sparse_grad=True) \
                if mx is jmx else mx.gluon.contrib.nn.SparseEmbedding(12, 3)
            blk.initialize()
            (p,) = blk.collect_params().values()
            p.set_data(mx.nd.array(w0))
            tr = mx.gluon.Trainer(blk.collect_params(), "adam",
                                  {"learning_rate": 0.1, "wd": 0.1})
            with mx.autograd.record():
                y = blk(mx.nd.array(ids, dtype="int32"))
                loss = (y * y).sum()
            loss.backward()
            tr.step(1)
            outs[mx] = y.asnumpy()
            weights[mx] = p.data().asnumpy()
    np.testing.assert_array_equal(outs[tmx], outs[jmx])
    np.testing.assert_allclose(weights[tmx], weights[jmx], **LAZY)
    untouched = [r for r in range(12) if r not in (2, 5)]
    np.testing.assert_array_equal(weights[tmx][untouched], w0[untouched])


def test_trainstep_takes_the_dense_update(name_counters):  # noqa: F811
    """Under ``TrainStep`` a sparse_grad net trains exactly as its dense
    twin (the step updates densely, as the JAX TrainStep does) and
    records no rows."""
    from mxnet_tpu_torch.parallel import TrainStep

    ws = _emb_weights(20, 4, seed=5)
    res = []
    for sparse in (True, False):
        emb, out = _emb_net(tmx, 20, 4, *ws, sparse=sparse)
        with tmx.cpu():
            net = tmx.gluon.nn.HybridSequential()
            net.add(emb, tmx.gluon.nn.Flatten(), out)
        ts = TrainStep(net, lambda o, y: ((o - y) ** 2).sum(),
                       tmx.optimizer.Adam(learning_rate=0.05, wd=0.01),
                       engine_type="naive")
        losses = [float(ts(torch.from_numpy(ids.astype(np.int32)),
                           torch.ones(2, 1))) for ids in ID_BATCHES]
        res.append((losses, emb.weight.detach().numpy().copy()))
        assert emb.collect_params()[emb.prefix + "weight"]._sparse_rows \
            is None
    assert res[0][0] == res[1][0]
    np.testing.assert_array_equal(res[0][1], res[1][1])


# -- a sparse-gradient word LM at a narrow width --------------------------------
class _WordLM:
    """Embedding(V, W, sparse_grad=True) -> LSTM(W) -> Dense(V), untied,
    in either package."""

    @staticmethod
    def build(mx, vocab, width):
        class Net(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.encoder = mx.gluon.nn.Embedding(vocab, width,
                                                         sparse_grad=True)
                    self.rnn = mx.gluon.rnn.LSTM(width, num_layers=1,
                                                 layout="TNC")
                    self.decoder = mx.gluon.nn.Dense(vocab, flatten=False)

            def hybrid_forward(self, F, x):
                return self.decoder(self.rnn(self.encoder(x)))
        return Net()


def test_sparse_word_lm_matches_jax(tmp_path, name_counters):  # noqa: F811
    """3 steps of record / backward / Trainer("adam", wd > 0) on a
    sparse-gradient word LM (vocabulary 40, width 8, T 5, B 3) from one
    ``.params`` file: losses and weights as the JAX loop's, and the
    embedding rows no batch touched bit-identical to their start."""
    V, W, T, B, LR = 40, 8, 5, 3, 1e-2
    rs = np.random.RandomState(11)
    batches = [(rs.randint(0, V // 2, (T, B)), rs.randint(0, V, (T, B)))
               for _ in range(3)]
    fname = str(tmp_path / "lm.params")
    res = {}
    for mx in (jmx, tmx):
        with (jmx.cpu() if mx is jmx else tmx.cpu()):
            net = _WordLM.build(mx, V, W)
            net.initialize(mx.init.Xavier())
            net(mx.nd.array(batches[0][0], dtype="int32"))
            if mx is jmx:
                net.save_parameters(fname)
            else:
                net.load_parameters(fname)
            start = {k: p.data().asnumpy().copy() for k, p in
                     net._collect_params_with_prefix().items()}
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": LR, "wd": 1e-3})
            loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
            losses = []
            for x, y in batches:
                with mx.autograd.record():
                    out = net(mx.nd.array(x, dtype="int32"))
                    loss = loss_fn(out.reshape((-1, V)),
                                   mx.nd.array(y.reshape(-1)))
                loss.backward()
                tr.step(T * B)
                losses.append(float(loss.mean().asnumpy()))
            res[mx] = (losses, {k: p.data().asnumpy() for k, p in
                                net._collect_params_with_prefix().items()},
                       start)
    (jl, jw, _), (tl, tw, start) = res[jmx], res[tmx]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jw.keys() == tw.keys()
    err = np.concatenate([np.abs(tw[k] - jw[k]).ravel() for k in jw])
    assert err.max() <= 2 * LR * 3
    assert (err > 1e-2 * LR).mean() <= 1e-3
    untouched = [r for r in range(V) if r >= V // 2]
    np.testing.assert_array_equal(tw["encoder.weight"][untouched],
                                  start["encoder.weight"][untouched])
    np.testing.assert_array_equal(jw["encoder.weight"][untouched],
                                  start["encoder.weight"][untouched])


def test_as_index_array_matches_jax():
    from mxnet_tpu.base import as_index_array as jidx
    from mxnet_tpu_torch.base import as_index_array as tidx

    for v in (np.array([3, -2], np.int64), np.array([1, 2], np.uint32),
              np.array([0.5, 1.5])):
        j, t = jidx(v), tidx(v)
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(j, t)
    assert tidx(torch.tensor([1, 2])).dtype == torch.int32
    for bad in (np.array([-2 ** 31 - 1]), torch.tensor([2 ** 31])):
        with pytest.raises(TError, match="int32 range"):
            tidx(bad)

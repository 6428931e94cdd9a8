"""The port's ``mx.mod`` (``Module``, ``BucketingModule``), ``mx.model``
and ``mx.rnn.BucketSentenceIter`` against the JAX package's
(mxnet_tpu_torch/module.py, model.py, rnn.py): the same symbol, the same
initial weights (``init_params(arg_params=)``) and the same batches in both
packages, then the parameters after three updates (``Module.fit`` with
``SoftmaxOutput`` and Adam; the forward/backward/update loop over a
``softmax_cross_entropy`` head with SGD; ``BucketingModule`` over
``BucketSentenceIter`` at tests/test_rnn_viz_monitor.py's size; and
``FeedForward.fit``), int32 labels through ``SoftmaxOutput``, the metric
``fit`` reports, a Group's per-head cotangents,
``save_checkpoint``/``Module.load`` (bit-identical outputs in the port, the
files read by the JAX package), ``mx.model``'s checkpoint helpers across
the packages, the iterator's buckets, labels and errors, and the kvstore
the port's ``init_optimizer`` refuses.

Tolerances: parameters after three updates rtol 1e-5, atol 1e-6; outputs
rtol 1e-5, atol 1e-6; batches, names and checkpoints exactly equal."""
import logging
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)


def _both(fn):
    j = fn(jmx)
    with tmx.cpu():
        t = fn(tmx)
    return j, t


def _params(mod):
    arg, aux = mod.get_params()
    assert aux == {}
    return {k: v.asnumpy() for k, v in arg.items()}


def _close_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **TOL)


def _mlp(sym, head="softmax_output"):
    x = sym.var("data")
    h = sym.Activation(sym.FullyConnected(x, num_hidden=16, name="fc1"),
                       act_type="relu")
    out = sym.FullyConnected(h, num_hidden=3, name="fc2")
    label = sym.var("softmax_label")
    if head == "xent":
        return sym.softmax_cross_entropy(out, label)
    return sym.SoftmaxOutput(out, label, name="softmax")


def _mlp_weights():
    rs = np.random.RandomState(0)
    return {"fc1_weight": rs.normal(0, 0.3, (16, 8)),
            "fc1_bias": rs.normal(0, 0.1, (16,)),
            "fc2_weight": rs.normal(0, 0.3, (3, 16)),
            "fc2_bias": rs.normal(0, 0.1, (3,))}


def _data(n=60):
    rs = np.random.RandomState(1)
    X = rs.rand(n, 8).astype(np.float32)
    return X, ((X[:, 0] * 3).astype(np.int32) % 3).astype(np.float32)


def _arg(mx, weights):
    return {k: mx.nd.array(np.float32(v)) for k, v in weights.items()}


def test_module_fit_three_adam_updates():
    """``fit`` over three batches: the parameters and the accuracy."""
    X, Y = _data()
    seen = []

    def run(mx):
        it = mx.io.NDArrayIter(X, Y, batch_size=20)
        mod = mx.mod.Module(_mlp(mx.sym))
        metric = mx.metric.create("acc")
        mod.fit(it, eval_metric=metric, optimizer="adam",
                optimizer_params={"learning_rate": 0.05},
                arg_params=_arg(mx, _mlp_weights()), num_epoch=1,
                batch_end_callback=lambda p: seen.append(p.nbatch))
        return _params(mod), metric.get(), mod.score(it, "acc")
    (jp, jm, js), (tp, tm, ts) = _both(run)
    _close_params(jp, tp)
    assert jm[0] == tm[0] and np.isclose(jm[1], tm[1])
    assert js[0][0] == ts[0][0] and np.isclose(js[0][1], ts[0][1])
    assert seen == [0, 1, 2] * 2


def test_module_forward_backward_update_loop():
    """The loop of tests/test_module_amp.py (``softmax_cross_entropy``
    head, SGD), three updates; the loss each step."""
    X, Y = _data()

    def run(mx):
        it = mx.io.NDArrayIter(X, Y, batch_size=20)
        mod = mx.mod.Module(_mlp(mx.sym, "xent"), data_names=("data",),
                            label_names=("softmax_label",))
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params=_arg(mx, _mlp_weights()))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.01,
                                             "momentum": 0.9})
        losses = []
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            losses.append(float(mod.get_outputs()[0].asnumpy()))
        return _params(mod), losses
    (jp, jl), (tp, tl) = _both(run)
    _close_params(jp, tp)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


def test_int32_labels_through_softmax_output():
    """tests/test_symbol.py's auto-variable ``SoftmaxOutput`` symbol with
    int32 labels through ``Module``: eight SGD steps, the losses."""
    rs = np.random.RandomState(5)
    x0, y0 = rs.rand(4, 5).astype(np.float32), rs.randint(0, 3, (4,))
    weights = {"fc_weight": rs.normal(0, 0.3, (3, 5)), "fc_bias": np.zeros(3)}

    def run(mx):
        fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=3,
                                   name="fc")
        mod = mx.mod.Module(mx.sym.SoftmaxOutput(
            fc, mx.sym.var("softmax_label"), name="softmax"))
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params=_arg(mx, weights))
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        batch = mx.io.DataBatch(data=[mx.nd.array(x0)],
                                label=[mx.nd.array(y0, dtype="int32")])
        losses = []
        for _ in range(8):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            p = mod.get_outputs()[0].asnumpy()
            losses.append(-np.log(np.maximum(p[np.arange(4), y0], 1e-9))
                          .mean())
        return losses
    jl, tl = _both(run)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] - 0.1


def test_module_group_backward_per_head_cotangents():
    def run(mx):
        x = mx.sym.Variable("data")
        g = mx.sym.Group([
            mx.sym.FullyConnected(x, num_hidden=2, no_bias=True, name="fc1"),
            mx.sym.FullyConnected(x, num_hidden=2, no_bias=True, name="fc2")])
        mod = mx.mod.Module(g, data_names=("data",), label_names=())
        mod.bind(data_shapes=[("data", (4, 3))], label_shapes=None)
        mod.init_params(initializer=mx.init.One())
        mod.forward(mx.io.DataBatch([mx.nd.ones((4, 3))]), is_train=True)
        mod.backward([mx.nd.ones((4, 2)) * 2.0, mx.nd.ones((4, 2)) * 5.0])
        with pytest.raises(ValueError):
            mod.backward([mx.nd.ones((4, 2))])
        arg, _ = mod.get_params()
        return [arg[k].grad.asnumpy() if mx is tmx else
                np.asarray(arg[k]._grad) for k in ("fc1_weight",
                                                   "fc2_weight")]
    j, t = _both(run)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(t[1], np.full((2, 3), 20.0))


def test_module_checkpoint_roundtrip(tmp_path):
    """The port's checkpoint gives the saved parameters and outputs bit for
    bit after ``Module.load``, and the JAX package reads its files."""
    X, Y = _data(20)
    prefix = str(tmp_path / "model")
    with tmx.cpu():
        it = tmx.io.NDArrayIter(X, Y, batch_size=20)
        mod = tmx.mod.Module(_mlp(tmx.sym))
        mod.fit(it, optimizer="adam", num_epoch=1,
                arg_params=_arg(tmx, _mlp_weights()))
        it.reset()
        batch = next(iter(it))
        mod.forward(batch, is_train=False)
        want = mod.get_outputs()[0].asnumpy()
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        mod2 = tmx.mod.Module.load(prefix, 1)
        mod2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod2.init_params_from_pending()
        mod2.forward(batch, is_train=False)
        got = mod2.get_outputs()[0].asnumpy()
    np.testing.assert_array_equal(got, want)
    p1, p2 = _params(mod), _params(mod2)
    assert sorted(p1) == sorted(p2)
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k])
    assert (tmp_path / "model-0001.states").stat().st_size > 0
    jmod = jmx.mod.Module.load(prefix, 1)
    assert sorted(jmod._pending_params) == sorted(p1)
    for k in p1:
        np.testing.assert_array_equal(jmod._pending_params[k].asnumpy(),
                                      p1[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_model_checkpoint_helpers_cross(writer, tmp_path):
    src, dst = (jmx, tmx) if writer == "jax" else (tmx, jmx)
    prefix = str(tmp_path / "m")
    w = np.random.RandomState(2).rand(4, 3).astype(np.float32)
    with tmx.cpu():
        net = src.sym.FullyConnected(src.sym.var("data"), num_hidden=4,
                                     name="fc1")
        src.model.save_checkpoint(prefix, 3, net, {
            "fc1_weight": src.nd.array(w), "fc1_bias": src.nd.zeros((4,))})
        sym2, arg2, aux2 = dst.model.load_checkpoint(prefix, 3)
    assert sorted(arg2) == ["fc1_bias", "fc1_weight"] and aux2 == {}
    np.testing.assert_array_equal(arg2["fc1_weight"].asnumpy(), w)
    assert sym2.list_arguments() == ["data", "fc1_weight", "fc1_bias"]


def test_feedforward_fit_and_save_without_fit(tmp_path):
    X, Y = _data()

    def run(mx):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ff = mx.model.FeedForward(_mlp(mx.sym), num_epoch=1,
                                      optimizer="sgd", learning_rate=0.1,
                                      arg_params=_arg(mx, _mlp_weights()))
            ff.fit(mx.io.NDArrayIter(X, Y, batch_size=20))
            raw = mx.model.FeedForward(_mlp(mx.sym), arg_params=_arg(
                mx, _mlp_weights()))
        raw.save(str(tmp_path / mx.__name__), 0)  # no fit: held params
        _, arg, _ = mx.model.load_checkpoint(str(tmp_path / mx.__name__), 0)
        return ({k: v.asnumpy() for k, v in ff.arg_params.items()},
                {k: v.asnumpy() for k, v in arg.items()})
    (jp, jr), (tp, tr) = _both(run)
    _close_params(jp, tp)
    for k, v in _mlp_weights().items():
        np.testing.assert_array_equal(tr[k], np.float32(v))
        np.testing.assert_array_equal(jr[k], np.float32(v))


# -- BucketSentenceIter and BucketingModule ----------------------------------
VOCAB = 16


def _sentences():
    """tests/test_rnn_viz_monitor.py's learnable corpus: each token
    determines its successor; lengths 3 and 6."""
    rs = np.random.RandomState(0)
    nxt = rs.permutation(VOCAB)
    sents = []
    for _ in range(48):
        s = [int(rs.randint(VOCAB))]
        for _ in range(rs.choice([3, 6]) - 1):
            s.append(int(nxt[s[-1]]))
        sents.append(s)
    return sents


def _sym_gen(mx):
    def sym_gen(seq_len):
        data = mx.sym.var("data")
        label = mx.sym.var("softmax_label")
        emb = mx.sym.Embedding(data, input_dim=VOCAB, output_dim=16,
                               name="embed")
        fc = mx.sym.FullyConnected(mx.sym.reshape(emb, shape=(-1, 16)),
                                   num_hidden=VOCAB, name="fc")
        out = mx.sym.SoftmaxOutput(fc, mx.sym.reshape(label, shape=(-1,)),
                                   name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def test_bucket_sentence_iter_matches():
    def run(mx):
        it = mx.rnn.BucketSentenceIter(_sentences(), batch_size=8,
                                       buckets=[3, 6], invalid_label=0)
        batches = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                    b.provide_data) for b in it]
        tn = mx.rnn.BucketSentenceIter([[1, 2, 3], [4, 5, 6]], batch_size=2,
                                       buckets=[3], layout="TN")
        dropped = mx.rnn.BucketSentenceIter([[1, 2], [1] * 99], batch_size=1,
                                            buckets=[4])
        return batches, next(iter(tn)).data[0].shape, len(list(dropped))
    (jb, jtn, jd), (tb, ttn, td) = _both(run)
    assert len(jb) == len(tb) and {b[0] for b in tb} == {3, 6}
    for a, b in zip(jb, tb):
        assert a[0] == b[0] and list(a[3][0][1]) == list(b[3][0][1])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(b[2][:, :-1], b[1][:, 1:])
    assert jtn == ttn == (3, 2) and jd == td == 1
    for mx in (jmx, tmx):
        with pytest.raises(ValueError, match="layout"):
            mx.rnn.BucketSentenceIter([[1]], batch_size=1, buckets=[2],
                                      layout="XY")
        with pytest.raises(ValueError, match="no buckets"):
            mx.rnn.BucketSentenceIter([[], []], batch_size=1)


def test_bucketing_module_three_updates():
    """BucketingModule over BucketSentenceIter: three updates through both
    buckets from the same weights; the buckets share one parameter set."""
    rs = np.random.RandomState(3)
    weights = {"embed_weight": rs.normal(0, 0.3, (VOCAB, 16)),
               "fc_weight": rs.normal(0, 0.3, (VOCAB, 16)),
               "fc_bias": np.zeros(VOCAB)}

    def run(mx):
        it = mx.rnn.BucketSentenceIter(_sentences(), batch_size=8,
                                       buckets=[3, 6], invalid_label=0)
        mod = mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=6)
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8, 6))])
        mod.init_params(arg_params=_arg(mx, weights))
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": 5e-2})
        keys, outs = [], []
        batches = list(it)
        for batch in [b for b in batches if b.bucket_key == 3][:1] + \
                [b for b in batches if b.bucket_key == 6][:2]:
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
            keys.append(batch.bucket_key)
            outs.append(mod.get_outputs()[0].asnumpy())
        assert mod._buckets[3]._arg_params is mod._buckets[6]._arg_params
        return _params(mod), keys, outs
    (jp, jk, jo), (tp, tk, to) = _both(run)
    assert jk == tk == [3, 6, 6]
    _close_params(jp, tp)
    for a, b in zip(jo, to):
        np.testing.assert_allclose(b, a, **TOL)


def test_init_optimizer_kvstore():
    with tmx.cpu():
        mod = tmx.mod.Module(_mlp(tmx.sym))
        mod.bind(data_shapes=[("data", (4, 8))],
                 label_shapes=[("softmax_label", (4,))])
        mod.init_params()
        for kv in ("local", "device", None):
            mod.init_optimizer(kvstore=kv)
        for kv in ("dist_sync", "dist_device_sync", object()):
            with pytest.raises(MXNetError, match="not ported"):
                mod.init_optimizer(kvstore=kv)


def test_bucketing_fit_with_perplexity_and_speedometer(caplog):
    """``BucketingModule.fit`` with ``Perplexity(0)`` and ``Speedometer``,
    as the bucketing example runs it, against the JAX package's loop of
    the same batches (its ``BucketingModule.fit`` raises: ``BaseModule``
    there has no ``forward_backward``)."""
    rs = np.random.RandomState(4)
    w = {"embed_weight": rs.normal(0, 0.3, (VOCAB, 16)),
         "fc_weight": rs.normal(0, 0.3, (VOCAB, 16)),
         "fc_bias": np.zeros(VOCAB)}

    def setup(mx):
        it = mx.rnn.BucketSentenceIter(_sentences(), batch_size=8,
                                       buckets=[3, 6], invalid_label=0)
        return it, mx.mod.BucketingModule(_sym_gen(mx), default_bucket_key=6)

    it, jmod = setup(jmx)
    jmod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    jmod.init_params(arg_params=_arg(jmx, w))
    jmod.init_optimizer(optimizer="adam",
                        optimizer_params={"learning_rate": 1e-2})
    jmetric = jmx.metric.Perplexity(0)
    for batch in it:
        jmod.forward(batch, is_train=True)
        jmod.backward()
        jmod.update()
        jmod.update_metric(jmetric, batch.label)
    with tmx.cpu(), caplog.at_level(logging.INFO):
        it, tmod = setup(tmx)
        tmetric = tmx.metric.Perplexity(0)
        tmod.fit(it, eval_metric=tmetric, optimizer="adam",
                 optimizer_params={"learning_rate": 1e-2},
                 arg_params=_arg(tmx, w), num_epoch=1,
                 batch_end_callback=tmx.callback.Speedometer(8, 2,
                                                             auto_reset=False))
    assert any("Speed" in r.getMessage() for r in caplog.records)
    assert jmetric.get()[0] == tmetric.get()[0] == "perplexity"
    np.testing.assert_allclose(tmetric.get()[1], jmetric.get()[1], rtol=1e-5)
    _close_params(_params(jmod), _params(tmod))

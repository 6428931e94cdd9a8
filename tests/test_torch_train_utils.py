"""The port's training utilities against the JAX package's: the Gluon
``Trainer``'s telemetry (``train_step_seconds{loop="trainer"}``,
``train_steps_total``, ``train_samples_total``,
``train_amp_skipped_steps_total``, the step id) and
``observability.throughput_delta``; ``callback.py`` (``Speedometer`` and
the estimator's ``LoggingHandler`` read the registry's samples/s,
``do_checkpoint`` writes ``.params`` that the JAX package's
``load_ndarrays`` reads); ``gluon.contrib.estimator`` (``Estimator.fit``
on a small Dense net in both packages from the same weights: the order of
every handler event, the metrics, the checkpoints and the parameters;
``PreemptionHandler`` and a resume); ``test_utils``, ``runtime.Features``
(JAX's key set), ``AttrScope`` and ``util``.

Tolerances: parameters after SGD steps rtol 1e-5, atol 1e-6; metrics and
losses rtol 1e-5; counts and event orders exactly equal."""
import logging
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import observability as jobs
from mxnet_tpu import serialization as jser
from mxnet_tpu_torch import observability as tobs

SIDES = (jmx, tmx)
B, IN, HID, OUT = 5, 6, 8, 3
TRAIN_SERIES = ("train_step_seconds", "train_steps_total",
                "train_samples_total", "train_amp_skipped_steps_total")


def _weights():
    rs = np.random.RandomState(0)
    return {"0.weight": rs.uniform(-0.5, 0.5, (HID, IN)),
            "0.bias": rs.uniform(-0.1, 0.1, HID),
            "1.weight": rs.uniform(-0.5, 0.5, (OUT, HID)),
            "1.bias": rs.uniform(-0.1, 0.1, OUT)}


def _net(mx):
    """Dense(8, tanh) -> Dense(3) on the CPU with _weights()."""
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(HID, activation="tanh", in_units=IN),
                mx.gluon.nn.Dense(OUT, in_units=HID))
        net.initialize(mx.init.Zero(), ctx=mx.cpu())
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(_weights()[k].astype(np.float32),
                                   ctx=mx.cpu()))
    return net


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _batches(mx, n=3, seed=1):
    rs = np.random.RandomState(seed)
    with mx.cpu():
        return [(mx.nd.array(rs.randn(B, IN).astype(np.float32)),
                 mx.nd.array(rs.randint(0, OUT, B).astype(np.float32)))
                for _ in range(n)]


def _sgd(mx, net):
    return mx.gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})


def _step(mx, net, trainer, x, y):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    with mx.cpu():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
    return float(loss.mean().asnumpy())


@pytest.fixture
def telemetry(tmp_path):
    """Both packages' telemetry on (each into its own directory), the
    training series cleared before and after."""
    for obs in (jobs, tobs):
        for name in TRAIN_SERIES:
            obs.REGISTRY.reset(name)
    jobs.enable(str(tmp_path / "jax"))
    tobs.enable(str(tmp_path / "port"))
    try:
        yield
    finally:
        for obs in (jobs, tobs):
            obs.disable()
            for name in TRAIN_SERIES:
                obs.REGISTRY.reset(name)


class _Overflow:
    """An AMP loss scaler that reports an overflow at every step."""
    enabled = True
    loss_scale = 2.0

    def has_overflow(self, params):
        return True

    def update_scale(self, overflow):
        pass


def _trainer_series(obs):
    snap = obs.REGISTRY.snapshot()

    def series(name, key=None):
        return [(s["labels"], s["value"] if key is None else s["value"][key])
                for s in snap[name]["series"]]

    return {"step_seconds": series("train_step_seconds", "count"),
            "steps": series("train_steps_total"),
            "samples": series("train_samples_total"),
            "skipped": series("train_amp_skipped_steps_total"),
            "step": obs.events.LOG.current_step()}


def test_trainer_step_records_jaxs_telemetry(telemetry):
    got = {}
    for mx, obs in ((jmx, jobs), (tmx, tobs)):
        net = _net(mx)
        trainer = _sgd(mx, net)
        for x, y in _batches(mx):
            _step(mx, net, trainer, x, y)
        trainer._amp_loss_scaler = _Overflow()  # one skipped step
        x, y = _batches(mx, 1)[0]
        _step(mx, net, trainer, x, y)
        got[mx] = _trainer_series(obs)
    want = {"step_seconds": [({"loop": "trainer"}, 4)],
            "steps": [({"loop": "trainer"}, 4.0)],
            "samples": [({"loop": "trainer"}, 4.0 * B)],
            "skipped": [({}, 1.0)], "step": 4}
    assert got[jmx] == want
    assert got[tmx] == want


def test_trainer_step_without_telemetry_records_nothing():
    for name in TRAIN_SERIES:
        tobs.REGISTRY.reset(name)
    tobs.disable()
    net = _net(tmx)
    trainer = _sgd(tmx, net)
    for x, y in _batches(tmx):
        _step(tmx, net, trainer, x, y)
    assert trainer._obs_steps == 0
    for name in TRAIN_SERIES:
        m = tobs.REGISTRY.get(name)
        assert m is None or not m.snapshot()["series"]


def test_throughput_delta_matches_jax(telemetry):
    for obs in (jobs, tobs):
        assert obs.throughput_delta(None) == (None, (0.0, 0.0))
        obs.counter("train_samples_total").inc(40, loop="trainer")
        obs.histogram("train_step_seconds", unit="s").observe(
            0.5, loop="trainer")
        speed, state = obs.throughput_delta((10.0, 0.25))
        assert speed == pytest.approx(30 / 0.25) and state == (40.0, 0.5)
        assert obs.throughput_delta(state) == (None, state)


def _speed_lines(caplog):
    return [float(m.group(1)) for r in caplog.records
            for m in [re.search(r"Speed: ([0-9.]+) samples/sec", r.message)]
            if m]


def test_speedometer_reads_the_registry(telemetry, caplog):
    caplog.set_level(logging.INFO)
    net = _net(tmx)
    trainer = _sgd(tmx, net)
    batches = _batches(tmx, 4)
    meter = tmx.callback.Speedometer(B, frequent=2)
    param = SimpleNamespace(epoch=0, nbatch=0, eval_metric=None)
    meter(param)  # starts the clock
    marks = []
    for i, (x, y) in enumerate(batches, 1):
        _step(tmx, net, trainer, x, y)
        param.nbatch = i
        meter(param)
        if i % 2 == 0:
            h = tobs.REGISTRY.get("train_step_seconds")
            marks.append((tobs.REGISTRY.get("train_samples_total").total(),
                          h.total_sum()))
    speeds = _speed_lines(caplog)
    assert len(speeds) == 2
    # the first line has no earlier registry reading (the wall clock); the
    # second is the registry's samples over its step seconds
    (s0, t0), (s1, t1) = marks
    assert speeds[1] == pytest.approx((s1 - s0) / (t1 - t0), rel=1e-3)


def _fit_data(mx, n, seed):
    return _batches(mx, n, seed)


def _recorder(mx):
    est = mx.gluon.contrib.estimator

    class Recorder(est.TrainBegin, est.TrainEnd, est.EpochBegin,
                   est.EpochEnd, est.BatchBegin, est.BatchEnd):
        def __init__(self):
            self.events = []

        def train_begin(self, estimator, **kw):
            self.events.append(("train_begin",))

        def train_end(self, estimator, **kw):
            self.events.append(("train_end",))

        def epoch_begin(self, estimator, epoch=None, **kw):
            self.events.append(("epoch_begin", epoch))

        def epoch_end(self, estimator, epoch=None, **kw):
            self.events.append(
                ("epoch_end", epoch,
                 tuple(m.get()[0] for m in estimator.val_metrics
                       if m.num_inst)))

        def batch_begin(self, estimator, batch=None, **kw):
            self.events.append(("batch_begin", batch))

        def batch_end(self, estimator, batch=None, batch_size=None, **kw):
            self.events.append(("batch_end", batch, batch_size))

    return Recorder()


def _fit(mx, tmp, telemetry_on=False):
    est = mx.gluon.contrib.estimator
    net = _net(mx)
    estimator = est.Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              train_metrics="acc", trainer=_sgd(mx, net))
    rec = _recorder(mx)
    handlers = [rec, est.LoggingHandler(log_interval=2),
                est.ValidationHandler(_fit_data(mx, 2, 9), batch_period=2,
                                      epoch_period=1),
                est.CheckpointHandler(str(tmp), save_best=True),
                est.EarlyStoppingHandler(monitor="accuracy", patience=5),
                est.StoppingHandler(max_batch=7)]
    with mx.cpu():
        estimator.fit(_fit_data(mx, 3, 2), epochs=4, event_handlers=handlers)
    return estimator, rec.events, net


def test_estimator_fit_matches_jax(tmp_path, caplog):
    caplog.set_level(logging.INFO)
    res = {mx: _fit(mx, tmp_path / mx.__name__) for mx in SIDES}
    (jest, jev, jnet), (test, tev, tnet) = res[jmx], res[tmx]
    assert tev == jev
    # StoppingHandler(max_batch=7): 3 + 3 + 1 batches, a validation every
    # 2 batches and at each epoch end
    assert [e[0] for e in tev].count("batch_end") == 7
    assert tev[-1] == ("train_end",)
    for k, v in _params(jnet).items():
        np.testing.assert_allclose(_params(tnet)[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for jm, tm in zip(jest.train_metrics + jest.val_metrics,
                      test.train_metrics + test.val_metrics):
        assert tm.get()[0] == jm.get()[0]
        assert tm.get()[1] == pytest.approx(jm.get()[1], rel=1e-5)
    assert sorted(os.listdir(tmp_path / "mxnet_tpu_torch")) == \
        sorted(os.listdir(tmp_path / "mxnet_tpu"))
    assert "model-best.params" in os.listdir(tmp_path / "mxnet_tpu_torch")
    assert any("Epoch[2]" in r.message for r in caplog.records)


def test_estimator_default_handlers_and_priorities():
    est = tmx.gluon.contrib.estimator
    jest = jmx.gluon.contrib.estimator
    for mod in (est, jest):
        assert mod.GradientUpdateHandler().priority == -2000
        assert mod.MetricHandler().priority == -1000
    assert est.PreemptionHandler("unused").priority == -1500
    assert set(est.__all__) == set(jest.__all__)
    assert tmx.gluon.contrib.Estimator is est.Estimator


def test_logging_handler_reads_the_registry(telemetry, caplog, tmp_path):
    caplog.set_level(logging.INFO)
    _fit(tmx, tmp_path)
    lines = [r.message for r in caplog.records
             if r.message.startswith("Batch[")]
    # the loss gauge from the first logged batch on, the registry's
    # throughput once two readings bracket steps
    assert lines and all(" loss=" in line for line in lines)
    assert any(" throughput=" in line for line in lines[1:])
    events = tobs.read_events(tobs.telemetry_dir())
    assert any(e["event"] == "log" for e in events)


def test_preemption_handler_saves_and_a_resume_continues(tmp_path):
    est = tmx.gluon.contrib.estimator
    guard = tmx.resilience.PreemptionGuard()

    class Preempt(est.BatchEnd):
        priority = -1800  # after the update, before the handler's save

        def batch_end(self, estimator, batch=None, **kw):
            if batch == 1:
                guard.request()

    data = _fit_data(tmx, 3, 4)
    net = _net(tmx)
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
    e = est.Estimator(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      trainer=trainer)
    handler = est.PreemptionHandler(str(tmp_path), guard=guard)
    with tmx.cpu():
        e.fit(data, epochs=1, event_handlers=[Preempt(), handler])
    assert handler.stop_training
    prefix = tmp_path / "model-preempt"
    assert os.path.exists(f"{prefix}.params")
    assert os.path.exists(f"{prefix}.states")
    # a resumed net's next step equals an uninterrupted run's third step
    ref = _net(tmx)
    rtrainer = tmx.gluon.Trainer(ref.collect_params(), "adam",
                                 {"learning_rate": 0.01})
    want = [_step(tmx, ref, rtrainer, x, y) for x, y in data]
    back = _net(tmx)
    with tmx.cpu():
        back.load_parameters(f"{prefix}.params", ctx=tmx.cpu())
    btrainer = tmx.gluon.Trainer(back.collect_params(), "adam",
                                 {"learning_rate": 0.01})
    btrainer.load_states(f"{prefix}.states")
    assert _step(tmx, back, btrainer, *data[2]) == want[2]
    for k, v in _params(ref).items():
        np.testing.assert_array_equal(_params(back)[k], v)


def test_do_checkpoint_writes_params_jax_reads(tmp_path):
    saved = []

    class Sym:
        def save(self, fname):
            saved.append(fname)

    prefix = str(tmp_path / "ckpt")
    net = _net(tmx)
    args = {k: p.data() for k, p in net._collect_params_with_prefix().items()}
    cb = tmx.callback.do_checkpoint(prefix, period=2)
    cb(0, None, args, {})
    assert not os.listdir(tmp_path)
    cb(1, None, args, {})
    assert os.listdir(tmp_path) == ["ckpt-0002.params"] and not saved
    loaded = jser.load_ndarrays(f"{prefix}-0002.params")
    assert sorted(loaded) == sorted(f"arg:{k}" for k in args)
    for k, v in args.items():
        np.testing.assert_array_equal(loaded[f"arg:{k}"], v.asnumpy())
    cb(3, Sym(), args, {})
    assert saved == [f"{prefix}-symbol.json"]


def test_callbacks_log_like_jax(caplog, capsys):
    caplog.set_level(logging.INFO)
    for mx in SIDES:
        metric = mx.metric.create("acc")
        with mx.cpu():
            metric.update([mx.nd.array(np.array([0.0, 1.0]))],
                          [mx.nd.array(np.array([[0.9, 0.1], [0.8, 0.2]]))])
        param = SimpleNamespace(epoch=1, nbatch=4, eval_metric=metric)
        mx.callback.log_train_metric(2)(param)
        mx.callback.LogValidationMetricsCallback()(param)
        bar = mx.callback.ProgressBar(total=4, length=8)
        bar(param)
    msgs = [r.message for r in caplog.records]
    assert msgs[:2] == msgs[2:4] == ["Iter[1] Batch[4] Train-accuracy=0.500000",
                                     "Epoch[1] Validation-accuracy=0.500000"]
    out = capsys.readouterr().out
    assert out.count("\r[========] 4/4\n") == 2


def test_runtime_features_have_jaxs_keys():
    jf, tf = jmx.runtime.Features(), tmx.runtime.Features()
    assert set(tf) == set(jf)
    for name in jf:
        tf.is_enabled(name.lower())
    for name in ("TPU", "XLA", "PALLAS"):
        assert not tf.is_enabled(name)
    assert tf.is_enabled("CUDA") == torch.cuda.is_available()
    assert tf.is_enabled("cudnn") == (torch.cuda.is_available() and
                                      torch.backends.cudnn.is_available())
    assert [f.name for f in tmx.runtime.feature_list()] == list(tf)


def test_test_utils():
    tu, ju = tmx.test_utils, jmx.test_utils
    for dt in ("float16", "float32", "float64", "bfloat16"):
        assert tu.default_rtols(dt) == ju.default_rtols(dt)
    assert tu.list_gpus() == list(range(torch.cuda.device_count()))
    assert tu.list_tpus() == []
    with tmx.cpu():
        assert tu.default_context() == tmx.cpu()
        a = tu.rand_ndarray((3, 4))
        assert a.shape == (3, 4) and a.context == tmx.cpu()
        tu.assert_almost_equal(a, a.asnumpy() + 1e-6)
        assert tu.almost_equal(a, a.asnumpy())
        assert not tu.almost_equal(a, a.asnumpy() + 1.0)
        with pytest.raises(AssertionError):
            tu.assert_almost_equal(a, a.asnumpy() + 1.0)
        assert tu.same_array(a, a) and tu.same_array(a, tmx.nd.NDArray(
            a._data.view(3, 4)))
        assert not tu.same_array(a, a.copy())
        x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
        tu.check_numeric_gradient(lambda v: (v * v.tanh()).sum(), [x])

        def wrong(v):  # a gradient that is not the function's
            return tmx.nd.NDArray(_Wrong.apply(v._data))

        with pytest.raises(AssertionError):
            tu.check_numeric_gradient(wrong, [x])
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="no CUDA card"):
            tu.check_consistency(lambda v: v * 2, [x])
    else:
        tu.check_consistency(lambda v: (v * 2).tanh(), [x])


class _Wrong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return (v * v).sum()

    @staticmethod
    def backward(ctx, g):
        return g * torch.ones(2, 3)


def test_attr_scope_and_util():
    from mxnet_tpu import attribute as jattr
    from mxnet_tpu_torch import attribute as tattr

    got = []
    for mx, mod in ((jmx, jattr), (tmx, tattr)):
        with mx.AttrScope(ctx_group="dev1", a="1"):
            with mx.AttrScope(a="2"):
                inner = mod.current_attrs()
            outer = mod.current_attrs()
        got.append((inner, outer, mod.current_attrs()))
    assert got[0] == got[1] == ({"ctx_group": "dev1", "a": "2"},
                                {"ctx_group": "dev1", "a": "1"}, {})
    assert tmx.is_np_array() is jmx.is_np_array() is False
    assert tmx.util.use_np_shape(len) is len

"""The port's fleet view and goodput ledger against the JAX package's
(``mxnet_tpu_torch/observability/{fleet,goodput}.py`` vs
``mxnet_tpu/observability/{fleet,goodput}.py``), on the same inputs:

  - ``goodput_ledger`` / ``classify_events`` equal on one event list each
    (buckets partition the wall, overlap priority, re-formation gaps);
  - ``detect_stragglers`` equal;
  - a fleet directory written by either package (its FleetSnapshotter over
    its own registry and event log, or fabricated files: ranks and
    generations, torn snapshots, serving rollups, replica and router
    series, span files) is read by both ``FleetAggregator``s to equal
    reports, and ``poll`` emits the same findings and capture requests;
  - ``tools/torch_fleetreport.py`` prints what ``tools/fleetreport.py``
    prints for the same directory;
  - ``observability.enable`` starts the snapshotter when ``fleet_dir`` is
    set and ``shutdown`` takes the final snapshot.

  - the FLOPs model: ``program_flops`` of the LeNet and tiny GPT-2 step
    records and ``TrainStep.model_flops_per_step`` equal the JAX hand
    counts, a window's census counts one step, the JAX-vocabulary
    fallback is flagged as in JAX, and ``train_mfu`` is set from them.
"""
import importlib.util
import json
import os
import sys

import pytest

from mxnet_tpu import observability as jobs
from mxnet_tpu.observability import fleet as jfleet
from mxnet_tpu.observability import goodput as jgp
from mxnet_tpu.observability import tracing as jtr
from mxnet_tpu.observability.metrics import Registry as JRegistry
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.observability import fleet as tfleet
from mxnet_tpu_torch.observability import goodput as tgp
from mxnet_tpu_torch.observability import tracing as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_event(step, seconds, ts, run="r"):
    return {"ts": ts, "run": run, "host": 0, "step": step,
            "event": "train_step", "loss": 1.0, "step_seconds": seconds}


def _gen(events, g):
    for e in events:
        e["_gen"] = g
    return events


GOODPUT = {
    "partition": _gen([
        _step_event(1, 1.0, ts=101.0), _step_event(2, 1.0, ts=102.0),
        {"ts": 104.0, "event": "checkpoint_save", "seconds": 1.5},
        _step_event(3, 1.0, ts=106.0),
        {"ts": 107.5, "event": "data_stall", "wait_seconds": 1.0}], 0),
    "overlap": _gen([_step_event(1, 2.0, ts=102.0),
                     {"ts": 102.0, "event": "checkpoint_save",
                      "seconds": 1.0}], 0),
    "reformation": (
        _gen([_step_event(i, 0.5, ts=100.0 + i) for i in (1, 2, 3)], 0)
        + _gen([{"ts": 110.0, "event": "elastic_restore", "seconds": 1.0}]
               + [_step_event(i, 0.5, ts=108.0 + i) for i in (3, 4)], 1)),
    "windows": _gen([{"ts": 120.0, "event": "train_window",
                      "window_seconds": 8.0},
                     {"ts": 121.0, "event": "checkpoint_restore",
                      "seconds": 0.5}, {"event": "no_ts"}], 0),
    "empty": [],
    "no_ts": [{"event": "x"}],
}


@pytest.mark.parametrize("name", sorted(GOODPUT))
def test_goodput_ledger_equals_jax(name):
    ev = GOODPUT[name]
    assert tgp.classify_events(ev) == jgp.classify_events(ev)
    got, want = tgp.goodput_ledger(ev), jgp.goodput_ledger(ev)
    if want is None:
        assert got is None
        return
    assert got.summary() == want.summary()
    assert sum(got.buckets.values()) == pytest.approx(got.wall, rel=1e-9)
    assert got.goodput == want.goodput
    assert tgp.GOODPUT_CATEGORIES == jgp.GOODPUT_CATEGORIES
    assert tgp.FlopsEstimate().summary() == jgp.FlopsEstimate().summary()


def _stragglers_case(kind):
    events = []
    if kind == "slow_rank":
        for step in range(1, 6):
            for rank in range(4):
                dt = 1.2 if (rank == 2 and step == 3) else 0.1
                events.append(dict(_step_event(step, dt, ts=100.0 + step),
                                   _rank=rank, _gen=0))
    elif kind == "floor":
        for rank in range(3):
            dt = 1e-5 if rank != 2 else 9e-5
            events.append(dict(_step_event(1, dt, ts=100.0), _rank=rank,
                               _gen=0))
        events.append(dict(_step_event(2, 5.0, ts=101.0), _rank=0, _gen=0))
    else:  # replays after a restore, two generations
        for g in (0, 1):
            for rank in range(3):
                for rep in range(2):
                    dt = 0.1 + 0.5 * (rank == g) + 0.01 * rep
                    events.append(dict(_step_event(4, dt, ts=100.0 + g),
                                       _rank=rank, _gen=g))
    return events


@pytest.mark.parametrize("kind", ["slow_rank", "floor", "replays"])
@pytest.mark.parametrize("factor", [2.0, 3.0])
def test_detect_stragglers_equals_jax(kind, factor):
    ev = _stragglers_case(kind)
    got = tfleet.detect_stragglers(ev, factor)
    assert got == jfleet.detect_stragglers(ev, factor)
    if kind == "slow_rank":
        assert [s["rank"] for s in got[0]] == [2]


# -- fleet directories ----------------------------------------------------------
def _write_snapshot(fleet_dir, rank, gen, metrics=None, events=None,
                    ts=1000.0, sub=None):
    d = os.path.join(str(fleet_dir), sub or f"telemetry-h{rank}")
    os.makedirs(d, exist_ok=True)
    if metrics is not None:
        payload = {"meta": {"rank": rank, "generation": gen, "pid": 1,
                            "run": "r", "ts": ts}, "metrics": metrics}
        with open(os.path.join(d, f"metrics-g{gen}.json"), "w") as f:
            json.dump(payload, f)
    if events is not None:
        with open(os.path.join(d, f"events-g{gen}.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
    return d


def _step_hist(values, buckets=(0.1, 1.0, 10.0)):
    r = JRegistry()
    h = r.histogram("train_step_seconds", buckets=buckets)
    for v in values:
        h.observe(v, loop="train_step")
    return r.snapshot()


def _dir_ranks(d):
    _write_snapshot(d, 0, 0, metrics=_step_hist([0.1, 0.1]),
                    events=[_step_event(1, 0.1, 100.1),
                            _step_event(2, 0.1, 100.2)], ts=100.2)
    _write_snapshot(d, 0, 1, metrics=_step_hist([0.1]),
                    events=[_step_event(3, 0.1, 105.0)], ts=105.0)
    _write_snapshot(d, 1, 1, metrics=_step_hist([0.3]),
                    events=[_step_event(3, 0.3, 105.2)], ts=105.2)
    for g in (2, 10):  # numeric generation order (g10 after g2)
        _write_snapshot(d, 1, g, metrics=_step_hist([0.2 * g]), ts=106.0 + g)


def _dir_torn(d):
    _write_snapshot(d, 0, 0, metrics=_step_hist([0.1]),
                    events=[_step_event(1, 0.1, 100.1)])
    d1 = os.path.join(str(d), "telemetry-h1")
    os.makedirs(d1)
    with open(os.path.join(d1, "metrics-g0.json"), "w") as f:
        f.write('{"meta": {"rank": 1, "ts": 9999.0}, "metr')
    os.makedirs(os.path.join(str(d), "router"))
    with open(os.path.join(str(d), "router", "metrics-g0.json"), "w") as f:
        f.write('{"meta": {}, "metrics": [1, 2')


def _dir_serving(d):
    r = JRegistry()
    h = r.histogram("ttft_seconds")
    for v in (0.02, 0.03, 0.04, 0.4):
        h.observe(v)
    for v in (120.0, 30.0, 75.0):
        r.histogram("decode_tokens_per_s").observe(v)
    r.gauge("gen_slot_utilization").set(0.75)
    r.gauge("gen_queue_depth").set(3)
    r.counter("gen_requests_total").inc(3, reason="eos")
    r.counter("gen_requests_total").inc(1, reason="shed")
    for name, v in (("replica_free_pages", 12.0), ("replica_queue_depth", 1),
                    ("replica_active_slots", 2), ("replica_queue_age_p95", 0.5),
                    ("replica_admissions_total", 4)):
        r.gauge(name).set(v)
    _write_snapshot(d, 0, 0, metrics=r.snapshot(),
                    events=[_step_event(1, 0.1, 100.1)])
    _write_snapshot(d, 1, 0, metrics=r.snapshot(), ts=1001.0)
    rr = JRegistry()
    rr.gauge("router_replica_state").set(3, replica="0")
    rr.gauge("router_replica_state").set(0, replica="1")
    rr.counter("router_admissions_total").inc(5, replica="1")
    rr.counter("router_redistributions_total").inc(2, replica="0",
                                                   cause="replica_dead")
    rr.counter("router_redistributions_total").inc(1, replica="7",
                                                   cause="drain")
    rr.counter("router_requests_total").inc(6, priority="normal")
    rr.counter("router_completions_total").inc(6, reason="length")
    _write_snapshot(d, 0, 0, metrics=rr.snapshot(), sub="router")


def _dir_traces(d):
    os.makedirs(os.path.join(str(d), "router"))
    os.makedirs(os.path.join(str(d), "telemetry-h1"))
    recs = [{"kind": "span", "trace": "0", "name": "router.backlog",
             "t0": 0.0, "t1": 1.0, "src": "router"},
            {"kind": "span", "trace": "0", "name": "router.attempt",
             "t0": 1.0, "t1": 4.0, "src": "router", "replica": 1},
            {"kind": "end", "trace": "0", "outcome": "length",
             "cls": "normal", "t0": 0.0, "t1": 4.0, "e2e": 4.0,
             "deadline": 5.0, "margin": 1.0, "hops": 0, "keep": True,
             "why": "sampled", "src": "router"},
            {"kind": "end", "trace": "1", "outcome": "deadline",
             "cls": "batch", "t0": 0.0, "t1": 2.0, "e2e": 2.0,
             "deadline": 1.5, "margin": -0.5, "hops": 1, "keep": False,
             "why": "dropped", "src": "router"}]
    with open(os.path.join(str(d), "router", "spans-g0.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in recs)
    with open(os.path.join(str(d), "telemetry-h1", "spans-g0.jsonl"),
              "w") as f:
        f.write(json.dumps({"kind": "span", "trace": "9", "name": "prefill",
                            "t0": 1.0, "t1": 2.0, "src": "h1"}) + "\n")
        f.write('{"kind": "span", "tr')


def _dir_stragglers(d):
    for rank in range(3):
        evs = [_step_event(step, 2.0 if (rank == 1 and step == 2) else 0.1,
                           ts=100.0 + step) for step in (1, 2)]
        _write_snapshot(d, rank, 0, metrics=_step_hist(
            [e["step_seconds"] for e in evs]), events=evs)


def _dir_empty(d):
    os.makedirs(os.path.join(str(d), "telemetry-h0"))


def _dir_snapshotter(side):
    """A directory written by ``side``'s own FleetSnapshotter over its own
    registry and event log."""
    obs, fleet = {"jax": (jobs, jfleet), "port": (tobs, tfleet)}[side]

    def write(d):
        run = os.path.join(str(d), "_run")
        obs.REGISTRY.reset()
        try:
            obs.enable(run, run_id="snap")
            obs.histogram("train_step_seconds").observe(0.2,
                                                        loop="train_step")
            obs.histogram("ttft_seconds").observe(0.05)
            obs.counter("gen_requests_total").inc(2, reason="length")
            obs.emit("train_step", step=1, step_seconds=0.2, loss=1.0)
            snap = fleet.FleetSnapshotter(os.path.join(str(d), "fleet"),
                                          rank=0, generation=0, interval=60.0)
            assert snap.snapshot()
            obs.emit("train_step", step=2, step_seconds=0.3, loss=1.0)
            obs.emit("checkpoint_save", seconds=0.01)
            assert snap.snapshot()
            assert snap.maybe_snapshot() is False  # throttled
            snap2 = fleet.FleetSnapshotter(os.path.join(str(d), "fleet"),
                                           rank=1, generation=2,
                                           interval=60.0)
            assert snap2.snapshot()
        finally:
            obs.disable()
            obs.REGISTRY.reset()
        return os.path.join(str(d), "fleet")
    return write


DIRS = {"ranks": _dir_ranks, "torn": _dir_torn, "serving": _dir_serving,
        "traces": _dir_traces, "stragglers": _dir_stragglers,
        "empty": _dir_empty, "written_by_jax": _dir_snapshotter("jax"),
        "written_by_port": _dir_snapshotter("port")}


def _summary(report):
    return None if report is None else report.summary()


@pytest.mark.parametrize("name", sorted(DIRS))
def test_fleet_dir_reads_equal_in_both_aggregators(tmp_path, name):
    d = DIRS[name](tmp_path) or str(tmp_path)
    got = _summary(tfleet.FleetAggregator(d, straggler_factor=3.0,
                                          peak_flops=0.0).collect())
    want = _summary(jfleet.FleetAggregator(d, straggler_factor=3.0,
                                           peak_flops=0.0).collect())
    assert got == want
    if name == "empty":
        assert got is None
        return
    assert got is not None
    if name == "ranks":
        assert got["generations"] == [0, 1, 2, 10]
        assert got["goodput"]["buckets"]["reformation"] > 0
    if name == "torn":
        assert got["torn_snapshots"] == 2
    if name == "serving":
        assert got["serving"]["requests"] == {"eos": 6, "shed": 2}
        assert got["router"]["replicas"]["0"]["state"] == "dead"
        assert got["ranks"]["0"]["replica"]["free_pages"] == 12.0
    if name == "traces":
        assert got["traces"]["ends"] == 2 and got["traces"]["orphans"] == 1
        assert got["slo"]["total"]["attained"] == 1
    if name.startswith("written_by"):
        assert set(got["ranks"]) == {"0", "1"}
        steps = [e["step"] for e in tfleet.FleetAggregator(d).collect().events
                 if e["event"] == "train_step" and e["_rank"] == 0]
        assert steps == [1, 2]  # the event copy is incremental


def test_poll_findings_and_capture_requests_equal_jax(tmp_path):
    out = {}
    for side, fleet, reg in (("jax", jfleet, jobs.REGISTRY),
                             ("port", tfleet, tobs.REGISTRY)):
        d = tmp_path / side
        _dir_stragglers(d)
        agg = fleet.FleetAggregator(str(d), straggler_factor=3.0)
        report, new = agg.poll()
        _, again = agg.poll()
        with open(os.path.join(str(d), "prof-request-h1.json")) as f:
            req = json.load(f)
        req.pop("ts")
        out[side] = (new, again, req, reg.get("straggler_rank").value())
    assert out["port"] == out["jax"]
    new, again, req, rank = out["port"]
    assert [s["rank"] for s in new] == [1] and again == [] and rank == 1
    assert req["reason"] == "straggler"


def test_fleetreport_prints_what_jax_prints(tmp_path, capsys):
    jfr = _load("fleetreport_jax", os.path.join(REPO, "tools",
                                                "fleetreport.py"))
    tfr = _load("fleetreport_port", os.path.join(REPO, "tools",
                                                 "torch_fleetreport.py"))
    assert tfr.main([str(tmp_path / "nothing")]) == 1
    capsys.readouterr()
    _dir_serving(tmp_path)
    _dir_traces(tmp_path / "t")
    for d in (str(tmp_path), str(tmp_path / "t")):
        for args in ([d], [d, "--json"]):
            assert jfr.main(args) == 0
            want = capsys.readouterr().out
            assert tfr.main(args) == 0
            got = capsys.readouterr().out
            assert got == want.replace("tools/tracereport.py",
                                       "tools/torch_tracereport.py")
    assert "-- slo" in got or "slo" in json.loads(got)


def test_enable_starts_snapshotter_and_shutdown_lands_final(tmp_path):
    fdir = tmp_path / "fleet"
    tconfig.set("fleet_dir", str(fdir))
    try:
        tobs.enable(str(tmp_path / "run"), run_id="fleetrun")
        snap = tfleet.snapshotter()
        assert snap is not None and snap.rank == 0
        tobs.emit("train_step", step=7, step_seconds=0.5, loss=1.0)
        tobs.shutdown()
        assert tfleet.snapshotter() is None
        lines = (fdir / "telemetry-h0" / "events-g0.jsonl").read_text()
        assert any(json.loads(ln).get("step") == 7
                   for ln in lines.splitlines())
        payload = json.loads((fdir / "telemetry-h0"
                              / "metrics-g0.json").read_text())
        assert payload["meta"]["run"] == "fleetrun"
    finally:
        tconfig._values.pop("fleet_dir", None)
        tobs.disable()
        tfleet.shutdown_snapshotter()
    assert tobs.fleet is tfleet and tobs.tracing is ttr
    assert tfleet.FleetReport.__dataclass_fields__.keys() == \
        jfleet.FleetReport.__dataclass_fields__.keys()
    assert jtr.ROUTER_LEVEL_SPANS == ttr.ROUTER_LEVEL_SPANS


# -- the FLOPs model (tests/test_fleet.py:111-217) ---------------------------
def _lenet(side):
    import numpy as np

    mx = __import__("mxnet_tpu" if side == "jax" else "mxnet_tpu_torch")
    mx.random.seed(0)
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Conv2D(6, 5, padding=2, activation="tanh"),
                mx.gluon.nn.MaxPool2D(2, 2), mx.gluon.nn.Flatten(),
                mx.gluon.nn.Dense(32, activation="tanh"),
                mx.gluon.nn.Dense(10))
        net.initialize(mx.init.Xavier())
        x = mx.nd.array(np.random.RandomState(0).rand(8, 1, 28, 28)
                        .astype(np.float32))
        y = mx.nd.array(np.arange(8) % 10)
    net(x)
    step = mx.parallel.TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                 mx.optimizer.create("adam",
                                                     learning_rate=1e-3))
    return step, (x, y)


def test_flops_lenet_step_hand_counted():
    """The LeNet step's products against the JAX hand count: the
    convolution, its weight gradient (the input takes none), and each
    Dense's forward, input gradient and weight gradient."""
    from mxnet_tpu import analysis as janalysis

    jts, jbatch = _lenet("jax")
    jest = jgp.program_flops(janalysis.audit_lowered(jts.lower_hlo(*jbatch)))
    ts, batch = _lenet("port")
    est = tgp.program_flops(ts.audit(*batch).lowered)
    conv_fwd = 2 * (8 * 6 * 28 * 28) * (1 * 5 * 5)
    expected = conv_fwd * 2 + (2 * 8 * 32 * 1176) * 3 + (2 * 8 * 10 * 32) * 3
    assert est.total == jest.total == expected == 5584896
    assert est.n_approx == jest.n_approx == 0
    assert est.by_op["convolution"] + est.by_op["convolution_backward"] \
        == jest.by_op["convolution"] == conv_fwd * 2
    assert ts.model_flops_per_step(*batch) == expected


def test_flops_tiny_gpt2_step_hand_counted():
    """Tiny GPT-2's LM step: 3x the analytic forward product count in both
    packages (the embedding's one-hot gradient is its scatter-add, no
    product)."""
    import numpy as np

    from mxnet_tpu import analysis as janalysis
    from mxnet_tpu import nd as jnd
    from mxnet_tpu import optimizer as jopt
    from mxnet_tpu.models import gpt2 as jgpt2
    from mxnet_tpu.parallel import TrainStep as JTrainStep
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.models import gpt2 as tgpt2
    from mxnet_tpu_torch.parallel import TrainStep

    B, T, d, h, V = 2, 32, 32, 2, 64
    ids = np.random.RandomState(0).randint(0, V, (B, T)).astype(np.int32)
    lbl = np.random.RandomState(1).randint(0, V, (B, T)).astype(np.int32)
    jnet = jgpt2.get_gpt2("gpt2_tiny", dropout=0.0, num_layers=2, units=d,
                          num_heads=h, max_length=64, vocab_size=V)
    jnet.initialize()
    jnet(jnd.array(ids, dtype="int32"))
    jts = JTrainStep(jnet, jgpt2.lm_loss, jopt.Adam(learning_rate=1e-3))
    jest = jgp.program_flops(janalysis.audit_lowered(jts.lower_hlo(
        jnd.array(ids, dtype="int32"), jnd.array(lbl, dtype="int32"))))
    net = tgpt2.get_gpt2("gpt2_117m", dropout=0.0, num_layers=2, units=d,
                         num_heads=h, max_length=64, vocab_size=V,
                         device="cpu", seed=0)
    ts = TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=1e-3))
    import torch

    batch = (torch.from_numpy(ids), torch.from_numpy(lbl))
    est = tgp.program_flops(ts.audit(*batch).lowered)
    ch = d // h
    layer_fwd = (2 * B * T * d * 3 * d + 2 * (2 * B * h * T * T * ch)
                 + 2 * B * T * d * d + 2 * (2 * B * T * d * 4 * d))
    fwd = 2 * layer_fwd + 2 * B * T * d * V
    assert est.total == jest.total == 3 * fwd == 11796480
    assert est.n_approx == jest.n_approx == 0
    assert ts.model_flops_per_step(*batch) == 3 * fwd


def _dense_step():
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.parallel import TrainStep

    tmx.random.seed(0)
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(16, in_units=8, activation="relu"),
                tmx.gluon.nn.Dense(4, in_units=16))
        net.initialize()
    x, y = torch.ones(4, 8), torch.zeros(4, 4)
    net(x)
    return TrainStep(net, lambda o, t: ((o - t) ** 2).mean(),
                     topt.SGD(learning_rate=0.01)), (x, y)


def test_flops_window_census_counts_one_step():
    """A window program runs ``window`` step bodies; its FLOPs a step are
    the single step's (JAX: its scan body appears once)."""
    ts, (x, y) = _dense_step()
    single = ts.model_flops_per_step(x, y)
    assert single == 3 * 2 * 4 * 16 * 8 + 3 * 2 * 4 * 4 * 16 - 2 * 4 * 16 * 8
    assert ts.model_flops_per_step(x, y, window=2) == single
    assert ts.model_flops_per_step(x, y, window=2, accum=2) == 2 * single


def test_op_flops_fallback_is_flagged():
    """The JAX vocabulary's ops price as in JAX: the sqrt fallback for a
    dot without usable contraction dims (flagged approx), an unparsed
    convolution unpriced."""
    import pytest

    from mxnet_tpu.analysis import Op as JOp
    from mxnet_tpu_torch.analysis import Op as TOp

    out = []
    for gp_, Op in ((jgp, JOp), (tgp, TOp)):
        op = Op("dot_general", "f32", (8, 10), ("f32",) * 3, 1,
                shapes=((8, 32), (32, 10), (8, 10)))
        bad = Op("dot_general", "f32", (8, 10), ("f32",) * 3, 1,
                 shapes=((8, 32), (32, 10), (8, 10)),
                 dot_meta={"lhs_contracting": (7,), "lhs_batching": ()})
        conv = Op("convolution", "f32", (8, 6, 28, 28), ("f32",) * 3, 1,
                  shapes=((8, 1, 28, 28), (6, 1, 5, 5), (8, 6, 28, 28)))
        assert gp_.op_flops(op) == pytest.approx(2 * 8 * 10 * 32)
        assert gp_.op_flops(conv) is None
        est = gp_.program_flops(type("R", (), {"ops": [op, bad, conv]}))
        out.append(est.summary())
    assert out[0] == out[1]
    assert out[1]["n_dots"] == 2 and out[1]["n_approx"] == 2 \
        and out[1]["n_unpriced"] == 1


def test_train_mfu_gauge_from_flops(tmp_path):
    tconfig.set("peak_flops", 1e9)
    try:
        tobs.enable(str(tmp_path / "run"))
        ts, (x, y) = _dense_step()
        ts(x, y)
        ts(x, y)
        flops = tobs.REGISTRY.get("train_model_flops_per_step").value()
        assert flops == ts.model_flops_per_step(x, y)
        mfu = tobs.REGISTRY.get("train_mfu").value()
        assert mfu is not None and 0 < mfu < 1e9
        ts.audit(x, y)
        bound = tobs.REGISTRY.get("train_mfu_bound").value()
        assert 0 < bound <= 1
        assert tobs.REGISTRY.get("train_comm_exposed_share").value() == 0
    finally:
        tconfig._values.pop("peak_flops", None)
        tobs.disable()


FLEET_KNOBS = ("trace", "trace_sample", "trace_seed", "trace_slow_pct",
               "trace_margin_floor", "trace_slo_target", "trace_slo_windows",
               "router_hb_timeout", "router_drain_after", "router_dead_grace",
               "router_queue_bound", "router_classes", "router_affinity",
               "router_seed", "router_prefix_tokens", "prof_every_n_steps",
               "prof_keep_bytes", "fleet_dir", "fleet_snapshot_interval",
               "straggler_factor", "peak_flops", "profiler_dir")


@pytest.mark.parametrize("name", FLEET_KNOBS)
def test_fleet_knob_matches_jax(name, monkeypatch):
    """Name, type, default and environment variables as in
    ``mxnet_tpu.config``, but ``profiler_dir``: the JAX package's fixed
    /tmp path would be shared by every checkout and process on a machine;
    the port's empty default resolves under the temporary directory."""
    from mxnet_tpu import config as jconfig

    jt, jd, jenv, _ = jconfig._KNOBS[name]
    tt, td, tenv, _ = tconfig._KNOBS[name]
    assert (tt, td, tenv) == (jt, "" if name == "profiler_dir" else jd,
                              jenv)
    raw = {bool: "1", int: "7", float: "0.5", str: "a,b"}[tt]
    monkeypatch.setenv(tenv[0], raw)
    assert tconfig.get(name) == jconfig.get(name)

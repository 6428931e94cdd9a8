"""The port's measured profiling (``mxnet_tpu_torch/observability/
profiling.py``) against the JAX package's, and its ``torch.profiler``
side on the CPU:

  - the committed XPlane fixture (``tests/fixtures/xplane``) and
    ``encode_xplane`` bytes give equal timelines, op rows, step rows and
    ``MeasuredReport.summary()`` in both packages; torn and empty traces
    are counted, never fatal; ``op_class`` agrees on the HLO vocabulary;
  - ``parse_chrome_trace`` on a synthetic card trace (kernels, a graph
    launch and a copy tied to their launches by correlation id): kernel
    rows on the card's plane, each step's device window from its launches,
    host rows out of the op rows;
  - a CPU ``torch.profiler`` capture of a tiny loop has one step row a
    traced call; a capture asked for the card whose timeline holds no
    device rows raises; ``replays_only`` traces only calls that replay;
  - the step-capture controller's periodic, trigger-file and retention
    decisions equal the JAX controller's over the same step loop, a step
    that captures its graph is never traced, an aborted capture
    releases the session, and a traced step's recorded seconds leave out
    the session's opening; ``capture_state`` keys on
    ``config.STEP_KNOBS``, the knobs the kernels read;
  - ``GenerationEngine.profile`` / ``TrainStep.profile`` on the CPU, and
    ``calibrate=True`` raising until ``analysis/*`` is ported;
  - a capture snapshot reads the same in both packages'
    ``FleetAggregator`` and ``tools/*profreport.py``.
"""
import glob
import importlib.util
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import config as jconfig
from mxnet_tpu import nd, optimizer as jopt
from mxnet_tpu import observability as jobs
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.observability import fleet as jfleet
from mxnet_tpu.observability import profiling as jprof
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.inference import GenerationEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.observability import fleet as tfleet
from mxnet_tpu_torch.observability import profiling as tprof
from mxnet_tpu_torch.ops import cuda_graph as cg
from mxnet_tpu_torch.parallel import TrainStep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "xplane")
SIDES = {"jax": jprof, "port": tprof}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PLANES = [
    {"name": "/device:TPU:0", "lines": [
        {"name": "XLA Ops", "timestamp_ns": 100, "events": [
            {"name": "dot.1", "offset_ps": 0, "duration_ps": 10_000,
             "stats": {"hlo_op": "dot.1", "bytes accessed": 4096}},
            {"name": "all-reduce-start.2", "offset_ps": 5_000,
             "duration_ps": 9_000, "stats": {"hlo_op": "all-reduce.2"}},
            {"name": "fusion.3", "offset_ps": 12_000,
             "duration_ps": 6_000, "stats": {"hlo_module": "jit_step"}},
            {"name": "zero", "offset_ps": 1_000, "duration_ps": 0}]},
        {"name": "Steps", "timestamp_ns": 100, "events": [
            {"name": "prof_step", "offset_ps": 0, "duration_ps": 20_000,
             "stats": {"step": 4}}]}]},
    {"name": "/host:CPU", "lines": [
        {"name": "python", "timestamp_ns": 90, "events": [
            {"name": "train_fwd", "offset_ps": 0, "duration_ps": 3_000,
             "stats": {"step": 4, "f": 2.5}},
            {"name": "reduce.9", "offset_ps": 0, "duration_ps": 1_000,
             "stats": {"hlo_op": "reduce.9", "bytes_accessed": 7}},
            {"name": "$frame.py:3 f", "offset_ps": 0,
             "duration_ps": 5_000}]}]},
]


@pytest.mark.parametrize("source", ["fixture", "encoded"])
def test_xplane_reports_equal_jax(tmp_path, source):
    if source == "fixture":
        tls = {k: m.parse_trace(FIXTURE) for k, m in SIDES.items()}
    else:
        data = tprof.encode_xplane(PLANES)
        assert data == jprof.encode_xplane(PLANES)
        run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
        run.mkdir(parents=True)
        (run / "h.xplane.pb").write_bytes(data)
        tls = {k: m.parse_trace(str(tmp_path)) for k, m in SIDES.items()}
    got, want = tls["port"], tls["jax"]
    assert [p.name for p in got.planes] == [p.name for p in want.planes]
    for gp, wp in zip(got.planes, want.planes):
        # (the JAX package reads through jaxlib's ProfileData where it
        # ships, which leaves a line's timestamp_ns at 0; its events carry
        # absolute times either way)
        assert [ln.name for ln in gp.lines] == [ln.name for ln in wp.lines]
        for gl, wl in zip(gp.lines, wp.lines):
            assert [vars(e) for e in gl.events] == \
                [vars(e) for e in wl.events]
    path = glob.glob(os.path.join(got.source, "*.xplane.pb"))[0]
    with open(path, "rb") as f:
        data = f.read()
    wire_t = tprof.parse_xplane_bytes(data)
    wire_j = jprof.parse_xplane_bytes(data)
    assert [[(ln.name, ln.timestamp_ns, [vars(e) for e in ln.events])
             for ln in p.lines] for p in wire_t.planes] == \
        [[(ln.name, ln.timestamp_ns, [vars(e) for e in ln.events])
          for ln in p.lines] for p in wire_j.planes]
    rg, rw = tprof.measured_report(got), jprof.measured_report(want)
    assert [vars(o) for o in rg.op_rows] == [vars(o) for o in rw.op_rows]
    assert rg.summary() == rw.summary()
    assert rg.hot_ops(3) == rw.hot_ops(3)
    assert [vars(s) for s in rg.step_rows()] == \
        [vars(s) for s in rw.step_rows()]
    assert rg.summary()["steps"] >= 1


def test_torn_and_empty_traces_counted_not_fatal(tmp_path):
    run = tmp_path / "plugins" / "profile" / "0001"
    run.mkdir(parents=True)
    good = tprof.encode_xplane(PLANES)
    (run / "torn.xplane.pb").write_bytes(good[:len(good) // 3])
    (run / "torn.pt.trace.json").write_text('{"traceEvents": [{"ph"')
    tl = tprof.parse_trace(str(tmp_path))
    assert tl.parse_errors == 2 and tl.planes == []
    assert tprof.measured_report(tl).op_rows == []
    assert tprof.parse_trace(str(tmp_path / "nope")).n_events == 0
    assert tprof.latest_profile(str(tmp_path)) is None
    with pytest.raises(ValueError):
        tprof.parse_chrome_trace({"no": "events"})


def test_op_class_vocabulary_equals_jax():
    names = ["dot.3", "dot_general", "convolution.1", "conv", "fusion.12",
             "broadcast_add_fusion", "all-reduce-start.1", "all-reduce.7",
             "all_gather", "reduce-scatter-done.2", "all-to-all",
             "collective-permute-start.1", "collective_broadcast",
             "custom-call.4", "copy-start.1", "copy_done", "reduce.9",
             "add.1", "while", "all-gather-start"]
    assert [tprof.op_class(n) for n in names] == \
        [jprof.op_class(n) for n in names]
    # the card's library kernels by name (no HLO name carries these)
    assert tprof.op_class("sm90_xmma_gemm_f32f32_tf32f32_f32_nn") == "dot"
    assert tprof.op_class("ampere_sgemm_128x64_tn") == "dot"
    assert tprof.op_class("cudnn::conv2d_grouped_direct_kernel") == "conv"
    assert tprof.op_class("Memcpy HtoD (Pinned -> Device)") == "copy"
    assert tprof.op_class("paged_attention_kernel") == "other"


def _chrome_trace():
    """Two traced steps on the card: step 0 replays a graph of two
    kernels, step 1 launches one kernel and a copy; the kernels run on
    stream 7, well after their launches return."""
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                "ts": ts, "dur": dur, "args": args}

    ev = [
        x("user_annotation", "prof_step", 0.0, 10.0),
        x("cuda_runtime", "cudaMemcpyAsync", 1.0, 1.0, correlation=10),
        x("cuda_runtime", "cudaGraphLaunch", 3.0, 2.0, correlation=11),
        x("cpu_op", "aten::copy_", 0.5, 2.0),
        x("user_annotation", "obs_region", 2.0, 1.0),
        x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 2.0, 1.0, tid=7,
          device=0, stream=7, correlation=10),
        x("kernel", "paged_attention_kernel", 6.0, 20.0, tid=7, device=0,
          stream=7, correlation=11),
        x("kernel", "layernorm_fwd_warp_kernel", 26.0, 4.0, tid=7, device=0,
          stream=7, correlation=11),
        x("user_annotation", "prof_step", 40.0, 5.0),
        x("cuda_runtime", "cudaLaunchKernel", 41.0, 1.0, correlation=12),
        x("kernel", "paged_attention_kernel", 50.0, 15.0, tid=7, device=0,
          stream=7, correlation=12),
        {"ph": "f", "cat": "ac2g", "name": "flow", "id": 12, "ts": 50.0},
        {"ph": "M", "name": "process_name", "args": {"name": "x"}},
    ]
    return {"baseTimeNanoseconds": 1000, "traceEvents": ev}


def test_chrome_trace_device_windows_and_rows():
    tl = tprof.parse_chrome_trace(json.dumps(_chrome_trace()))
    assert [p.name for p in tl.planes] == ["/device:GPU:0", "/host:CPU"]
    rep = tprof.measured_report(tl)
    assert [(o.device, o.lane, o.name) for o in rep.op_rows] == [
        ("/device:GPU:0", "stream 7", "Memcpy HtoD (Pinned -> Device)"),
        ("/device:GPU:0", "stream 7", "paged_attention_kernel"),
        ("/device:GPU:0", "stream 7", "layernorm_fwd_warp_kernel"),
        ("/device:GPU:0", "stream 7", "paged_attention_kernel")]
    rows = rep.step_rows()
    # each step's device time: the window of its rows ([2, 30] us, [50,
    # 65]), not the host's annotation; the card busy in it apart
    assert [(s.step, s.start_ns, s.dur_ns) for s in rows] == [
        (0, 1000 + 2000.0, 28000.0), (1, 1000 + 50000.0, 15000.0)]
    spans = rep.span_breakdown()
    assert spans["prof_step.host"]["count"] == 2
    # 1 + 20 + 4 us busy of the first window, 15 of the second
    assert spans["prof_step.busy"]["seconds"] == pytest.approx(40e-6)
    assert spans["prof_step.busy"]["steps"] == [0, 1]
    assert spans["obs_region"]["steps"] == [0]
    hot = {h["name"]: h for h in rep.hot_ops(10)}
    assert hot["paged_attention_kernel"]["count"] == 2
    assert hot["paged_attention_kernel"]["total_ns"] == 35000.0
    assert rep.per_device_totals() == {"/device:GPU:0": pytest.approx(
        1e-6 + 35e-6 + 4e-6)}


def test_cpu_capture_has_a_step_row_a_call(tmp_path):
    x = torch.ones(32, 32)
    cap = tprof.capture(lambda: (x @ x).sum(), steps=3, warmup=1,
                        trace_dir=str(tmp_path), step_offset=5)
    rep = cap.report
    assert cap.steps == 3 and len(rep.step_rows()) == 3
    assert [s.step for s in rep.step_rows()] == [5, 6, 7]
    assert rep.devices() == ["/device:CPU:0"]
    assert any(h["name"] == "aten::mm" for h in rep.hot_ops(20))
    assert all(v > 0 for v in rep.step_seconds())
    assert os.path.isfile(os.path.join(cap.run_dir, tprof.TRACE_FILE))
    assert tprof.parse_trace(str(tmp_path)).source == cap.run_dir
    json.dumps(cap.summary())


def test_card_capture_without_device_rows_raises(tmp_path, monkeypatch):
    # the profiler records no kernel (a machine without CUPTI, or a
    # session that lost its card activity): no host-only report of a
    # device program
    start = tprof._start
    monkeypatch.setattr(tprof, "_start", lambda device: start(None))
    monkeypatch.setattr(tprof, "_block", lambda out, device=None: None)
    with pytest.raises(RuntimeError, match="no device rows"):
        tprof.capture(lambda: torch.ones(4).sum(), steps=1, warmup=0,
                      trace_dir=str(tmp_path), device=torch.device("cuda"))
    assert not tprof.trace_active()


@pytest.mark.parametrize("eager_calls,ok", [(0, True), (2, True),
                                             (99, False)])
def test_replays_only_traces_replays(tmp_path, monkeypatch, eager_calls,
                                     ok):
    """A step graph warms up, then captures, then replays: the capture's
    untraced calls run until one replays, and a traced call that did not
    replay raises."""
    calls = []

    def step():
        calls.append(tprof.trace_active())
        if len(calls) <= eager_calls:
            monkeypatch.setattr(cg, "_unreplayed", cg._unreplayed + 1)
        return torch.ones(2)

    if not ok:
        with pytest.raises(RuntimeError, match="no replay to trace"):
            tprof.capture(step, steps=2, warmup=1, trace_dir=str(tmp_path),
                          replays_only=True)
        return
    cap = tprof.capture(step, steps=2, warmup=1, trace_dir=str(tmp_path),
                        replays_only=True)
    assert calls.count(True) == 2 and len(cap.report.step_rows()) == 2
    assert calls.count(False) == max(1, eager_calls + 1)


def test_step_graph_replays_next_off_the_card():
    g = cg.StepGraph(lambda: (torch.ones(2),), ("sig",), torch.device("cpu"))
    assert g.replays_next
    g()
    assert g.replays_next and g.calls == 1


@pytest.mark.parametrize("knob,value,recaptures", [
    ("prof_every_n_steps", 3, False), ("trace", True, False),
    ("fleet_dir", "/x", False), ("router_seed", 5, False),
    ("serve_max_queue", 3, False), ("fused_layernorm", False, True),
    ("fused_adam", False, True)])
def test_capture_state_ignores_host_only_knobs(knob, value, recaptures):
    """Turning on a periodic capture (or tracing, a fleet dir, a router
    setting) must not make the owners capture their step graphs anew; a
    kernel knob still does."""
    before = cg.capture_state()
    old = tconfig._values.get(knob, None)
    try:
        tconfig.set(knob, value)
        assert (cg.capture_state() != before) == recaptures
    finally:
        if old is None:
            tconfig._values.pop(knob, None)
        else:
            tconfig._values[knob] = old


def test_step_knobs_are_the_knobs_the_kernels_read():
    """``config.STEP_KNOBS`` (what ``capture_state`` keys captured
    programs on) names every knob that the ops and the optimizer read, so
    a knob a captured step reads cannot be left out of the key."""
    import re

    root = os.path.join(REPO, "mxnet_tpu_torch")
    read = set()
    for path in glob.glob(os.path.join(root, "ops", "*.py")) + [
            os.path.join(root, "optimizer.py")]:
        with open(path) as f:
            read |= set(re.findall(r"_config\.get\(\"(\w+)\"\)", f.read()))
    assert read == set(tconfig.STEP_KNOBS)
    assert set(tconfig.STEP_KNOBS) <= set(tconfig._KNOBS)


# -- the step-capture controller --------------------------------------------------
@pytest.fixture
def controllers(monkeypatch):
    monkeypatch.setattr(jobs, "_dir", None)
    monkeypatch.setattr(tobs, "_dir", None)
    yield
    for cfg, prof in ((jconfig, jprof), (tconfig, tprof)):
        cfg.set("prof_every_n_steps", 0)
        cfg.set("fleet_dir", "")
        cfg.set("prof_keep_bytes", 512 * 1024 * 1024)
        prof._reset_controller()


def _jax_step(seed=0):
    mx.random.seed(seed)
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, in_units=8, activation="relu"),
            jnn.Dense(4, in_units=16))
    net.initialize()
    x, y = nd.ones((2, 8)), nd.zeros((2, 4))
    _ = net(x)
    ts = JTrainStep(net, lambda o, yy: ((o - yy) ** 2).mean(),
                    jopt.SGD(learning_rate=0.1))
    return lambda: ts(x, y)


def _port_step():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 4))
    ts = TrainStep(net, lambda o, yy: ((o - yy) ** 2).mean(),
                   topt.SGD(learning_rate=0.1))
    x, y = torch.ones(2, 8), torch.zeros(2, 4)
    return lambda: ts(x, y)


def _controller_run(side, d, every_n=0, keep=512 * 1024 * 1024,
                    trigger_at=None, steps=7):
    cfg, prof, make = {"jax": (jconfig, jprof, _jax_step),
                       "port": (tconfig, tprof, _port_step)}[side]
    cfg.set("prof_every_n_steps", every_n)
    cfg.set("profiler_dir", os.path.join(d, "local"))
    cfg.set("prof_keep_bytes", keep)
    if trigger_at is not None:
        cfg.set("fleet_dir", os.path.join(d, "fleet"))
        os.makedirs(os.path.join(d, "fleet"), exist_ok=True)
    prof._reset_controller()
    step = make()
    for i in range(1, steps + 1):
        if i == trigger_at:
            with open(prof.request_path(os.path.join(d, "fleet"), 0),
                      "w") as f:
                json.dump({"reason": "straggler"}, f)
            prof._ensure_controller()._next_probe = 0.0
        step()
    caps = sorted(glob.glob(os.path.join(d, "*", "*", "prof-*")))
    out = []
    for c in caps:
        snap = prof.latest_profile(c)
        out.append((os.path.basename(c), snap["meta"]["trigger"],
                    snap["meta"]["step"], snap["report"]["steps"],
                    snap["report"]["n_op_rows"] > 0))
    return out


@pytest.mark.parametrize("case", ["periodic", "trigger", "retention"])
def test_controller_decisions_equal_jax(tmp_path, controllers, case):
    kw = {"periodic": dict(every_n=3), "trigger": dict(trigger_at=4),
          "retention": dict(every_n=1, keep=1, steps=3)}[case]
    want = _controller_run("jax", str(tmp_path / "jax"), **kw)
    got = _controller_run("port", str(tmp_path / "port"), **kw)
    assert got == want
    names = [c[0] for c in got]
    assert names == {"periodic": ["prof-g0-s3-periodic",
                                  "prof-g0-s6-periodic"],
                     "trigger": ["prof-g0-s4-straggler"],
                     "retention": ["prof-g0-s3-periodic"]}[case]
    assert all(c[3] == 1 and c[4] for c in got)
    if case == "trigger":
        assert not os.path.exists(tprof.request_path(
            str(tmp_path / "port" / "fleet"), 0))


def test_controller_defers_a_capturing_step(tmp_path):
    ctl = tprof.CaptureController(every_n=2, fleet_dir=str(tmp_path),
                                  base_dir=str(tmp_path), keep_bytes=0,
                                  rank=0, generation=0)
    with open(tprof.request_path(str(tmp_path), 0), "w") as f:
        f.write("{}")
    assert ctl.begin_if_due(1, replay=False) is None
    assert ctl.begin_if_due(2, replay=False) is None  # due, but capturing
    assert os.path.exists(tprof.request_path(str(tmp_path), 0))
    tok = ctl.begin_if_due(3, replay=True)  # the next replay takes it
    assert tok is not None and tok["trigger"] == "periodic"
    assert tprof.trace_active()
    path = ctl.end(tok, torch.ones(1))
    assert not tprof.trace_active()
    assert json.load(open(path))["meta"]["step"] == 3
    ctl._next_probe = 0.0
    tok = ctl.begin_if_due(4, replay=True)
    assert tok["trigger"] == "straggler"
    ctl.abort(tok)  # a traced step that raised releases the session
    assert not tprof.trace_active()
    cap = tprof.capture(lambda: None, steps=1, warmup=0,
                        trace_dir=str(tmp_path / "after"))
    assert cap.steps == 1


@pytest.mark.parametrize("window", [None, 2])
def test_captured_step_time_leaves_out_the_session_opening(
        tmp_path, controllers, monkeypatch, window):
    """A periodic capture opens its session inside the traced step; that
    opening (on the card a sync and QUIET_S, here a planted 0.4 s) is
    not the step's, so the recorded step seconds leave it out."""
    start = tprof._start

    def slow_start(device):
        prof = start(device)
        time.sleep(0.4)
        return prof

    monkeypatch.setattr(tprof, "_start", slow_start)
    tconfig.set("prof_every_n_steps", 2)
    tconfig.set("profiler_dir", str(tmp_path / "local"))
    tprof._reset_controller()
    ts = _port_step().__closure__[0].cell_contents
    x, y = torch.ones(2, 8), torch.zeros(2, 4)
    d = tobs.enable(str(tmp_path / "tel"))
    try:
        for _ in range(4):
            if window:
                ts.run(iter([(x, y)] * window), window, window=window)
            else:
                ts(x, y)
        event, key = (("train_window", "window_seconds") if window else
                      ("train_step", "step_seconds"))
        secs = [e[key] for e in tobs.read_events(d) if e["event"] == event]
    finally:
        tobs.disable()
    caps = glob.glob(os.path.join(str(tmp_path), "**", "prof-*",
                                  "profile.json"), recursive=True)
    assert len(caps) == 2  # two of the four calls were traced
    assert len(secs) == 4 and max(secs) < 0.3, secs


def test_profile_entry_points_on_the_cpu(tmp_path):
    net = tgpt2.GPT2Model(num_layers=2, units=32, num_heads=2, max_length=32,
                          vocab_size=41, dropout=0.0, device="cpu", seed=0)
    eng = GenerationEngine(net, device="cpu", batch_size=2,
                           prefill_buckets=(8,), paged=True, page_size=4,
                           num_pages=12, eos_id=None, pad_id=0)
    cap = eng.profile(steps=4, trace_dir=str(tmp_path / "decode"))
    assert len(cap.report.step_rows()) == 4 and eng.done[0]
    assert eng.free_pages == eng.num_pages
    with pytest.raises(NotImplementedError, match="analysis"):
        eng.profile(calibrate=True)
    step = _port_step()
    ts = step.__closure__[0].cell_contents  # the TrainStep
    x, y = torch.ones(2, 8), torch.zeros(2, 4)
    n0 = ts.optimizer.num_update
    cap = ts.profile(x, y, steps=2, warmup=1, trace_dir=str(tmp_path / "ts"))
    assert len(cap.report.step_rows()) == 2
    assert ts.optimizer.num_update == n0 + 3  # the profiled steps train
    cap = ts.profile(x, y, steps=1, warmup=0, window=2,
                     trace_dir=str(tmp_path / "win"))
    assert len(cap.report.step_rows()) == 1
    with pytest.raises(NotImplementedError, match="analysis"):
        ts.profile(x, y, calibrate=True)
    with pytest.raises(NotImplementedError):
        tprof.calibrate(None, cap.report)


def test_snapshot_reads_equal_in_both_packages(tmp_path, capsys):
    x = torch.ones(16, 16)
    cap = tprof.capture(lambda: x @ x, steps=2, warmup=0,
                        trace_dir=str(tmp_path / "telemetry-h0"
                                      / "prof-g0-s2-periodic"))
    path = tprof.write_snapshot(cap, os.path.join(
        str(tmp_path), "telemetry-h0", "prof-g0-s2-periodic"), rank=0,
        step=2, trigger="periodic")
    assert json.load(open(path))["report"]["steps"] == 2
    with open(tmp_path / "telemetry-h0" / "metrics-g0.json", "w") as f:
        json.dump({"meta": {"rank": 0}, "metrics": {}}, f)
    got = tfleet.FleetAggregator(str(tmp_path)).collect().summary()
    want = jfleet.FleetAggregator(str(tmp_path)).collect().summary()
    assert got == want and got["profiles"]["0"]["meta"]["step"] == 2
    jpr = _load("profreport_jax", os.path.join(REPO, "tools",
                                               "profreport.py"))
    tpr = _load("profreport_port", os.path.join(REPO, "tools",
                                                "torch_profreport.py"))
    for args in ([path], [path, "--json"]):
        assert jpr.main(args) == 0
        want_out = capsys.readouterr().out
        assert tpr.main(args) == 0
        assert capsys.readouterr().out == want_out
    # a raw torch.profiler session directory, parsed on the spot
    assert tpr.main([cap.run_dir, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["report"]["steps"] == 2
    assert tpr.main([str(tmp_path / "nothing")]) != 0

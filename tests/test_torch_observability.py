"""The port's telemetry against the JAX package's: the same operations on
JAX's ``metrics.Registry`` and the port's give the same ``snapshot()``, the
same Prometheus text and the same JSON; an ``EventLog`` written, rotated
and read back gives the same records apart from timestamps; ``enable`` /
``shutdown`` write the same exports; ``span`` records only when telemetry
is on; and the knobs of the serving-resilience slice carry the JAX names,
types, defaults and env aliases."""
import json
import os
import tempfile

import pytest

from mxnet_tpu import config as jconfig
from mxnet_tpu import observability as jobs
from mxnet_tpu.observability import events as jevents
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.observability import events as tevents
from mxnet_tpu_torch.observability import metrics as tmetrics


def _counters(r):
    c = r.counter("gen_requests_total", "completed generation requests")
    c.inc(reason="eos")
    c.inc(3, reason="length")
    c.inc(reason="eos")
    r.counter("retry_attempts_total", "attempts").inc(site="gen.decode",
                                                      ok="false")
    with pytest.raises(ValueError):
        c.inc(-1)
    return [c.value(reason="eos"), c.total()]


def _gauges(r):
    g = r.gauge("gen_pages_free", "free pages")
    g.set(512)
    g.inc(-3)
    g.set(7, pool="draft")
    r.gauge("gen_spec_mode", "1 = spec").set(1.0)
    return [g.value(), g.value(pool="draft"), g.value(pool="none")]


def _histograms(r):
    h = r.histogram("ttft_seconds", "submit -> first token", unit="s")
    for v in (0.0004, 0.0005, 0.003, 0.3, 2.0, 61.0, 75.0):
        h.observe(v)
    h.observe(0.02, outcome="admitted")
    e = r.histogram("gen_queue_age_seconds", "age", unit="s",
                    buckets=(1.0, 0.1, 10.0))
    for v in (0.05, 0.1, 0.5, 100.0):
        e.observe(v, outcome="shed")
    return [h.percentile(0.5), h.percentile(0.99), h.total_count(),
            h.total_sum(), e.stats(outcome="shed"), h.series()]


def _labels_and_help(r):
    r.counter("gen_shed_total",
              'requests "shed" \\ by\ncontrol').inc(cause='queue"full\n\\')
    r.gauge("gen_active_slots").set(3)  # no help line
    return []


def _clash_and_reset(r):
    r.counter("gen_forks_total").inc(2)
    with pytest.raises(ValueError):
        r.gauge("gen_forks_total")
    r.gauge("gen_pages_in_use").set(5)
    r.reset("gen_forks_total")
    r.reset("no_such_metric")
    before = r.names()
    r.counter("gen_forks_total").inc()
    r.reset()
    r.counter("gen_cow_copies_total").inc(4)
    return [before, r.names()]


OPS = {f.__name__: f for f in (_counters, _gauges, _histograms,
                                _labels_and_help, _clash_and_reset)}


@pytest.mark.parametrize("name", sorted(OPS))
def test_registry_matches_jax(name):
    """The same operations give the same values, snapshot, Prometheus text
    and JSON."""
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    assert OPS[name](treg) == OPS[name](jreg)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert treg.to_json(indent=1) == jreg.to_json(indent=1)


def test_series_percentile_matches_jax():
    s = {"count": 10, "max": 7.0, "buckets": [1, 0, 4, 5, 0]}
    edges = (0.1, 0.5, 1.0, 5.0)
    for q in (0.0, 0.1, 0.5, 0.95, 1.0):
        assert tmetrics.series_percentile(s, edges, q) == \
            jmetrics.series_percentile(s, edges, q)
    assert tmetrics.series_percentile(None, edges, 0.5) is None


def _write_log(mod, path, **kw):
    log = mod.EventLog().configure(str(path), run_id="run-1", **kw)
    log.set_step(3)
    for i in range(40):
        log.emit("gen_spec_fallback", accept_rate=i / 40, window=8,
                 payload="x" * 30)
        if i == 38:  # late: still in the live file at keep_bytes 0
            log.emit("gen_stuck_dispatch", step=17, family="decode",
                     victims={"0": 4})
    log.close()
    return log


@pytest.mark.parametrize("keep", [0, 10_000])
def test_event_log_rotation_matches_jax(tmp_path, keep):
    """Written past the rotation threshold (gzip segments, retention by
    ``keep_bytes``), then read back: the same records in the same order,
    apart from the timestamps, and the same segment files."""
    recs, files = {}, {}
    for key, mod in (("jax", jevents), ("port", tevents)):
        d = tmp_path / key
        _write_log(mod, d / "events-h0.jsonl", rotate_bytes=1000,
                   keep_bytes=keep)
        recs[key] = [{k: v for k, v in r.items() if k != "ts"}
                     for r in mod.read_events(str(d))]
        files[key] = sorted(os.listdir(d))
        assert recs[key] and all("ts" in r for r in mod.read_events(str(d)))
    assert recs["port"] == recs["jax"]
    assert files["port"] == files["jax"]
    assert any(f.endswith(".gz") for f in files["port"])
    stuck = [r for r in recs["port"] if r["event"] == "gen_stuck_dispatch"]
    assert stuck[0]["step"] == 17 and stuck[0]["host"] == 0


def test_unconfigured_log_drops_and_unwritable_log_disables(tmp_path):
    for mod in (jevents, tevents):
        assert mod.EventLog().emit("x") is False
        log = mod.EventLog().configure(str(tmp_path / mod.__name__ / "e.jsonl"))
        log._fh.close()  # a dead handle: emit must not raise
        assert log.emit("x") is False and not log.configured


def test_enable_shutdown_write_the_same_exports(tmp_path):
    """``enable`` opens events-h0.jsonl with a ``telemetry_enabled``
    record; ``shutdown`` writes metrics.json and metrics.prom of the
    registry."""
    out = {}
    for key, obs in (("jax", jobs), ("port", tobs)):
        d = tmp_path / key
        obs.REGISTRY.reset()
        try:
            assert obs.enable(str(d), run_id="r") == str(d)
            assert obs.enabled()
            obs.counter("gen_spec_rounds_total", "rounds").inc(5)
            obs.emit("gen_spec_rearm", cooldown=16)
            obs.shutdown()
        finally:
            obs.disable()
        assert not obs.enabled()
        evs = [(e["event"], e["run"]) for e in obs.read_events(str(d))]
        snap = json.loads((d / "metrics.json").read_text())
        out[key] = (evs, snap["gen_spec_rounds_total"],
                    (d / "metrics.prom").read_text().count(
                        "gen_spec_rounds_total 5.0"))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [("telemetry_enabled", "r"),
                              ("gen_spec_rearm", "r")]


def test_span_records_only_when_enabled(tmp_path):
    """``span`` is a no-op with telemetry off; on, it times the region
    into ``span_seconds{span=...}`` (under a profiler record_function),
    even when the body raises."""
    tobs.REGISTRY.reset()
    tobs.disable()
    with tobs.span("decode.round"):
        pass
    assert tobs.REGISTRY.get("span_seconds") is None or \
        tobs.REGISTRY.get("span_seconds").total_count() == 0
    tobs.enable(str(tmp_path))
    try:
        with tobs.span("decode.round", slot=1):
            pass
        with pytest.raises(KeyError):
            with tobs.span("decode.round", slot=1):
                raise KeyError("body")
    finally:
        tobs.disable()
    h = tobs.REGISTRY.get("span_seconds")
    assert h.stats(span="decode.round", slot=1)["count"] == 2


SLICE_KNOBS = ("faults", "retry_max_attempts", "retry_base_delay",
               "retry_max_delay", "retry_jitter", "retry_timeout",
               "serve_default_deadline", "serve_max_queue",
               "serve_queue_policy", "serve_shed_page_floor",
               "serve_head_aging_steps", "serve_spec_window",
               "serve_spec_floor", "serve_spec_cooldown", "serve_watchdog_s",
               "telemetry", "telemetry_dir", "telemetry_rotate_mb",
               "events_keep_bytes")


#: defaults the port chose apart from JAX's: the JAX package's fixed
#: /tmp/mxnet_tpu_telemetry would be shared by every checkout and process
#: on a machine; the port's empty default makes a directory per process
PORT_DEFAULTS = {"telemetry_dir": ""}


@pytest.mark.parametrize("name", SLICE_KNOBS)
def test_knob_matches_jax(name, monkeypatch):
    """Name, type, default and env aliases as in ``mxnet_tpu.config``
    (apart from ``PORT_DEFAULTS``), and an env alias parses to the same
    value."""
    jt, jd, jenv, _ = jconfig._KNOBS[name]
    tt, td, tenv, _ = tconfig._KNOBS[name]
    assert (tt, td, tenv) == (jt, PORT_DEFAULTS.get(name, jd), jenv)
    raw = {bool: "1", int: "7", float: "0.5", str: "shed"}[tt]
    monkeypatch.setenv(tenv[0], raw)
    assert tconfig.get(name) == jconfig.get(name)


def test_enable_without_a_directory_makes_its_own(tmp_path, monkeypatch):
    """With neither a directory nor the knob, ``enable`` opens a new
    directory under the temporary directory (TMPDIR), one per call."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    try:
        first = tobs.enable()
        tobs.shutdown()
        second = tobs.enable()
        tobs.shutdown()
    finally:
        tobs.disable()
    assert first != second
    for d in (first, second):
        assert os.path.dirname(d) == str(tmp_path)
        assert os.path.basename(d).startswith("mxnet_tpu_telemetry-")
        assert os.path.exists(os.path.join(d, "metrics.json"))
    monkeypatch.setenv("MXNET_TPU_TELEMETRY_DIR", str(tmp_path / "knob"))
    try:
        assert tobs.enable() == str(tmp_path / "knob")
    finally:
        tobs.disable()

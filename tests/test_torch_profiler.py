"""``mx.profiler`` of the port (``mxnet_tpu_torch/profiler.py``) against
the JAX package's: the same control surface (names and signatures), the
same ``scope`` aggregates in ``profiler_scope_seconds``, the same per-plane
table on the same trace, and a ``run``/``stop``/``dump`` session over
``torch.profiler`` on the CPU whose table names the ops it ran."""
import inspect
import os

import pytest
import torch

from mxnet_tpu import profiler as jprofiler
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.observability import profiling as tprof

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "xplane")


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(profiler, "_state", {
        "running": False, "dir": "", "ever_ran": False, "prof": None})
    yield
    profiler.set_state("stop")


@pytest.mark.parametrize("name", sorted(jprofiler.__all__) + ["annotate"])
def test_surface_matches_jax(name):
    assert name in profiler.__all__ or name == "annotate"
    got, want = getattr(profiler, name), getattr(jprofiler, name)
    if inspect.isclass(want):
        want, got = want.__init__, got.__init__
    assert list(inspect.signature(got).parameters) == \
        list(inspect.signature(want).parameters)


def test_scope_aggregates_without_a_trace(fresh):
    profiler.dumps(reset=True)
    with profiler.scope("unit_scope"):
        _ = torch.ones(8, 8).sum().item()
    table = profiler.dumps()
    assert "scope:unit_scope" in table
    for col in ("Name", "Count", "Total(ms)", "Avg(ms)", "Min(ms)",
                "Max(ms)"):
        assert col in table
    s = tobs.REGISTRY.get("profiler_scope_seconds").stats(scope="unit_scope")
    assert s["count"] == 1
    assert profiler.dump() is None  # no session ever ran


def test_per_plane_table_equals_jax_on_one_trace(fresh):
    profiler._state["dir"] = FIXTURE
    stats = profiler._aggregate(FIXTURE)
    assert stats == jprofiler._aggregate_xplane(FIXTURE)
    assert ("/device:TPU:0", "dot.1") in stats
    assert ("/device:TPU:1", "dot.1") in stats
    table = profiler.dumps(reset=True)
    assert "Per-device totals" in table


def test_run_stop_dump_session(fresh, tmp_path):
    d = str(tmp_path / "prof")
    os.makedirs(d)
    profiler.set_config(filename=os.path.join(d, "profile.json"),
                        aggregate_stats=True)
    profiler.set_state("run")
    profiler.set_state("run")  # a second run is a no-op
    assert tprof.trace_active()
    with pytest.raises(RuntimeError, match="already active"):
        tprof.capture(lambda: None, steps=1, warmup=0,
                      trace_dir=str(tmp_path / "c"))
    with profiler.scope("profiled_matmul"):
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x * 1e-2
    profiler.set_state("stop")
    assert not tprof.trace_active()
    out_dir = profiler.dump()
    assert out_dir == d
    assert tprof.parse_trace(d).n_events > 0
    table = profiler.dumps(reset=True)
    lines = table.splitlines()
    assert lines[0] == "Profile Statistics"
    rows = [ln for ln in lines[3:] if ln.strip()]
    assert any(ln.startswith("aten::mm") for ln in rows), table
    assert any("profiled_matmul" in ln for ln in rows)
    assert not any(ln.startswith("$") for ln in rows)
    assert "scope:profiled_matmul" not in profiler.dumps()
    with profiler.Profiler(str(tmp_path / "p2")):
        profiler.pause()
        profiler.resume()
        _ = torch.ones(4).sum()
    assert not profiler._state["running"]
    assert profiler.dump() == str(tmp_path / "p2")


def test_run_inside_another_session_records_nothing(fresh, tmp_path):
    profiler.set_config(filename=str(tmp_path / "x" / "p.json"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiler.set_state("run")
        assert profiler._state["running"] and profiler._state["prof"] is None
        profiler.set_state("stop")
    assert not os.path.exists(str(tmp_path / "x" / "plugins"))

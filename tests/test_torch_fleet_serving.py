"""The port's serving fleet against the JAX package's
(``mxnet_tpu_torch/serving`` vs ``mxnet_tpu/serving``), on the same
inputs:

  - fleet health: the LIVE -> DEGRADED -> DRAINING -> DEAD state machine
    gives the same transitions on the same heartbeat and stuck script,
    and the same ``router_replica_state`` gauges and transition counters;
  - the router over duck-typed batchers (no engine): placements,
    finish reasons, redistributions and trace records equal call by call
    in each scenario (priority classes, power-of-two choices, affinity by
    session and by prompt prefix, the queue bound, a dead replica, a
    deadline that redistribution must not extend, an empty fleet, a dead
    id that never re-attaches, the router's published snapshot);
  - replica publish and ``read_fleet_views``: either package's snapshot
    reads the same in the other's (a torn newest snapshot falls back to
    the older one), and the slow-request hook drops the capture trigger;
  - the whole tiny fleet drill: JAX's ``run_fleet_drill`` against the
    port's on ``tiny_fleet_plan()`` with the same weights (crossed through
    ``.params``) gives equal tokens, finish reasons, replica assignments,
    health walks, counters, trace checks and router report; the port's
    gate is green on it and red on tampered evidence, and
    ``tools/torch_servedrill.py --fleet --device cpu`` exits 0.
"""
import copy
import importlib.util
import itertools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from mxnet_tpu import observability as jobs
from mxnet_tpu import serving as jserving
from mxnet_tpu.observability import tracing as jtr
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.observability import tracing as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": (jserving, jtr, jobs.REGISTRY),
         "port": (tserving, ttr, tobs.REGISTRY)}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _prompt(n, seed, vocab=97):
    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab, n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- health --------------------------------------------------------------------
def _view(ts, stuck=0.0, active=1.0, queue=0.0):
    return {"ts": ts, "stuck_dispatches": stuck, "active_slots": active,
            "queue_depth": queue}


#: (clock advance, {replica: view or None}) per evaluation
HEALTH_SCRIPTS = {
    "heartbeat_recovers": [(1.0, {0: _view(1.0)}), (2.5, {}),
                           (0.5, {0: _view(4.0)}), (1.0, {0: _view(5.0)})],
    "stuck_drains_dead": [(0.0, {0: _view(0.0)}),
                          (1.0, {0: _view(1.0, stuck=1.0)}),
                          (1.0, {0: _view(2.0, stuck=1.0)}),
                          (3.0, {0: _view(5.0, stuck=1.0)}),
                          (1.0, {0: _view(6.0, stuck=1.0, active=0.0)})],
    "grace_expires": [(3.0, {}), (4.0, {}), (11.0, {}),
                      (1.0, {0: _view(19.0)})],
    "two_replicas": [(1.0, {0: _view(1.0), 1: _view(1.0)}),
                     (1.0, {0: _view(2.0), 1: _view(1.0, stuck=2.0)}),
                     (2.0, {0: _view(4.0, stuck=1.0)}),
                     (2.0, {1: _view(6.0, stuck=2.0, active=0.0)}),
                     (5.0, {0: _view(11.0, stuck=1.0, queue=0.0,
                                     active=0.0)})],
}


@pytest.mark.parametrize("name", sorted(HEALTH_SCRIPTS))
def test_health_state_machine_equals_jax(name):
    out = {}
    for side, (serving, _tr, reg) in SIDES.items():
        clock = FakeClock()
        h = serving.FleetHealth(hb_timeout=2.0, drain_after=3.0,
                                dead_grace=10.0)
        h.register(0, clock())
        trs = []
        for dt, views in HEALTH_SCRIPTS[name]:
            clock.advance(dt)
            trs.append(h.evaluate(clock(), views))
        g = reg.get("router_replica_state")
        out[side] = (trs, {r: h.state(r) for r in h.records}, h.live(),
                     {r: g.value(replica=str(r)) for r in h.records})
    assert out["port"] == out["jax"]
    assert any(out["port"][0])
    assert tserving.STATE_CODES == jserving.STATE_CODES


# -- router over duck-typed batchers -------------------------------------------
class _FakeReq:
    def __init__(self, req_id, prompt, max_new_tokens):
        self.id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.slot = None
        self.finish_reason = None
        self.output = []

    @property
    def done(self):
        return self.finish_reason is not None


class FakeBatcher:
    """Enough surface for ServingReplica and FleetRouter without an
    engine (the JAX tests' duck type)."""

    def __init__(self, capacity=2, free_pages=12):
        self.engine = types.SimpleNamespace(free_pages=free_pages,
                                            num_pages=free_pages)
        self.watchdog = types.SimpleNamespace(replica=None, stalls=0)
        self.capacity = capacity
        self.draining = False
        self.tracer = None
        self._queue = []
        self._slots = []
        self._ids = itertools.count()

    def submit(self, prompt, max_new_tokens=32, deadline_s=None,
               trace_id=None):
        r = _FakeReq(next(self._ids), prompt, max_new_tokens)
        if self.draining:
            r.finish_reason = "shed"
            return r
        self._queue.append(r)
        return r

    def step(self):
        if not self.draining:
            while self._queue and len(self._slots) < self.capacity:
                r = self._queue.pop(0)
                r.slot = len(self._slots)
                self._slots.append(r)
        for r in list(self._slots):
            r.output.append(7 + r.id)
            if len(r.output) >= r.max_new_tokens:
                r.finish_reason = "length"
                self._slots.remove(r)
        return bool(self._slots or self._queue)

    def begin_drain(self):
        self.draining = True

    def withdraw_queued(self):
        out, self._queue = self._queue, []
        for r in out:
            r.finish_reason = "redistributed"
        return out

    def abandon(self):
        out = self.withdraw_queued()
        for r in self._slots:
            r.finish_reason = "redistributed"
            out.append(r)
        self._slots = []
        return out

    @property
    def active(self):
        return len(self._slots)

    @property
    def pending(self):
        return len(self._queue)

    def queue_age_p95(self, now=None):
        return 0.0


def _fleet(side, d, n=2, capacity=2, tracer=True, **kw):
    serving, tr, _reg = SIDES[side]
    clock = FakeClock()
    clock.advance(1.0)
    health = serving.FleetHealth(hb_timeout=2.0, drain_after=1.0,
                                 dead_grace=3.0)
    kw.setdefault("queue_bound", 4)
    kw.setdefault("seed", 0)
    t = tr.Tracer(os.path.join(d, "router", "spans-g0.jsonl"), "router",
                  owner=True, clock=clock,
                  sampler=tr.TailSampler(sample=1.0, seed=0, slow_pct=100.0,
                                         margin_floor=0.0)) \
        if tracer else None
    router = serving.FleetRouter(d, health=health, clock=clock, tracer=t,
                                 **kw)
    reps = {}
    for rid in range(n):
        rep = serving.ServingReplica(rid, FakeBatcher(capacity=capacity), d,
                                     clock=clock)
        rep.publish()
        router.attach(rep)
        reps[rid] = rep
    return serving, router, reps, clock, health


def _scenario(side, d, name):
    """Drive one router scenario; returns its observable outcome."""
    kw = {"priority": dict(n=1, classes=["interactive", "batch"]),
          "queue_bound": dict(n=1, queue_bound=2),
          "dead_replica": dict(capacity=1), "deadline": dict(n=1,
                                                             capacity=1),
          "p2c": dict(n=4, capacity=1), "prefix": dict(n=3,
                                                       prefix_tokens=4),
          "reattach": dict(n=1)}.get(name, {})
    serving, router, reps, clock, health = _fleet(side, d, **kw)
    log = []

    def tick(steppers=None):
        clock.advance(1.0)
        log.append(router.step())
        for rid, rep in list(reps.items()):
            if steppers is None or rid in steppers:
                rep.step()
        log.append(sorted(router.assignments().items()))

    rqs = []
    if name == "priority":
        rqs.append(router.submit(_prompt(4, 1), max_new_tokens=2,
                                 priority="batch"))
        rqs.append(router.submit(_prompt(4, 2), max_new_tokens=2,
                                 priority="interactive"))
        with pytest.raises(ValueError):
            router.submit(_prompt(4, 3), priority="nope")
        for _ in range(4):
            tick()
    elif name == "p2c":
        for s in range(12):
            rqs.append(router.submit(_prompt(4 + s % 3, s),
                                     max_new_tokens=2 + s % 4))
            if s % 3 == 2:
                tick()
        for _ in range(12):
            tick()
    elif name == "queue_bound":
        for s in range(5):
            rqs.append(router.submit(_prompt(4, s), max_new_tokens=2))
        clock.advance(1.0)
        router.step()
        log.append((reps[0].batcher.pending, router.backlog))
        for _ in range(8):
            tick()
    elif name == "session":
        rqs.append(router.submit(_prompt(4, 1), max_new_tokens=2,
                                 session="s"))
        for _ in range(3):
            tick()
        rqs.append(router.submit(_prompt(4, 2), max_new_tokens=2,
                                 session="s"))
        tick()
        clock.advance(3.0)  # silence: the fleet degrades, the pin drops
        router.step()
        log.append(dict(router._sessions))
    elif name == "prefix":
        head = _prompt(4, 9)
        for s in range(6):
            rqs.append(router.submit(head + _prompt(3, s),
                                     max_new_tokens=2))
            tick()
        rqs.append(router.submit(_prompt(2, 5), max_new_tokens=2))
        for _ in range(4):
            tick()
    elif name == "dead_replica":
        for s in range(3):
            rqs.append(router.submit(_prompt(4, s), max_new_tokens=3,
                                     session="s", deadline_s=60.0))
        clock.advance(1.0)
        router.step()
        victim = rqs[0].replicas_tried[0]
        for _ in range(20):
            tick(steppers={r for r in reps if r != victim})
            if all(r.done for r in rqs):
                break
    elif name == "deadline":
        rqs.append(router.submit(_prompt(4, 1), max_new_tokens=50,
                                 deadline_s=2.0))
        clock.advance(1.0)
        router.step()
        for _ in range(10):
            clock.advance(1.0)
            log.append(router.step())
    elif name == "empty":
        router.replicas.clear()
        router.health.records.clear()
        rqs.append(router.submit(_prompt(4, 1), max_new_tokens=2,
                                 deadline_s=1.5))
        clock.advance(2.0)
        router.step()
    elif name == "reattach":
        for dt in (3.0, 2.0, 4.0):
            clock.advance(dt)
            log.append(router.step())
        with pytest.raises(ValueError):
            router.attach(serving.ServingReplica(0, FakeBatcher(), d,
                                                 clock=clock))
        router.attach(serving.ServingReplica(5, FakeBatcher(), d,
                                             clock=clock))
        log.append(sorted(router.replicas))
    log.append(router.publish(0))
    router.tracer.close()
    recs = jtr.read_span_records(os.path.join(d, "router", "spans-g0.jsonl"))
    with open(os.path.join(d, "router", "metrics-g0.json")) as f:
        published = sorted(json.load(f)["metrics"])
    return {"log": log,
            "requests": [(r.id, r.finish_reason, r.output, r.replicas_tried,
                          r.redistributions, r.affinity_key) for r in rqs],
            "idle": router.idle, "records": recs, "published": published,
            "states": {r: health.state(r) for r in health.records}}


ROUTER_SCENARIOS = ["priority", "p2c", "queue_bound", "session", "prefix",
                    "dead_replica", "deadline", "empty", "reattach"]


@pytest.mark.parametrize("name", ROUTER_SCENARIOS)
def test_router_equals_jax_call_by_call(tmp_path, name):
    want = _scenario("jax", str(tmp_path / "jax"), name)
    got = _scenario("port", str(tmp_path / "port"), name)
    assert got == want
    reasons = {r[1] for r in got["requests"]}
    if name == "dead_replica":
        assert reasons == {"length"} and any(r[4] >= 1
                                             for r in got["requests"])
        assert "dead" in got["states"].values()
    if name in ("deadline", "empty"):
        assert reasons == {"deadline"}
    if name == "p2c":
        assert len({r[3][0] for r in got["requests"]}) > 1
    if name == "prefix":
        assert len({r[3][0] for r in got["requests"][:6]}) == 1
    if name != "empty":
        assert all(p.startswith("router_") for p in got["published"])


# -- replica publish and the fleet views ---------------------------------------
def test_replica_views_read_both_ways(tmp_path):
    out = {}
    for side, (serving, _tr, _reg) in SIDES.items():
        d = str(tmp_path / side)
        clock = FakeClock()
        clock.advance(100.0)
        rep = serving.ServingReplica(2, FakeBatcher(), d, clock=clock)
        assert rep.batcher.watchdog.replica == 2
        for s in range(3):
            rep.submit(_prompt(4, s), max_new_tokens=4)
        rep.step()
        clock.advance(1.0)
        rep2 = serving.ServingReplica(0, FakeBatcher(), d, clock=clock)
        rep2.publish()
        # a torn newer generation falls back to the older valid one
        with open(os.path.join(rep2.directory, "metrics-g1.json"),
                  "w") as f:
            f.write('{"meta": {"rank": 0, "ts": 9999.0}, "metr')
        out[side] = d
    for d in out.values():
        views = tserving.read_fleet_views(d)
        assert views == jserving.read_fleet_views(d)
        assert views[2]["active_slots"] == 2.0 and views[2]["ts"] == 100.0
        assert views[0]["ts"] == 101.0 and views[0]["generation"] == 0


def test_slow_request_drops_the_capture_trigger(tmp_path):
    got = {}
    for side, (serving, tr, _reg) in SIDES.items():
        d = str(tmp_path / side)
        clock = FakeClock()
        t = tr.Tracer(os.path.join(d, "telemetry-h3", "spans-g0.jsonl"),
                      "h3", clock=clock,
                      sampler=tr.TailSampler(sample=0.0, seed=0,
                                             slow_pct=100.0,
                                             margin_floor=1.0))
        rep = serving.ServingReplica(3, FakeBatcher(), d, clock=clock,
                                     tracer=t)
        assert rep.batcher.tracer is t and t.capture_cb is not None
        t.finish("x", "length", 0.0, 4.0, deadline=4.5)
        with open(os.path.join(d, "prof-request-h3.json")) as f:
            got[side] = json.load(f)
    assert got["port"] == got["jax"]
    assert got["port"]["reason"] == "slow_request"


# -- the fleet drill -------------------------------------------------------------
@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    jdrill = _load("servedrill_jax_fleet",
                   os.path.join(REPO, "tools", "servedrill.py"))
    tdrill = _load("servedrill_port_fleet",
                   os.path.join(REPO, "tools", "torch_servedrill.py"))
    try:
        want = jdrill.run_fleet_drill(
            telemetry_dir=str(tmp_path_factory.mktemp("jfleet")))
    finally:
        jobs.disable()
    jnet = jdrill.build_net()
    w = {k: np.asarray(p.data().asnumpy())
         for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tgpt2.GPT2Model(num_layers=2, units=64, num_heads=4,
                           max_length=64, vocab_size=61, dropout=0.0,
                           device="cpu")
    tser.load_mxnet_params(tnet, w)
    got = tdrill.run_fleet_drill(
        tnet, tdrill.tiny_fleet_plan(), device="cpu",
        telemetry_dir=str(tmp_path_factory.mktemp("tfleet")))
    return tdrill, want, got


@pytest.mark.parametrize("key", ["requests", "baseline", "transitions",
                                 "counters", "events", "affinity", "traces",
                                 "drained", "router_summary", "ticks",
                                 "kill_rid", "wedge_rid", "router_state",
                                 "replacement_attached"])
def test_fleet_drill_evidence_equals_jax(drills, key):
    _mod, want, got = drills
    assert got[key] == want[key]


def test_fleet_drill_gate_green_and_red_on_tampering(drills):
    mod, _want, drill = drills
    assert mod.validate_fleet(drill) == []
    tre = drill["traces"]
    assert tre["checked"] == len(drill["requests"]) and not tre["missing"]
    assert tre["hops"] == int(drill["counters"]["router_redistributions"])

    def bad(edit):
        d = copy.deepcopy(drill)
        edit(d)
        return mod.validate_fleet(d)

    key = next(k for k, v in drill["requests"].items()
               if v["reason"] == "length" and v["redistributions"] > 0)

    def corrupt(d):
        d["requests"][key]["output"][0] ^= 1

    def drop(d):
        d["requests"][key]["reason"] = None

    def walk(d):
        d["transitions"][d["wedge_rid"]] = [
            {"to": "degraded", "cause": "stuck_dispatch"},
            {"to": "dead", "cause": "drained"}]

    def undrained(d):
        d["drained"][next(iter(d["drained"]))]["active"] = 1

    def orphan(d):
        d["traces"]["orphans"] = ["ghost-999"]

    def hops(d):
        d["traces"]["hops"] += 1

    def drift(d):
        d["traces"]["phase_err_max"] = 0.2

    def affinity(d):
        d["affinity"] = {"first": 2, "first_state": "live", "second": 0}

    for edit, words in ((corrupt, "diverge"), (drop, "never terminated"),
                        (walk, "walked"), (undrained, "not drained"),
                        (orphan, "orphan"), (hops, "does not match"),
                        (drift, "exceeds 5%"), (affinity, "affinity")):
        assert any(words in p for p in bad(edit)), edit.__name__


def test_fleet_drill_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_servedrill.py"),
         "--fleet", "--device", "cpu"], capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "fleetdrill: OK" in out.stdout
    red = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "torch_servedrill.py"),
         "--fleet", "--device", "cpu", "--inject-orphan-span"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert red.returncode == 1 and "orphan" in red.stdout

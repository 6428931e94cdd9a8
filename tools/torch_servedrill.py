#!/usr/bin/env python3
"""Chaos drills for the port's serving path: the counterpart of
``tools/servedrill.py``, its single-replica drill and its ``--fleet``
drill.

    python3 tools/torch_servedrill.py [--device cuda|cpu] [--max-steps N]
                                      [--inject-leak]
    python3 tools/torch_servedrill.py --fleet [--full] [--device cuda|cpu]
                                      [--max-ticks N] [--inject-drop]
                                      [--inject-orphan-span]

Drives :class:`ContinuousBatcher` traffic on a speculative paged engine
under everything the serving-resilience layer is supposed to absorb, at
once:

  - injected transient faults at every serving fault site
    (``gen.prefill`` / ``gen.decode`` / ``gen.verify``, deterministic
    ``every=N`` triggers the 3-attempt retry policy must absorb);
  - deadline pressure (requests expiring both in the queue and mid-slot)
    and an explicit client cancellation, on a scripted fake clock so the
    schedule is deterministic;
  - overload (a bounded admission queue + a submit burst that must shed,
    and with ``shed_page_floor`` set, a late group shed on the free-page
    watermark);
  - a forced speculative accept-rate collapse (a draft that is always
    wrong), so the governor's fallback, cooldown and re-arm all run;
  - the dispatch watchdog armed (and expected silent).

The net, the draft, the device and the plan are parameters, so one
schedule runs at two sizes: :func:`tiny_plan` is the JAX drill's own
(batch 3, pages of 8, a 2-layer net of vocab 61; ``run_drill``'s evidence
then equals ``tools/servedrill.py``'s, apart from wall time and the
``"port"`` entry), and ``chip_smoke.py`` scales it to the serve engine at
full width (:func:`serve_plan`). Like the package's entry points, every
function here runs on the card unless the caller names the CPU
(``device="cpu"``, ``--device cpu``), and raises without a card. The
script runs the tiny plan with a seeded net of its own.

Gate (:func:`validate`, exit 1 on any violation): the drill terminates
within its step budget; every request ends with an explicit finish
reason; rows that completed are bit-identical to an undisturbed
non-speculative baseline and interrupted rows emitted a strict prefix of
it; deadline (queue and slot), cancelled, shed, fallback and re-arm
counters are nonzero (and each shed cause the plan requires); the retry
layer counted failed attempts at every ``gen.*`` site; the drained state
is clean (no active slot, empty queue, every page free, no reservation)
and the watchdog saw no stall. ``--inject-leak`` corrupts the drained
evidence: the gate must then fail.

``--fleet`` is the tier-level drill over ``mxnet_tpu_torch.serving``:
three replicas behind a telemetry-driven router, one replica KILLED
mid-burst (stops stepping and publishing — a dead process) and one WEDGED
(keeps heartbeating but every dispatch trips its watchdog — a stuck
program), and a replacement joining under a fresh id. Its gate
(:func:`validate_fleet`) asserts zero dropped in-deadline requests (every
one re-runs somewhere and finishes bit-identical to an undisturbed
single-engine baseline), the wedged replica's DEGRADED→DRAINING→DEAD walk
with its work redistributed, the replacement, session affinity while the
pinned replica is LIVE, clean survivors, and — request tracing keeps
everything — a gap-free trace for every terminal request whose
router-level phase sums match its end-to-end latency within 5% and whose
hops match ``router_redistributions_total``. :func:`tiny_fleet_plan` is
the JAX drill's schedule exactly (``run_fleet_drill``'s evidence then
equals ``tools/servedrill.py --fleet``'s); :func:`fleet_plan` scales it to
gpt2_345m at the serve engine's width (``--full``, or ``chip_smoke.py``).
Each replica's prefill buckets and decode step are warmed on the card
before the drill's clock starts, and the watchdog is armed only at the
wedge. ``--inject-drop`` and ``--inject-orphan-span`` are the gate's
tested failure paths.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ALLOWED_REASONS = ("eos", "length", "cache_full", "page_exhausted",
                   "deadline", "cancelled", "shed")
SITES = ("gen.prefill", "gen.decode", "gen.verify")


class FakeClock:
    """Deterministic clock the batcher's deadline arithmetic runs on."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt=1.0):
        self.t += dt


class AdversarialDraft:
    """Duck-typed draft model that always proposes ``token``: unless the
    target agrees by luck the accept rate collapses to ~0, every round
    pays a draft and a verify program for one token, and the governor must
    fall back."""

    def __init__(self, vocab, max_length, token=7, device="cuda"):
        from mxnet_tpu_torch.base import resolve_device

        self._vocab = vocab
        self._max_length = max_length
        self._token = token
        self.device = resolve_device(device)

    def eval(self):
        return self

    def init_paged_cache(self, num_pages, page_size, dtype="float32"):
        shape = (num_pages + 1, 1, page_size, 1)
        return [(torch.zeros(shape, device=self.device),
                 torch.zeros(shape, device=self.device))]

    def __call__(self, tokens, cache=None, start_pos=None, page_table=None):
        logits = torch.zeros(tokens.shape + (self._vocab,),
                             device=tokens.device)
        logits[..., self._token] = 10.0
        return logits, cache


Spec = Tuple[str, List[int], int]  # (key, prompt, max_new_tokens)


@dataclasses.dataclass
class Plan:
    """One drill schedule: the engine's and batcher's settings, the fault
    triggers and the requests of each role. The script is fixed: the
    survivors and the slot-deadline request at t=0, the queue-deadline
    request at step 2, the request to cancel at step 3 (cancelled from
    step 8 on, once it holds a slot), the burst at step 6 and the late
    group at ``late_step``; one fake second a step."""

    engine: dict
    batcher: dict
    faults: Dict[str, int]  # site -> every=
    survivors: List[Spec]
    slotdl: Spec
    slot_deadline: float
    queuedl: Spec
    queue_deadline: float
    cancel: Spec
    burst: List[Spec]
    burst_deadline: float = 60.0
    late: List[Spec] = dataclasses.field(default_factory=list)
    late_step: Optional[int] = None
    #: the retry policy's first backoff (jitter 0, seed 0)
    retry_base_delay: float = 0.002
    #: shed causes (gen_shed_total{cause}) validate requires
    require_causes: Tuple[str, ...] = ()

    @property
    def baseline_specs(self) -> List[Spec]:
        """The requests compared with the undisturbed baseline."""
        return self.survivors + [self.slotdl, self.cancel]


def tiny_plan() -> Plan:
    """The JAX drill's schedule (``tools/servedrill.py``), exactly."""
    vocab = 61

    def prompt(n, seed):
        return [int(t) for t in np.random.RandomState(seed).randint(1, vocab, n)]

    return Plan(
        engine=dict(batch_size=3, prefill_buckets=(8, 16), eos_id=None,
                    pad_id=0, paged=True, page_size=8, num_pages=18),
        batcher=dict(max_queue=4, queue_policy="shed", head_aging_steps=4,
                     spec_window=4, spec_floor=0.3, spec_cooldown=5,
                     watchdog_s=30.0),
        faults={"gen.prefill": 3, "gen.decode": 5, "gen.verify": 4},
        survivors=[("surv0", prompt(5, 10), 18), ("surv1", prompt(9, 11), 18),
                   ("surv2", prompt(6, 12), 6)],
        slotdl=("slotdl", prompt(5, 20), 18), slot_deadline=7.0,
        queuedl=("queuedl", prompt(6, 22), 8), queue_deadline=2.0,
        cancel=("cancel", prompt(7, 21), 18),
        burst=[(f"burst{j}", prompt(4, 30 + j), 4) for j in range(5)])


def serve_plan(vocab=50257, seed=0) -> Plan:
    """The tiny schedule scaled to ``chip_smoke.py``'s serve engine: batch
    8, pages of 16, 512 pages, default buckets, EOS 50256; prompts drawn
    like its serve requests (32-500 tokens, seeded), budgets up to 64;
    ``max_queue=8``, policy ``"shed"``; a page floor of 400 free pages,
    which holds while the short survivors run (about 445 free when the
    burst lands at step 6) and is crossed once the burst's 400-500-token
    prompts hold their pages (about 360 free when the late group lands at
    step 24, so the late group sheds on the floor); the governor at window
    8, floor 0.125, cooldown 8."""
    rs = np.random.RandomState(seed)

    def prompt(lo, hi):
        return [int(t) for t in rs.randint(0, vocab, int(rs.randint(lo, hi)))]

    budgets = [64, 56, 48, 40, 32, 24, 8]
    return Plan(
        engine=dict(batch_size=8, max_length=1024, eos_id=50256, pad_id=0,
                    paged=True, page_size=16, num_pages=512),
        batcher=dict(max_queue=8, queue_policy="shed", shed_page_floor=400,
                     spec_window=8, spec_floor=0.125, spec_cooldown=8,
                     watchdog_s=30.0),
        faults={"gen.prefill": 3, "gen.decode": 5, "gen.verify": 4},
        survivors=[(f"surv{i}", prompt(32, 160), n)
                   for i, n in enumerate(budgets)],
        slotdl=("slotdl", prompt(32, 160), 64), slot_deadline=7.0,
        queuedl=("queuedl", prompt(32, 160), 16), queue_deadline=2.0,
        cancel=("cancel", prompt(32, 160), 64),
        burst=[(f"burst{j}", prompt(400, 501), 32) for j in range(10)],
        late=[(f"late{j}", prompt(32, 501), 16) for j in range(3)],
        late_step=24, retry_base_delay=0.001,
        require_causes=("queue_full", "page_floor"))


def _counter(name, **labels):
    from mxnet_tpu_torch.observability import REGISTRY

    c = REGISTRY.get(name)
    if c is None:
        return 0.0
    return c.value(**labels) if labels else c.total()


def _counters() -> dict:
    return {
        "deadline_q": _counter("gen_deadline_expired_total", where="queue"),
        "deadline_s": _counter("gen_deadline_expired_total", where="slot"),
        "cancelled": _counter("gen_requests_total", reason="cancelled"),
        "shed": _counter("gen_shed_total"),
        "fallbacks": _counter("gen_spec_fallbacks_total"),
        "rearms": _counter("gen_spec_rearms_total"),
        "stuck": _counter("gen_stuck_dispatch_total"),
        "retry_fail": {s: _counter("retry_attempts_total", site=s, ok="false")
                       for s in SITES},
    }


def _shed_causes() -> dict:
    from mxnet_tpu_torch.observability import REGISTRY

    c = REGISTRY.get("gen_shed_total")
    return {} if c is None else {k["cause"]: c.value(**k)
                                 for k in c.labelsets()}


def _delta(after, before):
    if isinstance(after, dict):
        return {k: _delta(after[k], before.get(k, 0.0)) for k in after}
    return after - before


def baseline_outputs(net, plan: Plan, device="cuda",
                     engine_type=None) -> Dict[str, List[int]]:
    """Undisturbed plain (non-speculative) paged run of every request the
    drill will interrupt or complete: the bit-identity reference."""
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine

    eng = GenerationEngine(net, device=device, engine_type=engine_type,
                           **plan.engine)
    bat = ContinuousBatcher(eng, device=device)
    reqs = {key: bat.submit(p, max_new_tokens=n)
            for key, p, n in plan.baseline_specs}
    bat.run_until_idle(max_steps=500)
    return {k: r.result() for k, r in reqs.items()}


def run_drill(net, draft, plan: Optional[Plan] = None, device="cuda",
              engine_type=None, max_steps=250, telemetry_dir=None,
              speculate_k=3, engine_hook: Optional[Callable] = None):
    """Run the drill; returns the evidence dict :func:`validate` judges.
    ``draft`` drafts ``speculate_k`` tokens a round; ``engine_hook(eng)``
    runs on the drill's engine before any traffic (``chip_smoke.py``
    counts its calls there)."""
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine
    from mxnet_tpu_torch.resilience import RetryPolicy, faults
    from mxnet_tpu_torch.resilience import retry as retry_mod

    plan = plan or tiny_plan()
    t_wall = time.perf_counter()
    base = baseline_outputs(net, plan, device, engine_type)

    before, causes0 = _counters(), _shed_causes()
    run_dir = telemetry_dir or tempfile.mkdtemp(prefix="servedrill-")
    obs.enable(run_dir, run_id="servedrill")
    # deterministic transient noise on every serving site; every >= 2 so
    # the default 3-attempt policy can never see a fault twice in a row.
    # Invocation counts start from 0, so that two drills in one process
    # (graph and naive) see their faults at the same calls
    faults.reset()
    for site, every in plan.faults.items():
        faults.arm(site, every=every)

    clock = FakeClock()
    eng = GenerationEngine(net, device=device, engine_type=engine_type,
                           draft_net=draft, speculate_k=speculate_k,
                           **plan.engine)
    if engine_hook is not None:
        engine_hook(eng)
    bat = ContinuousBatcher(
        eng, device=device, clock=clock,
        retry_policy=RetryPolicy(base_delay=plan.retry_base_delay,
                                 jitter=0.0, seed=0),
        **plan.batcher)

    def submit(spec, deadline_s=None):
        key, p, n = spec
        reqs[key] = bat.submit(p, max_new_tokens=n, deadline_s=deadline_s)

    reqs = {}
    steps = 0
    try:
        for spec in plan.survivors:
            submit(spec)
        submit(plan.slotdl, plan.slot_deadline)  # expires mid-slot
        while True:
            if steps == 2:
                # every slot busy: this one expires in the QUEUE
                submit(plan.queuedl, plan.queue_deadline)
            if steps == 3:
                submit(plan.cancel)
            if steps == 6:
                # a submit burst against max_queue: the overflow sheds
                for spec in plan.burst:
                    submit(spec, plan.burst_deadline)
            if steps == plan.late_step:
                for spec in plan.late:
                    submit(spec, plan.burst_deadline)
            cancel = reqs[plan.cancel[0]] if steps >= 3 else None
            if (steps >= 8 and not cancel.done and cancel.slot is not None
                    and not cancel.cancel_requested):
                # cancel once the request is decoding in a slot: the next
                # boundary must reclaim it (reason "cancelled")
                if not bat.cancel(cancel.id):
                    raise RuntimeError("cancel refused a live request")
            clock.advance(1.0)
            alive = bat.step()
            steps += 1
            if not alive or steps >= max_steps:
                break
        bat.run_until_idle(max_steps=max(0, max_steps - steps))
    finally:
        for site in plan.faults:
            faults.disarm(site)
        obs.disable()

    return {
        "steps": steps,
        "max_steps": max_steps,
        "wall_s": time.perf_counter() - t_wall,
        "baseline": base,
        "requests": {k: {"reason": r.finish_reason, "output": list(r.output)}
                     for k, r in reqs.items()},
        "counters": _delta(_counters(), before),
        "attempt_log_sites": sorted(
            s for s in SITES
            if any(not a["ok"] for a in retry_mod.attempt_log(s))),
        "events": [e["event"] for e in obs.read_events(run_dir)
                   if e.get("event", "").startswith("gen_spec")],
        "drained": {
            "active": bat.active,
            "pending": bat.pending,
            "free_pages": eng.free_pages,
            "num_pages": eng.num_pages,
            "reserved": eng.reserved_pages,
        },
        # what the JAX drill's evidence has not: shed causes, and those the
        # plan requires
        "port": {"shed_causes": _delta(_shed_causes(), causes0),
                 "require_causes": list(plan.require_causes),
                 "compiled_programs": eng.compiled_programs,
                 "watchdog_stalls": bat.watchdog.stalls},
    }


def validate(result) -> List[str]:
    """Judge a drill result; returns the list of violations (empty = OK)."""
    problems = []
    if result["steps"] >= result["max_steps"]:
        problems.append(f"drill did not drain within {result['max_steps']} "
                        "steps (possible hang)")
    base = result["baseline"]
    for key, rec in result["requests"].items():
        reason, out = rec["reason"], rec["output"]
        if reason not in ALLOWED_REASONS:
            problems.append(f"request {key}: finish reason {reason!r} not in "
                            f"{ALLOWED_REASONS}")
            continue
        want = base.get(key)
        if want is None:
            continue
        if reason in ("eos", "length") and out != want:
            problems.append(f"request {key}: completed tokens diverge from "
                            "the undisturbed baseline (corruption)")
        elif reason not in ("eos", "length") and out != want[:len(out)]:
            problems.append(f"request {key}: interrupted tokens are not a "
                            "prefix of the baseline (corruption)")
    for k, v in result["requests"].items():
        if v["reason"] is None:
            problems.append(f"request {k} never terminated")
    c = result["counters"]
    for name in ("deadline_q", "deadline_s", "cancelled", "shed",
                 "fallbacks", "rearms"):
        if c[name] < 1:
            problems.append(f"expected counter {name} >= 1, got {c[name]}")
    if c["stuck"] != 0:
        problems.append(f"watchdog flagged {c['stuck']} stuck dispatches")
    for site, n in c["retry_fail"].items():
        if n < 1:
            problems.append(f"no failed attempts recorded for fault site "
                            f"{site} (injection or retry bridge broken)")
    if sorted(result["attempt_log_sites"]) != sorted(SITES):
        problems.append("attempt_log missing records for some gen.* site: "
                        f"{result['attempt_log_sites']}")
    ev = set(result["events"])
    if "gen_spec_fallback" not in ev or "gen_spec_rearm" not in ev:
        problems.append(f"fallback/re-arm events missing from telemetry: "
                        f"{sorted(ev)}")
    port = result.get("port", {})
    for cause in port.get("require_causes", ()):
        if port["shed_causes"].get(cause, 0) < 1:
            problems.append(f"no request shed with cause {cause!r}: "
                            f"{port['shed_causes']}")
    d = result["drained"]
    if d["active"] or d["pending"]:
        problems.append(f"not drained: active={d['active']} "
                        f"pending={d['pending']}")
    if d["free_pages"] != d["num_pages"]:
        problems.append(f"page leak: {d['free_pages']}/{d['num_pages']} "
                        "free after drain")
    if d["reserved"]:
        problems.append(f"reservation leaked: {d['reserved']} pages")
    return problems


# ---------------------------------------------------------------------------
# --fleet: the multi-replica chaos drill over mxnet_tpu_torch.serving
# ---------------------------------------------------------------------------

#: (key, prompt, max_new_tokens, priority class[, session])
FSpec = tuple

#: the JAX drill's script (``tools/servedrill.py``), in ticks: one tick is
#: one fake second
KILL_TICK, WEDGE_TICK, REPLACEMENT_RID = 3, 4, 3
HEALTH = dict(hb_timeout=2.5, drain_after=2.0, dead_grace=6.0)
DEADLINE_S, EXPIRE_DEADLINE_S, WEDGE_TIMEOUT_S = 500.0, 1.5, 0.05


@dataclasses.dataclass
class FleetPlan:
    """One fleet-drill schedule: each replica's engine and batcher, the
    undisturbed baseline engine, the router's queue bound, and the
    requests. The script is fixed: ``first`` at tick 0; the kill at
    KILL_TICK (the replica with the most in-flight work); at WEDGE_TICK the
    wedge (the busiest survivor), then ``second`` and the hopeless
    ``expire``; the session's second turn once its first is done; the
    replacement (rid REPLACEMENT_RID) once the wedged replica is DEAD."""

    engine: dict
    batcher: dict
    baseline_engine: dict
    first: List[FSpec]
    second: List[FSpec]
    session2: FSpec
    expire: FSpec
    queue_bound: int = 3

    @property
    def specs(self) -> List[FSpec]:
        return self.first + self.second + [self.session2, self.expire]


def tiny_fleet_plan() -> FleetPlan:
    """The JAX fleet drill's schedule (``tools/servedrill.py``
    ``FLEET_*``), exactly: batch 2, pages of 4, 12 pages, bucket 8, no
    EOS; six requests, then four into the failing fleet."""
    vocab = 61

    def prompt(n, seed):
        return [int(t) for t in np.random.RandomState(seed).randint(1, vocab, n)]

    eng = dict(batch_size=2, prefill_buckets=(8,), eos_id=None, pad_id=0,
               paged=True, page_size=4, num_pages=12)
    return FleetPlan(
        engine=eng, baseline_engine=eng,
        batcher=dict(max_queue=8, queue_policy="reject", watchdog_s=0.0),
        first=[("fs0", prompt(5, 40), 6, "interactive", "sessA"),
               ("fs1", prompt(6, 41), 6, "normal"),
               ("fs2", prompt(7, 42), 6, "normal"),
               ("fs3", prompt(5, 43), 6, "batch"),
               ("fs4", prompt(6, 44), 6, "batch"),
               ("fs5", prompt(7, 45), 6, "normal")],
        second=[("fb0", prompt(5, 50), 6, "normal"),
                ("fb1", prompt(6, 51), 6, "interactive"),
                ("fb2", prompt(7, 52), 6, "batch"),
                ("fb3", prompt(5, 53), 6, "normal")],
        session2=("fsA2", prompt(5, 46), 6, "interactive", "sessA"),
        expire=("expire", prompt(6, 60), 8, "batch"))


def fleet_plan(vocab=50257, seed=0) -> FleetPlan:
    """The tiny schedule at the serve engine's width: each replica batch 8,
    pages of 16, 512 pages, the default buckets, EOS 50256; the baseline
    engine the same. A first burst of 12 requests (prompts of 32-500
    tokens drawn like :func:`serve_plan`'s, budgets of 16-64, the three
    classes, one session), a second of 8 into the failing fleet, the
    session's second turn and one hopeless deadline. Queue bound 4, each
    replica's queue 8."""
    rs = np.random.RandomState(seed)
    classes = ("interactive", "normal", "batch")

    def prompt():
        return [int(t) for t in rs.randint(0, vocab, int(rs.randint(32, 501)))]

    def spec(key, i, session=None):
        out = (key, prompt(), int(rs.randint(16, 65)), classes[i % 3])
        return out + (session,) if session else out

    eng = dict(batch_size=8, max_length=1024, eos_id=50256, pad_id=0,
               paged=True, page_size=16, num_pages=512)
    first = [spec("fs0", 0, "sessA")] + [spec(f"fs{i}", i)
                                         for i in range(1, 12)]
    second = [spec(f"fb{i}", i + 1) for i in range(8)]
    return FleetPlan(
        engine=eng, baseline_engine=eng,
        batcher=dict(max_queue=8, queue_policy="reject", watchdog_s=0.0),
        first=first, second=second,
        session2=spec("fsA2", 0, "sessA"),
        expire=("expire", prompt(), 64, "batch"), queue_bound=4)


def fleet_baseline(net, plan: FleetPlan, device="cuda",
                   engine_type=None) -> Dict[str, List[int]]:
    """Undisturbed single-engine run of every fleet prompt: the
    bit-identity reference a redistributed re-run must still match."""
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine

    eng = GenerationEngine(net, device=device, engine_type=engine_type,
                           **plan.baseline_engine)
    bat = ContinuousBatcher(eng, device=device)
    reqs = {spec[0]: bat.submit(spec[1], max_new_tokens=spec[2])
            for spec in plan.specs}
    bat.run_until_idle(max_steps=100000)
    return {k: r.result() for k, r in reqs.items()}


def _drill_sampler():
    """Keep-everything tail sampler: the drill's gate needs a complete
    trace for EVERY terminal request, not a sample."""
    from mxnet_tpu_torch.observability import tracing

    return tracing.TailSampler(sample=1.0, seed=0, slow_pct=100.0,
                               margin_floor=0.0)


def warm_engine(eng) -> None:
    """Run every prefill bucket and the decode step of ``eng`` through
    their warm-up and capture (two calls each) on a scratch row, so that
    no drill dispatch pays a capture. A no-op off the card."""
    if eng.device.type != "cuda":
        return
    for b in eng.prefill_buckets:
        for _ in range(2):
            eng.prefill([1] * b, slot=0)
            eng.release_slot(0)
    eng.prefill([1], slot=0)
    for _ in range(2):
        eng.decode_step()
    eng.release_slot(0)
    torch.cuda.synchronize(eng.device)


def _fleet_replica(rid, net, fleet_dir, clock, plan: FleetPlan, device,
                   engine_type=None):
    from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine
    from mxnet_tpu_torch.observability import tracing
    from mxnet_tpu_torch.serving import ServingReplica

    eng = GenerationEngine(net, device=device, engine_type=engine_type,
                           **plan.engine)
    warm_engine(eng)
    # watchdog disarmed while healthy: the wedge arms it when it starts
    bat = ContinuousBatcher(eng, device=device, clock=clock, **plan.batcher)
    tr = tracing.Tracer(
        os.path.join(fleet_dir, f"telemetry-h{rid}", "spans-g0.jsonl"),
        source=f"h{rid}", sampler=_drill_sampler(), clock=clock)
    return ServingReplica(rid, bat, fleet_dir, clock=clock, tracer=tr)


def run_fleet_drill(net, plan: Optional[FleetPlan] = None, device="cuda",
                    engine_type=None, max_ticks=60, telemetry_dir=None,
                    fleet_dir=None, inject_orphan_span=False,
                    launch_counts: Optional[Callable] = None):
    """Run the multi-replica drill; returns the evidence dict
    :func:`validate_fleet` judges. One tick = one fake second: the router
    schedules, then every still-running replica steps (the killed one
    stops stepping AND publishing; the wedged one publishes heartbeats but
    every dispatch trips its watchdog). Request tracing keeps everything;
    after the drill the evidence says, per terminal request, whether its
    assembled trace is gap-free with phase sums reconciling against its
    end-to-end latency. ``inject_orphan_span`` appends a span that no
    request owns before assembly (the tested red path).

    ``launch_counts()`` (a dict of counters) is read around every replica
    step, and the evidence's ``port.launches`` holds each replica's
    sums."""
    from mxnet_tpu_torch import observability as obs
    from mxnet_tpu_torch.observability import tracing
    from mxnet_tpu_torch.observability.fleet import FleetAggregator
    from mxnet_tpu_torch.serving import DEAD, LIVE, FleetHealth, FleetRouter

    plan = plan or tiny_fleet_plan()
    t_wall = time.perf_counter()
    base = fleet_baseline(net, plan, device, engine_type)

    before = {
        "redistributed": _counter("gen_requests_total",
                                  reason="redistributed"),
        "router_redistributions": _counter("router_redistributions_total"),
        "stuck": _counter("gen_stuck_dispatch_total"),
    }
    run_dir = telemetry_dir or tempfile.mkdtemp(prefix="fleetdrill-")
    fdir = fleet_dir or tempfile.mkdtemp(prefix="fleetdrill-fleet-")

    clock = FakeClock()
    replicas = {rid: _fleet_replica(rid, net, fdir, clock, plan, device,
                                    engine_type)
                for rid in (0, 1, 2)}
    # the replacement is built (and warmed) before the clock starts too;
    # it joins when the wedged replica is DEAD
    spare = _fleet_replica(REPLACEMENT_RID, net, fdir, clock, plan, device,
                           engine_type)
    obs.enable(run_dir, run_id="fleetdrill")
    health = FleetHealth(**HEALTH)
    router = FleetRouter(fdir, health=health, queue_bound=plan.queue_bound,
                         affinity=True, seed=0, clock=clock,
                         tracer=tracing.Tracer(
                             os.path.join(fdir, "router", "spans-g0.jsonl"),
                             source="router", sampler=_drill_sampler(),
                             owner=True, clock=clock))
    for rep in replicas.values():
        router.attach(rep)

    reqs = {}
    launches: Dict[int, Dict] = {}
    session_key = next(s[0] for s in plan.first if len(s) > 4)

    def sub(spec, deadline_s=None):
        key, prompt, budget, priority = spec[:4]
        reqs[key] = router.submit(
            prompt, max_new_tokens=budget, priority=priority,
            session=spec[4] if len(spec) > 4 else None,
            deadline_s=DEADLINE_S if deadline_s is None else deadline_s)

    def counted_step(rid, rep):
        if launch_counts is None:
            rep.step()
            return
        c0 = launch_counts()
        rep.step()
        acc = launches.setdefault(rid, {})
        for k, v in launch_counts().items():
            acc[k] = acc.get(k, 0) + v - c0.get(k, 0)

    kill_rid = wedge_rid = None
    affinity = {}
    sess2_submitted = replacement_attached = False
    ticks = 0
    try:
        for spec in plan.first:
            sub(spec)
        while ticks < max_ticks:
            clock.advance(1.0)
            ticks += 1
            if ticks == KILL_TICK:
                # kill the replica holding the most in-flight work: its
                # loop AND its publisher stop — a dead process
                counts = router.assignments()
                kill_rid = max(replicas,
                               key=lambda r: (counts.get(r, 0), -r))
            if ticks == WEDGE_TICK:
                # wedge the busiest survivor: heartbeats continue, every
                # dispatch exceeds the watchdog budget
                counts = router.assignments()
                wedge_rid = max(
                    (r for r in replicas if r != kill_rid),
                    key=lambda r: (counts.get(r, 0), -r))
                for spec in plan.second:  # burst into the failing fleet
                    sub(spec)
                sub(plan.expire, deadline_s=EXPIRE_DEADLINE_S)
            router.step()
            if not sess2_submitted and reqs[session_key].done:
                first = (reqs[session_key].replicas_tried[-1]
                         if reqs[session_key].replicas_tried else None)
                affinity = {"first": first,
                            "first_state": None if first is None
                            else router.health.state(first)}
                sub(plan.session2)
                sess2_submitted = True
            if not replacement_attached and wedge_rid is not None \
                    and router.health.state(wedge_rid) == DEAD:
                replacement_attached = True
                replicas[REPLACEMENT_RID] = spare
                router.attach(spare)
            for rid, rep in replicas.items():
                if router.health.state(rid) == DEAD:
                    continue
                if rid == kill_rid and ticks >= KILL_TICK:
                    continue
                if rid == wedge_rid and ticks >= WEDGE_TICK:
                    wd = rep.batcher.watchdog
                    wd.timeout_s = WEDGE_TIMEOUT_S  # armed at the wedge
                    with wd.guard("decode", 0):
                        time.sleep(wd.timeout_s + 0.05)
                    rep.publish()
                    continue
                counted_step(rid, rep)
            if sess2_submitted and replacement_attached and router.idle \
                    and all(r.done for r in reqs.values()):
                break
        router.publish(generation=0)
        if sess2_submitted and reqs[plan.session2[0]].replicas_tried:
            affinity["second"] = reqs[plan.session2[0]].replicas_tried[-1]
        report = FleetAggregator(fdir).collect()
        router_summary = report.summary().get("router", {}) if report \
            else {}
        events = obs.read_events(run_dir)
    finally:
        obs.disable()

    # flush every tracer, then join the span files as a post-mortem
    # would: by trace id from the shared fleet dir
    router.tracer.close()
    for rep in list(replicas.values()) + [spare]:
        if rep.tracer is not None:
            rep.tracer.close()
    if inject_orphan_span:
        with open(os.path.join(fdir, "router", "spans-g0.jsonl"),
                  "a") as f:
            f.write(json.dumps({"kind": "span", "trace": "ghost-999",
                                "name": "router.backlog", "t0": 0.0,
                                "t1": 1.0, "src": "router"}) + "\n")
    assembled = tracing.assemble(tracing.collect_records(fdir))
    checks = {tid: tracing.check_trace(t) for tid, t in assembled.items()}
    id_of = {k: str(r.id) for k, r in reqs.items()}
    ends = [t["end"] for t in assembled.values() if t["end"] is not None]
    traces_ev = {
        "checked": len(ends),
        # terminal requests whose trace never assembled (no end record)
        "missing": sorted(k for k, tid in id_of.items()
                          if assembled.get(tid, {}).get("end") is None),
        "problems": {tid: c["problems"] for tid, c in checks.items()
                     if assembled[tid]["end"] is not None and not c["ok"]},
        "orphans": sorted(tid for tid, t in assembled.items()
                          if t["end"] is None and t["spans"]),
        "hops": sum(int(e.get("hops") or 0) for e in ends),
        "phase_err_max": max((checks[tid]["rel_err"]
                              for tid, t in assembled.items()
                              if t["end"] is not None
                              and checks[tid]["rel_err"] is not None),
                             default=0.0),
    }

    survivors = {rid: rep for rid, rep in replicas.items()
                 if router.health.state(rid) == LIVE}
    return {
        "ticks": ticks,
        "max_ticks": max_ticks,
        "wall_s": time.perf_counter() - t_wall,
        "baseline": base,
        "kill_rid": kill_rid,
        "wedge_rid": wedge_rid,
        "replacement_attached": replacement_attached,
        "expected_deadline": [plan.expire[0]],
        "requests": {k: {"reason": r.finish_reason,
                         "output": list(r.output),
                         "redistributions": r.redistributions,
                         "replicas": list(r.replicas_tried),
                         "priority": r.priority}
                     for k, r in reqs.items()},
        "transitions": {rid: [{"to": t["to"], "cause": t["cause"]}
                              for t in rec.transitions]
                        for rid, rec in health.records.items()},
        "counters": {
            "redistributed": _counter("gen_requests_total",
                                      reason="redistributed")
            - before["redistributed"],
            "router_redistributions":
                _counter("router_redistributions_total")
                - before["router_redistributions"],
            "stuck": _counter("gen_stuck_dispatch_total") - before["stuck"],
        },
        "events": {
            "names": sorted({e["event"] for e in events
                             if e.get("event", "").startswith("replica_")}),
            "stuck_replicas": sorted(
                {e.get("replica") for e in events
                 if e.get("event") == "gen_stuck_dispatch"}),
        },
        "affinity": affinity,
        "router_state": {"backlog": router.backlog,
                         "in_flight": router.in_flight},
        "drained": {rid: {"active": rep.batcher.active,
                          "pending": rep.batcher.pending,
                          "free_pages": rep.engine.free_pages,
                          "num_pages": rep.engine.num_pages,
                          "reserved": rep.engine.reserved_pages}
                    for rid, rep in survivors.items()},
        "router_summary": router_summary,
        "traces": traces_ev,
        "fleet_dir": fdir,
        # what the JAX drill's evidence has not: each replica's kernel
        # launches (when counted) and its engine's programs
        "port": {"launches": launches,
                 "compiled_programs": {
                     rid: rep.engine.compiled_programs
                     for rid, rep in replicas.items()}},
    }


def validate_fleet(result) -> List[str]:
    """Judge a fleet-drill result; returns violations (empty = OK)."""
    problems = []
    if result["ticks"] >= result["max_ticks"]:
        problems.append(f"fleet drill did not settle within "
                        f"{result['max_ticks']} ticks (possible hang)")
    base = result["baseline"]
    expected_deadline = set(result["expected_deadline"])
    for key, rec in result["requests"].items():
        reason, out = rec["reason"], rec["output"]
        if reason is None:
            problems.append(f"request {key} never terminated "
                            "(dropped in-deadline work)")
            continue
        want = base.get(key, [])
        if key in expected_deadline:
            if reason != "deadline":
                problems.append(f"request {key}: expected the hopeless "
                                f"deadline to expire, got {reason!r}")
            elif out != want[:len(out)]:
                problems.append(f"request {key}: expired tokens are not a "
                                "prefix of the baseline (corruption)")
            continue
        if reason not in ("eos", "length"):
            # every in-deadline request must be SERVED: a deadline or shed
            # here is a dropped request
            problems.append(f"in-deadline request {key} finished "
                            f"{reason!r} instead of being served")
        elif out != want:
            problems.append(f"request {key}: tokens diverge from the "
                            "undisturbed baseline (corruption across "
                            "redistribution)")
    if result["kill_rid"] is None or result["wedge_rid"] is None:
        problems.append("drill never selected a kill/wedge replica")
        return problems
    tr = result["transitions"]
    wedged = [t["to"] for t in tr.get(result["wedge_rid"], [])]
    if wedged != ["degraded", "draining", "dead"]:
        problems.append(f"wedged replica walked {wedged}, expected "
                        "['degraded', 'draining', 'dead']")
    wcauses = [t["cause"] for t in tr.get(result["wedge_rid"], [])]
    if not wcauses or wcauses[0] != "stuck_dispatch":
        problems.append(f"wedged replica degraded for {wcauses[:1]}, "
                        "expected 'stuck_dispatch'")
    killed = tr.get(result["kill_rid"], [])
    if not killed or killed[-1]["to"] != "dead":
        problems.append(f"killed replica never reached DEAD: {killed}")
    elif killed[0]["cause"] != "heartbeat":
        problems.append(f"killed replica degraded for "
                        f"{killed[0]['cause']!r}, expected 'heartbeat'")
    if not result["replacement_attached"]:
        problems.append("replacement replica never joined the fleet")
    c = result["counters"]
    for name in ("redistributed", "router_redistributions", "stuck"):
        if c[name] < 1:
            problems.append(f"expected counter {name} >= 1, got {c[name]}")
    ev = set(result["events"]["names"])
    for name in ("replica_degraded", "replica_drain", "replica_dead"):
        if name not in ev:
            problems.append(f"event {name} missing from telemetry: "
                            f"{sorted(ev)}")
    if result["wedge_rid"] not in result["events"]["stuck_replicas"]:
        problems.append("gen_stuck_dispatch events do not attribute the "
                        f"wedged replica {result['wedge_rid']}: "
                        f"{result['events']['stuck_replicas']}")
    aff = result["affinity"]
    if aff.get("first") is not None and aff.get("first_state") == "live" \
            and aff.get("second") != aff["first"]:
        problems.append(f"session affinity broken: first turn on replica "
                        f"{aff['first']} (still LIVE), second landed on "
                        f"{aff.get('second')}")
    rs = result["router_state"]
    if rs["backlog"] or rs["in_flight"]:
        problems.append(f"router not idle: backlog={rs['backlog']} "
                        f"in_flight={rs['in_flight']}")
    if not result["drained"]:
        problems.append("no surviving LIVE replica at the end")
    for rid, d in result["drained"].items():
        if d["active"] or d["pending"]:
            problems.append(f"replica {rid} not drained: "
                            f"active={d['active']} pending={d['pending']}")
        if d["free_pages"] != d["num_pages"]:
            problems.append(f"replica {rid} page leak: "
                            f"{d['free_pages']}/{d['num_pages']} free")
        if d["reserved"]:
            problems.append(f"replica {rid} reservation leaked: "
                            f"{d['reserved']} pages")
    tre = result.get("traces") or {}
    if tre:
        # every terminal request must carry a complete, gap-free trace
        # whose router-level phase sums reconcile against its e2e latency
        if tre["missing"]:
            problems.append("requests with no assembled trace end record: "
                            f"{tre['missing']}")
        for tid, probs in sorted(tre["problems"].items()):
            problems.append(f"trace {tid} failed reconciliation: {probs}")
        if tre["orphans"]:
            problems.append(f"orphaned spans with no owning request: "
                            f"{tre['orphans']}")
        if tre["phase_err_max"] > 0.05:
            problems.append(f"worst trace phase-sum error "
                            f"{tre['phase_err_max']:.1%} exceeds 5%")
        if tre["hops"] != int(c["router_redistributions"]):
            problems.append(
                f"trace hop count {tre['hops']} does not match "
                f"router_redistributions_total "
                f"{c['router_redistributions']:.0f}")
    rsum = result["router_summary"].get("replicas", {})
    for rid in (result["kill_rid"], result["wedge_rid"]):
        if rsum.get(str(rid), {}).get("state") != "dead":
            problems.append(f"fleet report does not show replica {rid} "
                            f"dead: {rsum.get(str(rid))}")
    if not any(rec.get("state") == "live" for rec in rsum.values()):
        problems.append(f"fleet report shows no live replica: {rsum}")
    return problems


def report_fleet(result, problems) -> int:
    """Print a fleet drill's summary and verdict; returns the exit code."""
    c = result["counters"]
    print(f"fleetdrill: {len(result['requests'])} requests, "
          f"{result['ticks']} ticks, {result['wall_s']:.1f}s wall")
    print(f"  killed={result['kill_rid']} wedged={result['wedge_rid']} "
          f"replacement={'yes' if result['replacement_attached'] else 'NO'}")
    print("  transitions: " + "; ".join(
        f"r{rid}:" + "->".join(t['to'] for t in trs)
        for rid, trs in sorted(result["transitions"].items()) if trs))
    print(f"  redistributed={c['redistributed']:.0f} "
          f"(router pull-backs={c['router_redistributions']:.0f}) "
          f"stuck={c['stuck']:.0f}")
    reasons = sorted({v['reason'] or 'NONE'
                      for v in result['requests'].values()})
    print(f"  reasons: {', '.join(reasons)}")
    tre = result.get("traces") or {}
    if tre:
        print(f"  traces: checked={tre['checked']} "
              f"missing={len(tre['missing'])} "
              f"broken={len(tre['problems'])} orphans={len(tre['orphans'])} "
              f"hops={tre['hops']} "
              f"phase_err_max={tre['phase_err_max']:.2%} "
              f"(waterfalls: tools/torch_tracereport.py "
              f"{result['fleet_dir']})")
    print(f"  drained: {result['drained']}")
    if problems:
        for p in problems:
            print(f"fleetdrill: FAIL: {p}")
        return 1
    print("fleetdrill: OK — zero in-deadline drops, wedged replica "
          "degraded->drained->dead with work redistributed, gap-free "
          "traces reconciled, survivors drained clean")
    return 0


def main_fleet(args) -> int:
    if args.full:
        from mxnet_tpu_torch.models import get_gpt2

        net = get_gpt2("gpt2_345m", dropout=0.0, device=args.device, seed=0)
        plan, max_ticks = fleet_plan(), max(args.max_ticks, 400)
    else:
        net, plan, max_ticks = tiny_net(device=args.device), \
            tiny_fleet_plan(), args.max_ticks
    result = run_fleet_drill(net, plan, device=args.device,
                             max_ticks=max_ticks,
                             inject_orphan_span=args.inject_orphan_span)
    if args.inject_drop:
        key = next(iter(result["requests"]))
        result["requests"][key]["reason"] = None
    return report_fleet(result, validate_fleet(result))


def tiny_net(seed=0, device="cuda"):
    """The tiny plan's target: a seeded 2-layer GPT-2 (units 64, 4 heads,
    vocab 61, max_length 64), dropout 0."""
    from mxnet_tpu_torch.models.gpt2 import GPT2Model

    return GPT2Model(num_layers=2, units=64, num_heads=4, max_length=64,
                     vocab_size=61, dropout=0.0, device=device, seed=seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, where every kernel "
                    "takes its plain PyTorch version")
    ap.add_argument("--max-steps", type=int, default=250)
    ap.add_argument("--inject-leak", action="store_true",
                    help="failure-path test hook: corrupt the drained-state "
                    "evidence; the gate must fail")
    ap.add_argument("--fleet", action="store_true",
                    help="run the multi-replica fleet drill instead of the "
                    "single-engine one")
    ap.add_argument("--full", action="store_true",
                    help="(--fleet) gpt2_345m at the serve engine's width "
                    "(fleet_plan) instead of the tiny plan")
    ap.add_argument("--max-ticks", type=int, default=60,
                    help="fleet drill tick budget (1 tick = 1 fake second)")
    ap.add_argument("--inject-drop", action="store_true",
                    help="failure-path test hook (--fleet): erase one "
                    "request's finish reason; the gate must fail")
    ap.add_argument("--inject-orphan-span", action="store_true",
                    help="failure-path test hook (--fleet): append a span "
                    "owned by no request to the router span file; the "
                    "trace gate must fail")
    args = ap.parse_args(argv)
    if args.fleet:
        return main_fleet(args)

    result = run_drill(tiny_net(device=args.device),
                       AdversarialDraft(61, 64, device=args.device),
                       device=args.device, max_steps=args.max_steps)
    if args.inject_leak:
        result["drained"]["free_pages"] -= 1
    problems = validate(result)

    c = result["counters"]
    print(f"servedrill: {len(result['requests'])} requests, "
          f"{result['steps']} steps, {result['wall_s']:.1f}s wall "
          f"({args.device})")
    print("  reasons: " + ", ".join(sorted(
        {v["reason"] or "NONE" for v in result["requests"].values()})))
    print(f"  deadline(queue/slot)={c['deadline_q']:.0f}/"
          f"{c['deadline_s']:.0f} cancelled={c['cancelled']:.0f} "
          f"shed={c['shed']:.0f} {result['port']['shed_causes']}")
    print(f"  spec fallbacks={c['fallbacks']:.0f} rearms={c['rearms']:.0f} "
          f"stuck={c['stuck']:.0f}")
    print("  retry failures absorbed: " + ", ".join(
        f"{s}={n:.0f}" for s, n in sorted(c["retry_fail"].items())))
    print(f"  drained: {result['drained']}")
    if problems:
        for p in problems:
            print(f"servedrill: FAIL: {p}")
        return 1
    print("servedrill: OK — explicit finish reasons, bit-identical "
          "survivors, fallback+re-arm observed, clean drain")
    return 0


if __name__ == "__main__":
    sys.exit(main())

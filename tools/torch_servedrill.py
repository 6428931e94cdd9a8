#!/usr/bin/env python3
"""Chaos drill for the port's serving path: the counterpart of
``tools/servedrill.py``'s single-replica drill.

    python3 tools/torch_servedrill.py [--device cuda|cpu] [--max-steps N]
                                      [--inject-leak]

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
"""
from __future__ import annotations

import argparse
import dataclasses
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
    args = ap.parse_args(argv)

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

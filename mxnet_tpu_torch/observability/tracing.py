"""End-to-end request tracing + SLO attainment ledger: a copy of
``mxnet_tpu/observability/tracing.py`` (which imports nothing of JAX), so
that a span file written by either package reads record for record in the
other's :func:`collect_records`.

One *trace* is the life of one router request, identified by the
router's request id. Each process that touches the request emits
*spans* — named ``[t0, t1]`` intervals on its own clock — into a
per-process append-only JSONL file inside the shared fleet directory
(the same transport contract as every other fleet artifact: per-replica
files under ``telemetry-h{rid}/``, router files under ``router/``,
readers skip torn lines). Traces join **by trace id at aggregation**,
never via shared memory, so the in-process drill and a real
multi-process fleet read identically.

Span vocabulary:

  ``router.backlog``   waiting in the router for a replica (one per
                       residency — a redistributed request gets another)
  ``router.place``     zero-width placement marker (replica, attempt #)
  ``router.attempt``   placed on a replica until harvested / pulled back
  ``redistribution``   zero-width pull-back marker (cause, hop #)
  ``replica.queue``    waiting in the batcher's admission queue
  ``prefill``          admission dispatch -> first sampled token
  ``decode``           first token -> local finish (child ``decode.round``
                       spans per dispatch, speculation rounds labelled
                       with accept counts)

The router-level spans **telescope**: every boundary (submit, place,
pull-back, finish) closes one span and opens the next at the same
timestamp, so ``sum(router.backlog) + sum(router.attempt)`` equals the
end-to-end latency *exactly, on any clock* — including the drills' fake
clocks where a dispatch takes zero fake seconds. That is also what makes
a trace spanning a **killed** replica gap-free: the router's attempt
span covers the dead replica's residency even when that replica's own
span file never got flushed. Replica-side spans are *detail* nested
inside an attempt; they share the router's timebase only when the
processes share a clock (true in drills; in production they attribute
durations, not absolute alignment).

Tail-based sampling: the keep/drop decision happens at trace *end*,
when the outcome is known. Always kept: anomalous outcomes (deadline /
shed / cancelled / page_exhausted / cache_full, or any redistribution),
traces whose deadline margin dips below ``trace_margin_floor``, and the
slowest ``trace_slow_pct`` percentile (bounded reservoir of recent
durations). The healthy rest is sampled at ``trace_sample`` by a
**deterministic hash** of (seed, trace id) — router and replicas agree
on the healthy subset without coordinating. SLO "end" verdict records
are written for **every** terminal request regardless of the sampling
decision (one line each — the ledger must measure the population, not
the sample); sampling governs only whether the buffered spans flush.

The SLO ledger folds the end records into per-priority-class
deadline-margin distributions, an attainment fraction, and multi-window
burn rates (``burn = (1 - attainment_in_window) / (1 - slo_target)``;
burn > 1 means the class is spending error budget faster than it
accrues). ``FleetAggregator`` carries it into ``FleetReport``;
``tools/torch_fleetreport.py`` and ``tools/torch_tracereport.py`` render it.

Hot-path cost when tracing is off: every emission site reads one
attribute (``tracer is None``), the same one-read gate contract as
:func:`mxnet_tpu_torch.observability.enabled`. Spans are taken on the
host around a dispatch, never inside a captured step graph.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from . import metrics as _metrics

__all__ = ["Tracer", "TailSampler", "maybe_tracer", "read_span_records",
           "collect_records", "assemble", "check_trace", "trace_phases",
           "slo_ledger", "ANOMALY_OUTCOMES", "SERVED_OUTCOMES",
           "ROUTER_LEVEL_SPANS"]

#: outcomes the tail sampler always keeps — each one is a request the
#: operator may need to explain
ANOMALY_OUTCOMES = frozenset({"deadline", "shed", "cancelled",
                              "page_exhausted", "cache_full",
                              "redistributed"})

#: outcomes that count as *served* for SLO attainment (together with a
#: non-negative deadline margin)
SERVED_OUTCOMES = frozenset({"eos", "length"})

#: outcomes excluded from the SLO denominator: the client abandoned the
#: work, the fleet did not fail it
SLO_EXEMPT_OUTCOMES = frozenset({"cancelled"})

#: the telescoping span names whose durations must sum to the
#: end-to-end latency (everything else is nested detail)
ROUTER_LEVEL_SPANS = ("router.backlog", "router.attempt")

_HASH_DENOM = float(1 << 64)


def _hash_unit(seed: int, trace_id: str) -> float:
    """Deterministic uniform-[0,1) from (seed, trace id) — stable across
    processes and runs, so every tracer in the fleet makes the same
    healthy-sampling call for the same trace."""
    h = hashlib.blake2b(f"{seed}:{trace_id}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / _HASH_DENOM


class TailSampler:
    """Keep/drop decision at trace end (see module docstring).

    ``decide`` returns ``(keep, reason)``; reasons are
    ``outcome:<reason>`` / ``redistributed`` / ``margin`` / ``slow`` /
    ``sampled`` / ``dropped``. The slow-percentile rule compares against
    a bounded reservoir of the last ``history`` end-to-end durations and
    stays silent until ``min_history`` of them exist (a cold reservoir
    would flag everything)."""

    def __init__(self, sample: Optional[float] = None,
                 seed: Optional[int] = None,
                 slow_pct: Optional[float] = None,
                 margin_floor: Optional[float] = None,
                 history: int = 256, min_history: int = 16):
        from .. import config

        self.sample = float(sample if sample is not None
                            else config.get("trace_sample"))
        self.seed = int(seed if seed is not None
                        else config.get("trace_seed"))
        self.slow_pct = float(slow_pct if slow_pct is not None
                              else config.get("trace_slow_pct"))
        self.margin_floor = float(margin_floor if margin_floor is not None
                                  else config.get("trace_margin_floor"))
        if not 0.0 <= self.sample <= 1.0:
            raise ValueError("trace_sample must be in [0, 1]")
        if not 0.0 < self.slow_pct <= 100.0:
            raise ValueError("trace_slow_pct must be in (0, 100]")
        self.min_history = int(min_history)
        self._recent: deque = deque(maxlen=int(history))

    def _slow_threshold(self) -> Optional[float]:
        if len(self._recent) < self.min_history:
            return None
        vals = sorted(self._recent)
        idx = max(0, -(-len(vals) * int(self.slow_pct) // 100) - 1)
        return vals[idx]

    def decide(self, trace_id: str, outcome: str,  # lint: disable=JH001,JH002 -- host floats and branches, no tensor
               e2e: Optional[float] = None,
               margin: Optional[float] = None,
               redistributed: bool = False) -> Tuple[bool, str]:
        if outcome in ANOMALY_OUTCOMES:
            return True, f"outcome:{outcome}"
        if redistributed:
            return True, "redistributed"
        if (margin is not None and self.margin_floor > 0
                and margin < self.margin_floor):
            return True, "margin"
        thresh = self._slow_threshold() if e2e is not None else None
        if e2e is not None:
            self._recent.append(float(e2e))
        if thresh is not None and e2e >= thresh:
            return True, "slow"
        if self.sample >= 1.0 \
                or _hash_unit(self.seed, trace_id) < self.sample:
            return True, "sampled"
        return False, "dropped"


class Tracer:
    """Buffer spans per trace; flush (or drop) them when the trace ends
    locally. One Tracer per emitting process-role:

      - the router's (``owner=True``) writes the authoritative ``end``
        verdict record the SLO ledger folds;
      - a replica's (``owner=False``) writes ``local_end`` records —
        flush bookkeeping and debugging detail, never ledger material
        (a request touching two replicas must not count twice).

    ``capture_cb(trace_id, margin)`` fires when a finishing trace's
    deadline margin dips below the sampler's ``margin_floor`` — the
    serving replica hooks the ``prof-request`` capture trigger there.

    All writes are best-effort append-JSONL (a torn final line is the
    crash signature; every reader skips it). Never raises into the
    serving loop."""

    def __init__(self, path: str, source: str,
                 sampler: Optional[TailSampler] = None,
                 clock=None, owner: bool = False, capture_cb=None):
        self.path = os.path.abspath(path)
        self.source = str(source)
        self.sampler = sampler or TailSampler()
        self.owner = bool(owner)
        self.capture_cb = capture_cb
        self._clock = clock or time.time
        self._buf: Dict[str, List[dict]] = {}
        self._lock = threading.Lock()
        self._fh = None
        self.kept = 0
        self.dropped = 0

    # -- emission (hot path when tracing is ON) ------------------------------
    def span(self, trace_id: str, name: str, t0: float, t1: float,  # lint: disable=JH001,JH002 -- host floats and branches, no tensor
             **attrs) -> None:
        rec = {"kind": "span", "trace": str(trace_id), "name": name,
               "t0": round(float(t0), 6), "t1": round(float(t1), 6),
               "src": self.source}
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._buf.setdefault(rec["trace"], []).append(rec)

    def finish(self, trace_id: str, outcome: str, t0: float, t1: float,  # lint: disable=JH001,JH002 -- host floats and branches, no tensor
               cls: Optional[str] = None, deadline: Optional[float] = None,
               hops: int = 0, **attrs) -> bool:
        """Close a trace locally: run the tail sampler, flush or drop the
        buffered spans, and append the verdict record (``end`` for the
        owner, ``local_end`` otherwise). Returns the keep decision."""
        tid = str(trace_id)
        e2e = max(0.0, float(t1) - float(t0))
        margin = None if deadline is None else float(deadline) - float(t1)
        keep, why = self.sampler.decide(tid, outcome, e2e=e2e,
                                        margin=margin,
                                        redistributed=hops > 0)
        rec = {"kind": "end" if self.owner else "local_end", "trace": tid,
               "outcome": outcome, "cls": cls,
               "t0": round(float(t0), 6), "t1": round(float(t1), 6),
               "e2e": round(e2e, 6),
               "deadline": None if deadline is None
               else round(float(deadline), 6),
               "margin": None if margin is None else round(margin, 6),
               "hops": int(hops), "keep": keep, "why": why,
               "src": self.source}
        if attrs:
            rec.update(attrs)
        with self._lock:
            spans = self._buf.pop(tid, [])
            if keep:
                self.kept += 1
                self._write(spans + [rec])
            else:
                self.dropped += 1
                self._write([rec])
        _metrics.REGISTRY.counter(
            "trace_traces_total",
            "locally ended traces, by tail-sampling decision").inc(
                decision="kept" if keep else "dropped")
        if (self.capture_cb is not None and margin is not None
                and self.sampler.margin_floor > 0
                and margin < self.sampler.margin_floor):
            try:
                self.capture_cb(tid, margin)
            except Exception:  # advisory: never fail the serving loop
                pass
        return keep

    def discard(self, trace_id: str) -> None:
        """Drop a trace's buffered spans without any verdict record
        (e.g. a handle the client threw away before terminal state)."""
        with self._lock:
            self._buf.pop(str(trace_id), None)

    # -- IO ------------------------------------------------------------------
    def _write(self, records: List[dict]) -> None:
        """Append records as JSONL in one write + flush (caller holds the
        lock). A crash mid-write leaves at most one torn final line —
        exactly what every fleet-dir reader already tolerates."""
        if not records:
            return
        try:
            if self._fh is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write("".join(json.dumps(r, sort_keys=True) + "\n"
                                   for r in records))
            self._fh.flush()
        except (OSError, ValueError):
            pass  # telemetry must never fail serving

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def maybe_tracer(path: str, source: str, owner: bool = False,
                 clock=None, capture_cb=None) -> Optional[Tracer]:
    """The config-gated constructor the serving tier calls: None unless
    the ``trace`` knob (``MXNET_TPU_TRACE``) is on — so a disabled fleet
    pays exactly one ``tracer is None`` read per emission site."""
    from .. import config

    if not config.get("trace"):
        return None
    return Tracer(path, source, sampler=TailSampler(), clock=clock,
                  owner=owner, capture_cb=capture_cb)


# -- reading / assembly (aggregation side, never hot) ------------------------

def read_span_records(path: str) -> List[dict]:
    """Parse one span JSONL file, skipping torn/garbage lines (the
    crash-mid-write signature) like every other fleet-dir reader."""
    out: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn line: skip, keep reading
                if isinstance(rec, dict) and "trace" in rec:
                    out.append(rec)
    except OSError:
        pass
    return out


def collect_records(fleet_dir: str) -> List[dict]:
    """Every span/end record in a fleet dir: the router's
    ``router/spans-g*.jsonl`` plus each replica's
    ``telemetry-h*/spans-g*.jsonl``."""
    fleet_dir = os.path.abspath(fleet_dir)
    paths = sorted(
        glob.glob(os.path.join(fleet_dir, "router", "spans-g*.jsonl"))
        + glob.glob(os.path.join(fleet_dir, "telemetry-h*",
                                 "spans-g*.jsonl")))
    out: List[dict] = []
    for p in paths:
        out.extend(read_span_records(p))
    return out


def assemble(records: Iterable[dict]) -> Dict[str, dict]:
    """Join records by trace id:
    ``{trace: {spans, end, local_ends}}`` with spans sorted by
    ``(t0, t1)``. A trace with spans but no owner ``end`` record is an
    *orphan* — either still in flight or (the red path the drill
    injects) a span that lost its request."""
    traces: Dict[str, dict] = {}
    for rec in records:
        t = traces.setdefault(str(rec.get("trace")),
                              {"spans": [], "end": None, "local_ends": []})
        kind = rec.get("kind")
        if kind == "span":
            t["spans"].append(rec)
        elif kind == "end":
            # two owner ends for one trace id should not happen; keep
            # the later one (restarted router re-ran the request)
            if t["end"] is None or rec.get("t1", 0) >= t["end"].get("t1", 0):
                t["end"] = rec
        elif kind == "local_end":
            t["local_ends"].append(rec)
    for t in traces.values():
        t["spans"].sort(key=lambda s: (s.get("t0", 0.0), s.get("t1", 0.0)))
    return traces


def trace_phases(trace: dict) -> Dict[str, float]:
    """Total duration per span name (seconds). Router-level names are
    the telescoping partition of the end-to-end latency; the rest is
    nested detail."""
    phases: Dict[str, float] = {}
    for s in trace["spans"]:
        d = max(0.0, float(s.get("t1", 0.0)) - float(s.get("t0", 0.0)))
        phases[s["name"]] = phases.get(s["name"], 0.0) + d
    return phases


def check_trace(trace: dict, tol: float = 0.05,
                abs_tol: float = 1e-6) -> dict:
    """Reconcile one assembled trace against its ``end`` record.

    Checks (each failed check appends to ``problems``):

      - an ``end`` record exists (otherwise the trace is an orphan);
      - the router-level spans cover ``[submit, finish]`` contiguously —
        first starts at submit, each next starts where the previous
        ended, last ends at finish (gap/overlap > ``abs_tol`` flags);
      - their durations sum to the end-to-end latency within ``tol``
        (relative) — the acceptance gate's 5%.

    Returns ``{ok, problems, e2e, phase_sum, rel_err, phases, hops}``."""
    problems: List[str] = []
    end = trace.get("end")
    phases = trace_phases(trace)
    levels = [s for s in trace["spans"] if s["name"] in ROUTER_LEVEL_SPANS]
    hops = sum(1 for s in trace["spans"] if s["name"] == "redistribution")
    if end is None:
        return {"ok": False, "problems": ["orphan: no end record"],
                "e2e": None, "phase_sum": None, "rel_err": None,
                "phases": phases, "hops": hops}
    e2e = float(end.get("e2e") or 0.0)
    phase_sum = sum(max(0.0, float(s["t1"]) - float(s["t0"]))
                    for s in levels)
    if not levels:
        problems.append("no router-level spans")
    else:
        if abs(float(levels[0]["t0"]) - float(end["t0"])) > abs_tol:
            problems.append(
                f"first span starts {levels[0]['t0']} != submit {end['t0']}")
        if abs(float(levels[-1]["t1"]) - float(end["t1"])) > abs_tol:
            problems.append(
                f"last span ends {levels[-1]['t1']} != finish {end['t1']}")
        for a, b in zip(levels, levels[1:]):
            if abs(float(b["t0"]) - float(a["t1"])) > abs_tol:
                problems.append(
                    f"gap/overlap between {a['name']}@{a['t1']} and "
                    f"{b['name']}@{b['t0']}")
    rel_err = 0.0
    if e2e > abs_tol:
        rel_err = abs(phase_sum - e2e) / e2e
    elif abs(phase_sum - e2e) > abs_tol:
        rel_err = 1.0
    if rel_err > tol:
        problems.append(f"phase sum {phase_sum:.6f}s vs e2e {e2e:.6f}s "
                        f"({rel_err:.1%} > {tol:.0%})")
    if int(end.get("hops") or 0) != hops:
        problems.append(f"end record claims {end.get('hops')} hops, "
                        f"{hops} redistribution spans present")
    return {"ok": not problems, "problems": problems, "e2e": e2e,
            "phase_sum": phase_sum, "rel_err": rel_err, "phases": phases,
            "hops": hops}


# -- SLO ledger ---------------------------------------------------------------

def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, -(-len(sorted_vals) * int(q * 100) // 100) - 1))
    return sorted_vals[idx]


def parse_windows(spec: Optional[str] = None) -> List[float]:
    """``trace_slo_windows`` knob -> window seconds (bad entries
    skipped; empty spec falls back to the config default)."""
    from .. import config

    if spec is None:
        spec = config.get("trace_slo_windows")
    out: List[float] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            continue
        if w > 0:
            out.append(w)
    return out


def slo_ledger(ends: Iterable[dict], windows: Optional[List[float]] = None,
               target: Optional[float] = None,
               now: Optional[float] = None) -> dict:
    """Fold owner ``end`` records into the SLO ledger (see module
    docstring). ``now`` anchors the burn-rate windows; it defaults to
    the newest finish timestamp in the records (the aggregator is
    usually looking at a finished run, not wall-clock now).

    Per class: ``count`` (terminal requests), ``eligible`` (minus
    client cancellations), ``attained``, ``attainment``, ``margin``
    percentiles over deadline-carrying requests, ``burn`` per window,
    plus outcome and hop tallies."""
    from .. import config

    ends = [e for e in ends if e.get("kind") == "end"]
    if target is None:
        target = float(config.get("trace_slo_target"))
    if windows is None:
        windows = parse_windows()
    if now is None:
        now = max((float(e.get("t1") or 0.0) for e in ends), default=0.0)
    budget = max(1e-9, 1.0 - target)

    def attained(e) -> bool:
        m = e.get("margin")
        return (e.get("outcome") in SERVED_OUTCOMES
                and (m is None or float(m) >= 0.0))

    classes: Dict[str, List[dict]] = {}
    for e in ends:
        classes.setdefault(str(e.get("cls") or "default"), []).append(e)

    def fold(records: List[dict]) -> dict:
        eligible = [e for e in records
                    if e.get("outcome") not in SLO_EXEMPT_OUTCOMES]
        ok = sum(1 for e in eligible if attained(e))
        margins = sorted(float(e["margin"]) for e in eligible
                         if e.get("margin") is not None)
        outcomes: Dict[str, int] = {}
        for e in records:
            o = str(e.get("outcome"))
            outcomes[o] = outcomes.get(o, 0) + 1
        burn: Dict[str, Optional[float]] = {}
        for w in windows:
            inw = [e for e in eligible
                   if float(e.get("t1") or 0.0) >= now - w]
            if not inw:
                burn[f"{w:g}s"] = None
                continue
            bad = sum(1 for e in inw if not attained(e))
            burn[f"{w:g}s"] = round((bad / len(inw)) / budget, 4)
        return {
            "count": len(records), "eligible": len(eligible),
            "attained": ok,
            "attainment": round(ok / len(eligible), 4) if eligible else None,
            "margin": {"min": margins[0] if margins else None,
                       "p50": _pct(margins, 0.50),
                       "p95": _pct(margins, 0.95)},
            "redistributed": sum(1 for e in records
                                 if int(e.get("hops") or 0) > 0),
            "outcomes": outcomes, "burn": burn,
        }

    return {
        "target": target, "windows": [f"{w:g}s" for w in windows],
        "now": round(float(now), 6),
        "classes": {c: fold(rs) for c, rs in sorted(classes.items())},
        "total": fold(ends),
    } if ends else {}

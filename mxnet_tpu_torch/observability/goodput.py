"""Goodput accounting: a copy of the goodput half of
``mxnet_tpu/observability/goodput.py``.

The **goodput ledger** classifies every interval of a run's wall clock
into a small, exhaustive taxonomy (productive training, checkpoint save,
restore, re-formation downtime, data stall, idle) from the events the
subsystems already emit. The ledger is a boundary sweep over the
classified intervals, so the buckets partition wall time exactly:
``sum(buckets) == wall`` by construction, and ``goodput = train / wall``.

:class:`FlopsEstimate` is the result type of the FLOPs model. The model
itself (``op_flops`` / ``program_flops``, which price the dot-like ops of
an audited program) needs the program auditor of ``analysis/*``, which the
port does not have yet; it arrives with it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FlopsEstimate", "GoodputReport", "classify_events",
           "goodput_ledger", "GOODPUT_CATEGORIES"]


@dataclasses.dataclass
class FlopsEstimate:
    """Analytic FLOPs of one program's dot census."""

    total: float = 0.0
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_dots: int = 0
    n_approx: int = 0  # dots priced via the sqrt fallback
    n_unpriced: int = 0  # dot-like ops with no priceable structure at all

    def summary(self) -> dict:
        return {"total": self.total, "by_op": dict(self.by_op),
                "n_dots": self.n_dots, "n_approx": self.n_approx,
                "n_unpriced": self.n_unpriced}


# -- goodput ledger ----------------------------------------------------------
#: interval taxonomy, highest classification priority first — when two
#: classified intervals overlap, the earlier category wins the overlap
#: (the most *specific* classification first: a checkpoint restore inside
#: the re-formation gap is restore time, the rest of the gap downtime)
GOODPUT_CATEGORIES = ("restore", "checkpoint", "reformation", "data_stall",
                      "train", "idle")

# event name -> (category, duration payload field); the interval is
# [ts - duration, ts] (every emitter stamps ts at the END of the region)
_EVENT_INTERVALS = {
    "train_step": ("train", "step_seconds"),
    "train_window": ("train", "window_seconds"),
    "checkpoint_save": ("checkpoint", "seconds"),
    "checkpoint_restore": ("restore", "seconds"),
    "elastic_restore": ("restore", "seconds"),
}


@dataclasses.dataclass
class GoodputReport:
    """Wall-clock partition of one run (buckets sum to ``wall`` exactly)."""

    wall_start: float
    wall_end: float
    buckets: Dict[str, float]
    n_intervals: int = 0

    @property
    def wall(self) -> float:
        return self.wall_end - self.wall_start

    @property
    def goodput(self) -> float:
        """Fraction of wall time spent in productive training steps."""
        return (self.buckets.get("train", 0.0) / self.wall) if self.wall > 0 \
            else 0.0

    def summary(self) -> dict:
        return {"wall_seconds": round(self.wall, 6),
                "goodput": round(self.goodput, 6),
                "buckets": {k: round(v, 6)
                            for k, v in sorted(self.buckets.items())},
                "n_intervals": self.n_intervals}


def classify_events(events: Sequence[dict],
                    generation_key: str = "_gen"
                    ) -> List[Tuple[str, float, float]]:
    """Turn an event stream into classified ``(category, start, end)``
    intervals. Re-formation downtime is the fleet-level gap between the
    last event of generation g and the first event of generation g+1
    (events tagged by the aggregator with ``generation_key``)."""
    out: List[Tuple[str, float, float]] = []
    gen_span: Dict[int, Tuple[float, float]] = {}
    for e in events:
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        g = e.get(generation_key)
        if isinstance(g, int):
            lo, hi = gen_span.get(g, (ts, ts))
            gen_span[g] = (min(lo, ts), max(hi, ts))
        kind = _EVENT_INTERVALS.get(e.get("event"))
        if kind is not None:
            cat, field = kind
            dur = e.get(field)
            if isinstance(dur, (int, float)) and dur > 0:
                out.append((cat, ts - dur, ts))
            continue
        if e.get("event") == "data_stall":
            dur = e.get("wait_seconds")
            if isinstance(dur, (int, float)) and dur > 0:
                out.append(("data_stall", ts - dur, ts))
    gens = sorted(gen_span)
    for a, b in zip(gens, gens[1:]):
        end_prev, start_next = gen_span[a][1], gen_span[b][0]
        if start_next > end_prev:
            out.append(("reformation", end_prev, start_next))
    return out


def goodput_ledger(events: Sequence[dict],
                   generation_key: str = "_gen") -> Optional[GoodputReport]:
    """Build the wall-clock ledger for one (merged) event stream: a
    boundary sweep over the classified intervals, residual time = idle.
    Returns None when the stream holds no usable timestamps."""
    ts_all = [e["ts"] for e in events
              if isinstance(e.get("ts"), (int, float))]
    if not ts_all:
        return None
    intervals = classify_events(events, generation_key=generation_key)
    wall_start = min(ts_all + [s for _c, s, _e in intervals])
    wall_end = max(ts_all + [e for _c, _s, e in intervals])
    buckets = {c: 0.0 for c in GOODPUT_CATEGORIES}
    if wall_end <= wall_start:
        return GoodputReport(wall_start, wall_end, buckets, len(intervals))
    # boundary sweep with per-category active counters — every elementary
    # segment belongs to exactly one bucket (the highest-priority interval
    # covering it, else idle), so the buckets partition wall time with no
    # double counting; O(n log n), so the supervisor's poll cadence stays
    # cheap on runs with tens of thousands of step intervals
    points: List[Tuple[float, int, str]] = []
    for c, s, e in intervals:
        s = max(wall_start, min(wall_end, s))
        e = max(wall_start, min(wall_end, e))
        if e > s:
            points.append((s, 1, c))
            points.append((e, -1, c))
    points.sort(key=lambda p: p[0])
    bounds = sorted({wall_start, wall_end} | {p[0] for p in points})
    active = {c: 0 for c in GOODPUT_CATEGORIES}
    i = 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(points) and points[i][0] <= a:
            _t, d, c = points[i]
            active[c] += d
            i += 1
        best = "idle"
        for c in GOODPUT_CATEGORIES[:-1]:  # priority order, idle = residual
            if active[c] > 0:
                best = c
                break
        buckets[best] += b - a
    return GoodputReport(wall_start, wall_end, buckets, len(intervals))

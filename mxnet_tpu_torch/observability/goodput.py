"""Goodput accounting and the analytic FLOPs model: the port of
``mxnet_tpu/observability/goodput.py``.

The **goodput ledger** classifies every interval of a run's wall clock
into a small, exhaustive taxonomy (productive training, checkpoint save,
restore, re-formation downtime, data stall, idle) from the events the
subsystems already emit. The ledger is a boundary sweep over the
classified intervals, so the buckets partition wall time exactly:
``sum(buckets) == wall`` by construction, and ``goodput = train / wall``.

The **FLOPs model** prices every product of a recorded program
(:func:`~mxnet_tpu_torch.analysis.audit.audit_program`); ``TrainStep``
exports model FLOPs/step from it and, against the ``peak_flops`` knob, the
``train_mfu`` gauge. Cost convention (products only: elementwise traffic
is not model FLOPs), JAX's:

  ==========================  ===============================================
  mm, addmm, bmm, baddbmm,    2 x prod(result) x the contracted size
  mv, addmv, dot, linear,
  _int_mm, _scaled_mm
  convolution                 2 x prod(result) x in-channels a group x
                              prod(kernel window)
  convolution_backward        the forward's cost once for each gradient its
                              ``output_mask`` asks for (input, weight; the
                              bias gradient is a sum, not a product)
  custom_call                 the kernel's own ``flops``: the products of the
                              function it computes (causal flash at the full
                              T² of the plain composition), 0 for a kernel
                              without products
  ==========================  ===============================================

The JAX vocabulary (``dot_general`` / ``dot`` / ``convolution`` ops with
parsed contraction attributes, as ``mxnet_tpu.analysis.Op`` holds them) is
priced as the JAX module prices it, sqrt fallback and all: a product priced
by the fallback counts in ``FlopsEstimate.n_approx``, one with no priceable
structure in ``n_unpriced``. Every recorded aten product has its operand
shapes, so it is exact. A TrainStep window is one program of ``window``
step bodies: its FLOPs per step are the record's over ``window``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["FlopsEstimate", "op_flops", "program_flops",
           "GoodputReport", "classify_events", "goodput_ledger",
           "GOODPUT_CATEGORIES"]

_DOT_LIKE = ("dot_general", "dot", "convolution")
#: recorded aten products priced as one matrix product each
_MATMULS = frozenset({"mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot",
                      "linear", "matmul", "_int_mm", "_scaled_mm"})
_CONVS = frozenset({"convolution", "_convolution", "cudnn_convolution",
                    "convolution_backward"})


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


def _prod(shape: Sequence[int]) -> int:
    out = 1
    for d in shape:
        out *= d
    return out


def _price_jax(op) -> Tuple[Optional[float], bool]:
    """(flops, exact) of a JAX-vocabulary product, as the JAX module
    prices it; (None, False) when the op has no priceable structure."""
    if op.name not in _DOT_LIKE or len(op.shapes) < 3:
        return None, False
    lhs, rhs, result = op.shapes[0], op.shapes[-2], op.shapes[-1]
    meta = op.dot_meta
    if op.name == "convolution":
        if meta is None or meta["kernel_out_dim"] >= len(rhs):
            return None, False
        out_features = rhs[meta["kernel_out_dim"]] or 1
        return (2.0 * _prod(result) * _prod(rhs) / out_features
                / max(1, meta.get("batch_groups", 1))), True
    if meta is not None and all(d < len(lhs)
                                for d in meta["lhs_contracting"]):
        contracted = _prod([lhs[d] for d in meta["lhs_contracting"]])
        return 2.0 * _prod(result) * contracted, True
    denom = _prod(result) or 1
    return 2.0 * _prod(result) * math.sqrt(
        max(0.0, _prod(lhs) * _prod(rhs) / denom)), False


def _conv_flops(result, weight, transposed, groups) -> float:
    """2 x prod(result) x in-channels a group x prod(window) of a
    convolution with ``weight`` in PyTorch's layout."""
    cin = weight[0] // max(1, groups) if transposed else weight[1]
    return 2.0 * _prod(result) * cin * _prod(weight[2:])


def _price(op) -> Tuple[Optional[float], bool]:
    """(flops, exact) of one recorded op or JAX-vocabulary product."""
    if op.name == "custom_call":
        return (float(op.flops), True) if op.flops else (None, False)
    if not getattr(op, "n_in", 0):
        return _price_jax(op)
    shapes, n = op.shapes, op.n_in
    ins, outs = shapes[:n], shapes[n:]
    try:
        if op.name in _MATMULS:
            # the contracted size: the first product operand's last dim
            a = ins[1] if op.name in ("addmm", "baddbmm", "addmv") else ins[0]
            return 2.0 * _prod(outs[0]) * (a[-1] if a else 1), True
        if op.name in _CONVS:
            groups = int(op.attrs.get("groups", 1))
            transposed = bool(op.attrs.get("transposed", False))
            if op.name == "convolution_backward":
                grad_out, weight = ins[0], ins[2]
                fwd = _conv_flops(grad_out, weight, transposed, groups)
                mask = op.attrs.get("output_mask", (True, True, False))
                return fwd * (int(mask[0]) + int(mask[1])), True
            return _conv_flops(outs[0], ins[1], transposed, groups), True
    except (IndexError, TypeError):
        return None, False
    return None, False


def _is_priced(op) -> bool:
    if getattr(op, "attrs", None) and op.attrs.get("not_a_product"):
        return False
    if op.name == "custom_call":
        return bool(op.flops)
    if getattr(op, "n_in", 0):
        return op.name in _MATMULS or op.name in _CONVS
    return op.name in _DOT_LIKE


def op_flops(op) -> Optional[float]:
    """Analytic FLOPs of one product (a recorded aten product, a kernel
    record with products, or a JAX-vocabulary op); None for anything
    else."""
    return _price(op)[0] if _is_priced(op) else None


def program_flops(report) -> FlopsEstimate:
    """Price every product of a recorded program (its aten products and
    its kernels' own FLOPs)."""
    est = FlopsEstimate()
    for op in report.ops:
        if not _is_priced(op):
            continue
        f, exact = _price(op)
        if f is None:
            est.n_unpriced += 1
            continue
        est.n_dots += 1
        if not exact:
            est.n_approx += 1
        est.total += f
        key = op.name if op.name != "custom_call" else \
            f"custom_call:{op.kernel}"
        est.by_op[key] = est.by_op.get(key, 0.0) + f
    return est


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

"""Static schedule analysis: the port of ``mxnet_tpu/analysis/schedule.py``,
a dependency-DAG roofline over a recorded program's def/use table.

Every op of the record (:func:`~mxnet_tpu_torch.analysis.audit.
audit_program`) is a node with a **roofline** duration:

  - compute: ``max(flops / peak(dtype), bytes / hbm_bw)``. FLOPs are the
    product FLOPs of :func:`~mxnet_tpu_torch.observability.goodput.
    op_flops` (a kernel record's own); bytes the op's operands read once
    and results written once (an in-place write counted as a read and a
    write). A product is priced at its dtype's peak: bf16 and f16 at the
    tensor cores' 989 TFLOP/s, f32 at 494.7 / 3 (3xTF32: three TF32
    products for one f32-accurate one), int8 at 1,979 TOPS, f64 at 67. A
    ``sched_peak_flops`` (or, failing it, ``peak_flops``) knob prices every
    product at that one rate instead, as the JAX model does;
  - collectives: logical comm bytes (:mod:`.comm`) over
    ``DEFAULT_ICI_GBPS``, a constant until a mesh exists to read link
    speeds for; a program on one card has none;
  - views and the program's inputs are free.

Two results, as in JAX: the **critical path** (the DAG's longest path;
``critical_path_seconds = max(dag path, serial compute + exposed comm)``,
one device running its ops one after another) and the per-collective
exposed/hidden split (every collective of a record is synchronous, so
fully exposed). From those: ``overlap_fraction``, the top **serialization
points** and the static MFU bound ``flops_total / (peak x
critical_path_seconds)``, where peak is the MFU peak (``sched_peak_flops``,
else ``peak_flops``, else the bf16 tensor-core peak). ``op_class_seconds``
holds the roofline seconds per op class (``observability.profiling.
op_class``), the predicted side of ``calibrate``.

The defaults are one H100 SXM's (HBM3 at 3.35 TB/s; NVLink 4 at 450 GB/s a
direction between cards); the compute peak and HBM rate are knobs:
``MXNET_TPU_SCHED_PEAK_FLOPS`` and ``MXNET_TPU_SCHED_HBM_GBPS``. Absolute seconds are a model, not a measurement.
"""
from __future__ import annotations

import dataclasses
from collections import Counter as _Counter
from typing import Dict, List, Optional, Tuple

from .audit import COLLECTIVE_OPS, HOST_TRANSFER_OPS, VIEW_OPS, \
    ProgramReport
from .comm import comm_report

__all__ = ["CollectiveSpan", "SerializationPoint", "ScheduleReport",
           "schedule_report", "DEFAULT_PEAKS", "DEFAULT_PEAK_FLOPS",
           "DEFAULT_HBM_GBPS", "DEFAULT_ICI_GBPS"]

#: product peaks of one H100 SXM (NVIDIA's data sheet, dense) by the
#: product's dtype token; f32 products run as 3xTF32
DEFAULT_PEAKS: Dict[str, float] = {
    "bf16": 989e12, "f16": 989e12, "f32": 494.7e12 / 3, "s8": 1979e12,
    "u8": 1979e12, "f64": 67e12,
}
#: any other dtype's rate: the f32 CUDA cores
DEFAULT_OTHER_PEAK = 67e12
#: the MFU bound's denominator when no knob names one
DEFAULT_PEAK_FLOPS = 989e12
DEFAULT_HBM_GBPS = 3350.0
#: NVLink 4, one direction: what every collective is priced at
DEFAULT_ICI_GBPS = 450.0

#: a span counts as "exposed" when more than this fraction of its time
#: could not be hidden
EXPOSED_FRAC_EPS = 0.01


@dataclasses.dataclass
class CollectiveSpan:
    """One priced collective with its overlap verdict (a record's are
    synchronous: fully exposed)."""

    kind: str
    line: int
    axes: Tuple[str, ...]
    bytes: int
    seconds: float
    exposed_seconds: float
    hidden_seconds: float
    is_async: bool
    t_start: int
    t_done: int

    @property
    def axis_key(self) -> str:
        return "×".join(self.axes) if self.axes else "?"

    @property
    def is_exposed(self) -> bool:
        return self.exposed_seconds > EXPOSED_FRAC_EPS * self.seconds \
            and self.seconds > 0

    def describe(self) -> str:
        state = "sync" if not self.is_async else (
            "exposed" if self.is_exposed else "hidden")
        return (f"{self.kind}@L{self.line} [{self.axis_key}] "
                f"{self.bytes} B {self.seconds:.3e}s ({state}, "
                f"exposed {self.exposed_seconds:.3e}s)")


@dataclasses.dataclass
class SerializationPoint:
    """One zero-slack node of the dependency DAG: shrinking it shortens
    the critical path by up to ``seconds``."""

    op: str
    line: int
    seconds: float
    kind: str  # "compute" | "collective"

    def describe(self) -> str:
        return f"{self.op}@L{self.line}: {self.seconds:.3e}s ({self.kind})"


@dataclasses.dataclass
class ScheduleReport:
    """Static schedule model of one program (the JAX report's fields)."""

    dialect: str
    critical_path_seconds: float
    dag_critical_seconds: float
    compute_seconds: float
    comm_seconds: float
    exposed_comm_seconds: float
    hidden_comm_seconds: float
    flops_total: float
    hbm_bytes: float
    spans: List[CollectiveSpan]
    serialization_points: List[SerializationPoint]
    mfu_bound: float
    constants: Dict[str, float]
    n_nodes: int
    op_class_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    @property
    def overlap_fraction(self) -> float:
        """Hidden / total collective time (a comm-free program counts as
        fully hidden: nothing is exposed)."""
        if self.comm_seconds <= 0:
            return 1.0
        return self.hidden_comm_seconds / self.comm_seconds

    def by_axis(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for s in self.spans:
            d = out.setdefault(s.axis_key, {
                "seconds": 0.0, "exposed_seconds": 0.0,
                "hidden_seconds": 0.0, "bytes": 0, "exposed_bytes": 0})
            d["seconds"] += s.seconds
            d["exposed_seconds"] += s.exposed_seconds
            d["hidden_seconds"] += s.hidden_seconds
            d["bytes"] += s.bytes
            if s.seconds > 0:
                d["exposed_bytes"] += int(
                    round(s.bytes * s.exposed_seconds / s.seconds))
        return out

    def exposed_collectives(self) -> Dict[str, int]:
        return dict(_Counter(s.kind for s in self.spans if s.is_exposed))

    def exposed_spans(self) -> List[CollectiveSpan]:
        return [s for s in self.spans if s.is_exposed]

    def summary(self) -> dict:
        return {
            "dialect": self.dialect,
            "critical_path_seconds": self.critical_path_seconds,
            "dag_critical_seconds": self.dag_critical_seconds,
            "compute_seconds": self.compute_seconds,
            "comm_seconds": self.comm_seconds,
            "exposed_comm_seconds": self.exposed_comm_seconds,
            "hidden_comm_seconds": self.hidden_comm_seconds,
            "overlap_fraction": round(self.overlap_fraction, 6),
            "by_axis": self.by_axis(),
            "exposed_collectives": self.exposed_collectives(),
            "serialization_points": [
                [p.op, p.line, p.seconds, p.kind]
                for p in self.serialization_points],
            "flops_total": self.flops_total,
            "hbm_bytes": self.hbm_bytes,
            "mfu_bound": round(self.mfu_bound, 6),
            "n_nodes": self.n_nodes,
            "constants": dict(self.constants),
            "op_class_seconds": {k: v for k, v
                                 in sorted(self.op_class_seconds.items())},
        }


def _knob(name: str, default: float) -> float:
    from .. import config as _config

    try:
        v = float(_config.get(name))
    except (KeyError, TypeError, ValueError):
        return default
    return v if v > 0 else default


def _resolve_constants(peak_flops, hbm_gbps):
    """(uniform product peak or None, MFU peak, hbm in bytes/s) from
    explicit args > ``sched_*`` knobs > ``peak_flops`` > the H100's
    per-dtype defaults."""
    if peak_flops is None:
        peak_flops = _knob("sched_peak_flops", _knob("peak_flops", 0.0))
    uniform = float(peak_flops) if peak_flops and peak_flops > 0 else None
    hbm = (hbm_gbps if hbm_gbps is not None
           else _knob("sched_hbm_gbps", DEFAULT_HBM_GBPS)) * 1e9
    return uniform, uniform or DEFAULT_PEAK_FLOPS, hbm


def _op_class(op) -> str:
    from ..observability.profiling import op_class

    if op.name == "custom_call" or op.name in HOST_TRANSFER_OPS:
        return op_class(op.name)
    return op_class("aten::" + op.name)  # the record's aten ops


def schedule_report(report: ProgramReport, mesh=None, *,
                    comm=None,
                    peak_flops: Optional[float] = None,
                    hbm_gbps: Optional[float] = None,
                    top_points: int = 5) -> ScheduleReport:
    """Build the :class:`ScheduleReport` of one recorded program. ``comm``
    reuses a :class:`~.comm.CommReport` already built over the same
    report. The constants resolve explicit args > ``sched_*`` knobs >
    ``peak_flops`` > the H100 defaults."""
    from ..observability.goodput import op_flops

    uniform, mfu_peak, hbm = _resolve_constants(peak_flops, hbm_gbps)
    ici = DEFAULT_ICI_GBPS * 1e9
    if comm is None:
        comm = comm_report(report, mesh)
    cost_at = {c.line: c for c in comm.costs}
    ops = report.ops
    values = [v for v in report.values if v.param is None]
    n = len(ops)
    dur = [0.0] * n
    kind = [""] * n
    classes: Dict[str, float] = {}
    compute = flops_total = hbm_total = 0.0
    spans: List[CollectiveSpan] = []
    for t, op in enumerate(ops):
        if op.name in COLLECTIVE_OPS:
            cost = cost_at.get(op.line)
            b = cost.bytes if cost is not None else 0
            secs = b / ici
            dur[t], kind[t] = secs, "collective"
            spans.append(CollectiveSpan(
                kind=op.name, line=op.line, axes=(), bytes=b, seconds=secs,
                exposed_seconds=secs, hidden_seconds=0.0, is_async=False,
                t_start=t, t_done=t))
            if secs > 0:
                classes[op.name] = classes.get(op.name, 0.0) + secs
            continue
        if op.name in VIEW_OPS:
            continue
        f = op_flops(op) or 0.0
        peak = uniform or DEFAULT_PEAKS.get(op.dtype or "",
                                            DEFAULT_OTHER_PEAK)
        secs = max(f / peak if peak else 0.0, op.bytes / hbm if hbm else 0.0)
        dur[t], kind[t] = secs, "compute"
        compute += secs
        flops_total += f
        hbm_total += op.bytes
        if secs > 0:
            cls = _op_class(op)
            classes[cls] = classes.get(cls, 0.0) + secs
    # the dependency longest path, in program order (defs precede uses)
    def_at: Dict[str, int] = {}
    est = [0.0] * n
    finish = [0.0] * n
    consumers: Dict[int, List[int]] = {}
    for t, v in enumerate(values[:n]):
        e = 0.0
        for u in v.uses:
            p = def_at.get(u)
            if p is not None:
                e = max(e, finish[p])
                consumers.setdefault(p, []).append(t)
        est[t] = e
        finish[t] = e + dur[t]
        if v.vid:
            def_at[v.vid] = t
    dag = max(finish) if n else 0.0
    tail = [0.0] * n
    for t in range(n - 1, -1, -1):
        tail[t] = dur[t] + max((tail[c] for c in consumers.get(t, ())),
                               default=0.0)
    eps = dag * 1e-9
    points = sorted((SerializationPoint(op=ops[t].kernel or ops[t].name,
                                        line=ops[t].line, seconds=dur[t],
                                        kind=kind[t] or "compute")
                     for t in range(n)
                     if dur[t] > 0 and est[t] + tail[t] >= dag - eps),
                    key=lambda p: -p.seconds)
    comm_s = sum(s.seconds for s in spans)
    crit = max(dag, compute + comm_s)
    mfu = flops_total / (mfu_peak * crit) if mfu_peak > 0 and crit > 0 \
        else 0.0
    return ScheduleReport(
        dialect=report.dialect, critical_path_seconds=crit,
        dag_critical_seconds=dag, compute_seconds=compute,
        comm_seconds=comm_s, exposed_comm_seconds=comm_s,
        hidden_comm_seconds=0.0, flops_total=flops_total,
        hbm_bytes=hbm_total, spans=spans,
        serialization_points=points[:top_points], mfu_bound=min(1.0, mfu),
        constants={"peak_flops": uniform or 0.0, "mfu_peak_flops": mfu_peak,
                   "hbm_gbps": hbm / 1e9, "ici_gbps": DEFAULT_ICI_GBPS},
        n_nodes=n, op_class_seconds=classes)

"""Static buffer-liveness and peak-residency analysis: the port of
``mxnet_tpu/analysis/memory.py``, kept as close to it as the record's
def/use table allows.

It sweeps the :class:`~mxnet_tpu_torch.analysis.audit.ValueDef` table of a
recorded step program (:func:`~mxnet_tpu_torch.analysis.audit.
audit_program`) in program order and computes, per op, the set of live
buffers:

  - a value (the storages one op allocates) is live from its defining op
    to its last use;
  - program inputs (the real tensors the program reads: parameters,
    optimizer states, KV pools, static buffers) are pinned for the whole
    program, categorized by the input category map the audit entry points
    provide (params / opt_state / kv_pages / batch / io ...);
  - an in-place write allocates nothing, and a carry the program updates in
    place is never counted twice (the record has no donated output to
    subtract: ``donated_bytes`` are the bytes of the inputs written in
    place);
  - views are zero-cost aliases of their base's storage;
  - a kernel's own buffers (split partials: ``ValueDef.scratch``) are live
    at its row only.

The result is a :class:`MemoryReport`: estimated ``peak_bytes``, the
residency ``timeline``, ``largest_buffers(n)``, an at-peak ``by_category``
breakdown, and JAX's **materialization detectors**:

  ``kv_gather_materialize``  a gather whose result is pool-sized: the
                             paged KV cache read by materializing it
                             (the paged read kernel exists to avoid this)
  ``f32_upcast``             a large f32 copy converted from a
                             bf16-stored tensor
  ``long_lived_temp``        a big non-input buffer live across most of
                             the program

The estimate is held against the card in two parts. Its pinned inputs equal
what the real input tensors' storages hold (``ProgramReport.
input_storage_bytes``), exactly; its temporaries (``temp_peak_bytes``, the
peak less the inputs) are held against what the card measures for one eager
call of the same step function (:func:`measured_peak`: the peak of the
call's own allocations in the caching allocator's event history) within
:data:`VALIDATION_TOLERANCE`.
"""
from __future__ import annotations

import dataclasses
from collections import Counter as _Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .audit import ProgramReport, ValueDef, tensor_bytes

__all__ = ["BufferLife", "Materialization", "MemoryReport", "memory_report",
           "measured_peak", "VALIDATION_TOLERANCE"]

#: tolerance of the estimate's temporaries against the card's measured
#: transient peak of one eager call of the same step function (the JAX
#: package's bound against ``Compiled.memory_analysis()``): the caching
#: allocator rounds every block up to 512 B and a library may take a
#: workspace the record does not see, where the sweep counts logical bytes.
VALIDATION_TOLERANCE = 0.25

# KV-cache input categories the gather-materialize detector watches
_KV_CATEGORIES = frozenset({"kv_pages", "kv_cache", "draft_pages"})
# the record's gathers and dtype converts
_GATHER_OPS = frozenset({"gather", "index_select", "index", "embedding",
                         "take"})
_CONVERT_OPS = frozenset({"_to_copy", "to", "convert"})


@dataclasses.dataclass
class BufferLife:
    """One allocated buffer's life: the liveness engine's per-value view
    (zero-cost aliases excluded)."""

    vid: str
    op: str
    bytes: int       # allocation charged to this value (alias-reduced)
    category: str
    line: int        # source line of the defining instruction
    t_def: int       # timeline index of the def
    t_end: int       # timeline index of the last use (inclusive)

    @property
    def span(self) -> int:
        return self.t_end - self.t_def

    def describe(self) -> str:
        return (f"%{self.vid} ({self.op}, {self.category}): {self.bytes} B"
                f" live [{self.t_def}, {self.t_end}]")


@dataclasses.dataclass
class Materialization:
    """One detected materialization hazard (see module docstring)."""

    kind: str
    bytes: int
    line: int
    detail: str

    def __str__(self):
        return f"{self.kind} @L{self.line}: {self.detail}"


@dataclasses.dataclass
class MemoryReport:
    """Estimated memory residency of one program."""

    dialect: str
    peak_bytes: int          # max resident bytes (inputs pinned + live)
    temp_peak_bytes: int     # max live bytes EXCLUDING the pinned inputs
    peak_index: int          # timeline index of the peak
    peak_line: int           # source line of the peak instruction
    timeline: List[Tuple[int, int, int]]  # (line, total, non-input) per t
    buffers: List[BufferLife]             # allocations, program order
    by_category: Dict[str, int]           # live bytes per category AT peak
    input_bytes: int
    output_bytes: int
    donated_bytes: int       # input bytes whose outputs write in place
    materializations: List[Materialization]
    n_values: int

    def largest_buffers(self, n: int = 10) -> List[BufferLife]:
        """The ``n`` biggest allocations, descending — where the peak
        actually lives."""
        return sorted(self.buffers, key=lambda b: -b.bytes)[:n]

    def materialization_kinds(self) -> Dict[str, int]:
        return dict(_Counter(m.kind for m in self.materializations))

    def category_share(self, category: str) -> float:
        if not self.peak_bytes:
            return 0.0
        return self.by_category.get(category, 0) / self.peak_bytes

    def summary(self) -> dict:
        """JSON-safe digest (what tools/memcheck.py snapshots)."""
        return {
            "dialect": self.dialect,
            "peak_bytes": self.peak_bytes,
            "temp_peak_bytes": self.temp_peak_bytes,
            "peak_line": self.peak_line,
            "input_bytes": self.input_bytes,
            "output_bytes": self.output_bytes,
            "donated_bytes": self.donated_bytes,
            "by_category": dict(self.by_category),
            "top_buffers": [[b.op, b.bytes]
                            for b in self.largest_buffers(5)],
            "materializations": self.materialization_kinds(),
            "n_values": self.n_values,
        }


class _Inst:
    """One live instance of an SSA value (regions re-bind short names, so
    instances — not vids — are the liveness unit)."""

    __slots__ = ("v", "t_def", "t_end", "cost", "category", "is_output")

    def __init__(self, v: ValueDef, t: int):
        self.v = v
        self.t_def = t
        self.t_end = t
        self.cost = 0
        self.category = ""
        self.is_output = False


def _build_instances(values: Sequence[ValueDef]):
    """(instances, final vid->instance map) with def/last-use indices."""
    instances: List[_Inst] = []
    cur: Dict[str, _Inst] = {}
    for t, v in enumerate(values):
        for u in v.uses:
            inst = cur.get(u)
            if inst is not None:
                inst.t_end = t
        if v.vid:
            inst = _Inst(v, t)
            instances.append(inst)
            cur[v.vid] = inst
    return instances, cur


def memory_report(report: ProgramReport,
                  categories: Optional[Dict[int, str]] = None,
                  default_category: str = "activations",
                  detect: bool = True,
                  gather_frac: float = 0.75,
                  upcast_min_bytes: int = 1 << 20,
                  long_lived_min_bytes: int = 1 << 20,
                  long_lived_frac: float = 0.5) -> MemoryReport:
    """Sweep ``report``'s def/use tables into a :class:`MemoryReport`.

    ``categories`` maps flat input index -> category label (``params`` /
    ``opt_state`` / ``kv_pages`` / ``batch`` ...); unmapped inputs land
    under ``"inputs"`` and every non-input allocation under
    ``default_category``. The detector thresholds are keyword-tunable;
    defaults are sized so tiny CI programs stay quiet (1 MiB floors) while
    real serving/training programs are caught.
    """
    categories = categories or {}
    values = report.values
    n = len(values)
    inputs = report.inputs
    pinned = sum(tensor_bytes(dt, sh) for dt, sh in inputs)
    instances, cur = _build_instances(values)

    # -- in-place inputs: the carry the program writes without a copy ----
    donated_bytes = sum(tensor_bytes(*inputs[i])
                        for i in report.donation.aliased if i < len(inputs))
    out_ids = report.output_ids

    # -- output bytes + keep outputs live to the end ---------------------
    output_bytes = 0
    for token in out_ids:
        inst = cur.get(token)
        if inst is None:
            continue
        inst.t_end = n  # never expires inside the sweep
        inst.is_output = True
        output_bytes += inst.v.bytes

    # -- per-instance cost & category (inputs are pinned, not instances'
    # cost; a row with no vid allocated nothing) --------------------------
    by_def: Dict[int, _Inst] = {}
    expiring: Dict[int, List[_Inst]] = {}
    for inst in instances:
        by_def[inst.t_def] = inst
        inst.cost = 0 if inst.v.param is not None else inst.v.bytes
        inst.category = default_category
        expiring.setdefault(inst.t_end, []).append(inst)

    cat_live: _Counter = _Counter()
    for i, (dt, sh) in enumerate(inputs):
        cat_live[categories.get(i, "inputs")] += tensor_bytes(dt, sh)

    # -- the sweep --------------------------------------------------------
    live_temp = 0
    peak = pinned
    peak_idx = -1
    peak_line = 0
    peak_cats = dict(cat_live)
    timeline: List[Tuple[int, int, int]] = []
    temp_peak = 0
    for t, v in enumerate(values):
        inst = by_def.get(t)
        if inst is not None:
            live_temp += inst.cost
            cat_live[inst.category] += inst.cost
        live_temp += v.scratch  # a kernel's own buffers, this row only
        cat_live[default_category] += v.scratch
        total = pinned + live_temp
        timeline.append((v.line, total, live_temp))
        temp_peak = max(temp_peak, live_temp)
        if total > peak:
            peak = total
            peak_idx = t
            peak_line = v.line
            peak_cats = dict(cat_live)
        live_temp -= v.scratch
        cat_live[default_category] -= v.scratch
        for d in expiring.get(t, ()):
            live_temp -= d.cost
            cat_live[d.category] -= d.cost

    buffers = [BufferLife(vid=i.v.vid, op=i.v.op, bytes=i.cost,
                          category=i.category, line=i.v.line,
                          t_def=i.t_def, t_end=min(i.t_end, n))
               for i in instances if i.cost > 0]

    mats: List[Materialization] = []
    if detect:
        mats = _detect_materializations(
            report, categories, buffers, n,
            gather_frac=gather_frac, upcast_min_bytes=upcast_min_bytes,
            long_lived_min_bytes=long_lived_min_bytes,
            long_lived_frac=long_lived_frac)

    peak_cats = {k: v for k, v in peak_cats.items() if v > 0}
    return MemoryReport(
        dialect=report.dialect, peak_bytes=peak,
        temp_peak_bytes=temp_peak, peak_index=peak_idx,
        peak_line=peak_line, timeline=timeline, buffers=buffers,
        by_category=peak_cats, input_bytes=pinned,
        output_bytes=output_bytes, donated_bytes=donated_bytes,
        materializations=mats, n_values=n)


def _detect_materializations(report: ProgramReport,
                             categories: Dict[int, str],
                             buffers: List[BufferLife], n: int, *,
                             gather_frac: float, upcast_min_bytes: int,
                             long_lived_min_bytes: int,
                             long_lived_frac: float
                             ) -> List[Materialization]:
    mats: List[Materialization] = []
    # KV gather-materialize: a gather result the size of a whole pool —
    # the decode path reading the paged cache by materializing it
    kv_max = 0
    for i, (dt, sh) in enumerate(report.inputs):
        if categories.get(i) in _KV_CATEGORIES:
            kv_max = max(kv_max, tensor_bytes(dt, sh))
    if kv_max:
        for o in report.ops:
            if o.name not in _GATHER_OPS:
                continue
            rb = tensor_bytes(o.dtype, o.shape)
            if rb >= gather_frac * kv_max:
                mats.append(Materialization(
                    "kv_gather_materialize", rb, o.line,
                    f"gather materializes {rb} B against a {kv_max} B "
                    "KV pool (what the paged read kernel is meant to "
                    "remove)"))
    # f32 upcast of bf16-stored tensors: the storage dtype's memory win
    # silently undone by a full-size convert copy
    for o in report.ops:
        if o.name not in _CONVERT_OPS or o.dtype not in ("f32", "f64"):
            continue
        src = o.dtypes[:o.n_in] if o.n_in else o.dtypes
        if "bf16" not in src and "f16" not in src:
            continue
        rb = tensor_bytes(o.dtype, o.shape)
        if rb >= upcast_min_bytes:
            low = "bf16" if "bf16" in src else "f16"
            mats.append(Materialization(
                "f32_upcast", rb, o.line,
                f"{low}-stored tensor upcast into a {rb} B {o.dtype} "
                "copy"))
    # long-lived temps: a big non-input buffer held across most of the
    # program (forward to backward): what recomputation would drop
    if n >= 16:
        for b in buffers:
            if b.bytes >= long_lived_min_bytes and \
                    b.span >= long_lived_frac * n:
                mats.append(Materialization(
                    "long_lived_temp", b.bytes, b.line,
                    f"%{b.vid} ({b.op}) holds {b.bytes} B across "
                    f"{b.span}/{n} ops, a long live range"))
    return sorted(mats, key=lambda m: (m.line, m.kind))


def measured_peak(fn, device=None) -> Tuple[int, int]:
    """What the card measured for one eager call of ``fn`` (a step
    program's function), ``(program, held)`` in bytes. ``program`` is the
    peak of the bytes the call's own allocations hold, read from the caching
    allocator's event history: each block counts from its allocation to the
    free the program requests. ``held`` is the most
    ``torch.cuda.max_memory_allocated`` rose above the bytes allocated when
    the call began; it also holds the blocks whose free waits on an event
    of another stream. The call is the second of two, so that what a first
    call makes once and keeps (cuBLAS's workspace) is not counted.
    ``program`` is the counterpart of ``jax_expected_peak``'s temporaries
    (XLA's allocation plan): :func:`memory_report`'s ``temp_peak_bytes`` is
    held against it within :data:`VALIDATION_TOLERANCE`, and its
    ``input_bytes`` against the record's ``input_storage_bytes`` exactly.
    Needs the card."""
    import torch

    index = torch.cuda._utils._get_device_index(device, optional=True)
    fn()
    torch.cuda.synchronize(index)
    before = torch.cuda.memory_allocated(index)
    torch.cuda.reset_peak_memory_stats(index)
    torch.cuda.memory._record_memory_history(context=None,
                                             max_entries=1 << 22)
    try:
        fn()
        torch.cuda.synchronize(index)
        trace = torch.cuda.memory._snapshot(index)["device_traces"][index]
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    held = int(torch.cuda.max_memory_allocated(index) - before)
    live: Dict[int, int] = {}
    cur = peak = 0
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev["size"]
            cur += ev["size"]
            peak = max(peak, cur)
        elif ev["action"] == "free_requested":
            cur -= live.pop(ev["addr"], 0)
    return peak, held

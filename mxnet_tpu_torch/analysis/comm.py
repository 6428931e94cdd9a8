"""Communication cost model over a recorded program's collectives: the
port of ``mxnet_tpu/analysis/comm.py`` for one card.

Each collective is priced by its payload and kind, JAX's convention
(logical bytes of the bandwidth-optimal algorithm, not a hardware model):

  =====================  =================================================
  all_reduce             2 x full tensor bytes (reduce-scatter + all-gather
                         halves of the ring)
  all_gather             1 x full tensor bytes (the gathered result)
  reduce_scatter         1 x full tensor bytes (the pre-scatter input)
  all_to_all             1 x tensor bytes
  collective_permute     1 x tensor bytes
  collective_broadcast   1 x tensor bytes
  =====================  =================================================

A program on one card has no collective, so its report is empty, as the
JAX serving audits are by contract. Attribution to mesh axes and the
accidental-reshard detector read a mesh, which the port does not have
until its multi-GPU slice: every collective lands under the ``"?"`` axis.
"""
from __future__ import annotations

import dataclasses
from collections import Counter as _Counter
from typing import Dict, List, Optional, Tuple

from .audit import ProgramReport, tensor_bytes

__all__ = ["CollectiveCost", "CommReport", "comm_report"]

# byte multiplier per collective kind (see module docstring table)
_KIND_FACTOR = {
    "all_reduce": 2, "all_gather": 1, "reduce_scatter": 1, "all_to_all": 1,
    "collective_permute": 1, "collective_broadcast": 1,
}


@dataclasses.dataclass
class CollectiveCost:
    """One priced collective: kind, payload and the mesh axes it crosses
    (``()`` = unattributed, rendered as ``"?"``)."""

    kind: str
    dtype: Optional[str]
    payload_bytes: int  # full logical tensor bytes (pre-factor)
    bytes: int  # payload x per-kind factor (all_reduce counts 2x)
    group_size: Optional[int]
    n_groups: Optional[int]
    axes: Tuple[str, ...]
    line: int

    @property
    def axis_key(self) -> str:
        return "×".join(self.axes) if self.axes else "?"


@dataclasses.dataclass
class CommReport:
    """Per-program communication census. Truthy iff any collective was
    found."""

    costs: List[CollectiveCost] = dataclasses.field(default_factory=list)

    def __bool__(self):
        return bool(self.costs)

    def total_bytes(self) -> int:
        return sum(c.bytes for c in self.costs)

    def by_axis(self) -> Dict[str, int]:
        out: _Counter = _Counter()
        for c in self.costs:
            out[c.axis_key] += c.bytes
        return dict(out)

    def by_kind(self) -> Dict[str, int]:
        out: _Counter = _Counter()
        for c in self.costs:
            out[c.kind] += c.bytes
        return dict(out)

    def kind_counts(self) -> Dict[str, int]:
        return dict(_Counter(c.kind for c in self.costs))

    def summary(self) -> dict:
        return {
            "n_collectives": len(self.costs),
            "total_bytes": self.total_bytes(),
            "by_axis": self.by_axis(),
            "by_kind": self.by_kind(),
            "kind_counts": self.kind_counts(),
        }


def comm_report(report: ProgramReport, mesh=None) -> CommReport:
    """Price every collective of ``report``: its largest tensor (the full
    payload: an all-gather's result, a reduce-scatter's input) times the
    kind's factor. ``mesh`` is accepted for the JAX signature; the port has
    none, so nothing is attributed to an axis."""
    costs = []
    for c in report.collectives:
        payload = max((tensor_bytes(dt, sh)
                       for dt, sh in zip(c.dtypes, c.shapes)), default=0)
        costs.append(CollectiveCost(
            kind=c.name, dtype=c.dtype, payload_bytes=payload,
            bytes=payload * _KIND_FACTOR.get(c.name, 1), group_size=None,
            n_groups=None, axes=(), line=c.line))
    return CommReport(costs=costs)

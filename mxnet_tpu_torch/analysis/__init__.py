"""Static analysis of the port: the counterpart of ``mxnet_tpu/analysis``.

Passes over two kinds of artifact, as in the JAX package:

  - the port's *programs* — what a step runs, recorded on fake tensors
    (the record, JAX's lowered program) and the CUDA graph it replays (the
    census, JAX's compiled program): :mod:`.audit` (op, dtype and kernel
    census, in-place carry coverage, host transfers, fingerprints and the
    recompile guard), and the models layered on the record's def/use
    table: :mod:`.memory` (liveness and peak residency), :mod:`.schedule`
    (the roofline DAG: critical path, MFU bound, per-class seconds) and
    :mod:`.comm` (collectives; none on one card);
  - the port's *source*: :mod:`.astlint`, the hazard linter
    (``tools/torch_lint.py``).

The JAX package's mesh passes (``contract``, ``overlap``, the
accidental-reshard detector) read a mesh, which the port gains with its
multi-GPU slice.
"""
from .audit import (  # noqa: F401
    DonationReport,
    Fingerprint,
    Op,
    ProgramAudit,
    ProgramReport,
    RecompileGuard,
    ValueDef,
    audit_program,
    census_mismatches,
    fingerprint_diff,
    graph_census,
)
from .memory import (  # noqa: F401
    VALIDATION_TOLERANCE,
    BufferLife,
    Materialization,
    MemoryReport,
    measured_peak,
    memory_report,
)
from .schedule import (  # noqa: F401
    CollectiveSpan,
    ScheduleReport,
    SerializationPoint,
    schedule_report,
)
from .comm import (  # noqa: F401
    CollectiveCost,
    CommReport,
    comm_report,
)
from .astlint import (  # noqa: F401
    LintRule,
    Violation,
    lint_file,
    lint_paths,
    lint_source,
    list_rules,
)

__all__ = [
    "Op", "DonationReport", "ProgramReport", "ProgramAudit", "ValueDef",
    "audit_program", "graph_census", "census_mismatches",
    "Fingerprint", "fingerprint_diff", "RecompileGuard",
    "MemoryReport", "BufferLife", "Materialization", "memory_report",
    "measured_peak", "VALIDATION_TOLERANCE",
    "ScheduleReport", "CollectiveSpan", "SerializationPoint",
    "schedule_report",
    "CollectiveCost", "CommReport", "comm_report",
    "LintRule", "Violation", "lint_source", "lint_file", "lint_paths",
    "list_rules",
]

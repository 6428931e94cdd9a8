"""Resilience of the port: the subset of ``mxnet_tpu/resilience`` that
the serving and training-loop slices use.

  - ``faults``   named fault sites + deterministic triggers
                 (``MXNET_TPU_FAULTS``)
  - ``retry``    exponential backoff + jitter around the serving
                 dispatches; failures of the card are never retried
  - ``serving``  the speculation governor (accept-rate fallback) and the
                 dispatch watchdog, consumed by ``ContinuousBatcher``
  - ``integrity`` checkpoint manifests, validation, atomic commits and
                 retention (``checkpoint.py``)
  - ``preemption`` SIGTERM/SIGINT -> checkpoint at the next step boundary
                 -> ``Preempted``

Elastic training comes with the multi-device slice.
"""
from __future__ import annotations

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from . import serving  # noqa: F401
from . import integrity  # noqa: F401
from . import preemption  # noqa: F401
from .integrity import CheckpointCorruptError  # noqa: F401
from .preemption import Preempted, PreemptionGuard  # noqa: F401
from .faults import InjectedCrash, InjectedFault  # noqa: F401
from .retry import RetryError, RetryPolicy, retry_call  # noqa: F401
from .serving import (AcceptRateTracker, DispatchWatchdog,  # noqa: F401
                      SpeculationGovernor)

__all__ = ["faults", "retry", "serving", "InjectedFault", "InjectedCrash",
           "RetryError", "RetryPolicy", "retry_call", "AcceptRateTracker",
           "SpeculationGovernor", "DispatchWatchdog", "integrity", "preemption",
           "CheckpointCorruptError", "Preempted", "PreemptionGuard"]

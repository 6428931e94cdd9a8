"""Resilience of the port's serving path: the subset of
``mxnet_tpu/resilience`` that the serving slice uses.

  - ``faults``   named fault sites + deterministic triggers
                 (``MXNET_TPU_FAULTS``)
  - ``retry``    exponential backoff + jitter around the serving
                 dispatches; failures of the card are never retried
  - ``serving``  the speculation governor (accept-rate fallback) and the
                 dispatch watchdog, consumed by ``ContinuousBatcher``

Checkpoint integrity, preemption and elastic training come with the
slices that port those paths.
"""
from __future__ import annotations

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from . import serving  # noqa: F401
from .faults import InjectedCrash, InjectedFault  # noqa: F401
from .retry import RetryError, RetryPolicy, retry_call  # noqa: F401
from .serving import (AcceptRateTracker, DispatchWatchdog,  # noqa: F401
                      SpeculationGovernor)

__all__ = ["faults", "retry", "serving", "InjectedFault", "InjectedCrash",
           "RetryError", "RetryPolicy", "retry_call", "AcceptRateTracker",
           "SpeculationGovernor", "DispatchWatchdog"]

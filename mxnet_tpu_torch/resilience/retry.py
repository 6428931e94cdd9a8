"""Retry with exponential backoff + jitter: a copy of
``mxnet_tpu/resilience/retry.py`` with one deliberate difference.

The sites worth retrying are the fault sites of ``resilience.faults``: in
the port, the serving dispatches (``gen.prefill``, ``gen.decode``,
``gen.verify``), which the batcher and the engine run under
:func:`retry_call`, the checkpoint reads and writes (``ckpt.save``,
``ckpt.load``) and the DataLoader's batch fetch (``data.batch``).

**What is never retried.** The JAX ``retry_call`` retries any
``Exception`` whose class does not set ``retryable = False``. On the card
that would wrap failures of the device itself into retries, so the port
re-raises these at the first attempt (recorded as one failed attempt):

  - a sticky CUDA error (``torch.AcceleratorError``): the context is
    unusable, a second launch fails the same way;
  - :class:`~mxnet_tpu_torch.base.MXNetError`: a kernel that failed to
    build or launch, a failed CUDA graph capture, a host sync inside a
    captured step — deterministic faults of the program, not noise.

Only :class:`~.faults.InjectedFault` and ordinary host-side transient
errors are retried.

Observability contract: every attempt is (a) logged on the
``mxnet_tpu_torch.resilience.retry`` logger with site / attempt index /
chosen backoff delay, and (b) recorded in an in-process per-site history
(:func:`attempt_log`) and in the ``retry_attempts_total{site,ok}`` counter.

Defaults come from ``mxnet_tpu_torch.config`` (``MXNET_TPU_RETRY_*``).
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["RetryPolicy", "RetryError", "retry_call", "attempt_log",
           "clear_log", "device_failures"]

logger = logging.getLogger("mxnet_tpu_torch.resilience.retry")


class RetryError(RuntimeError):
    """All attempts at a site failed (or its time budget ran out); carries
    the last underlying error as ``__cause__`` and the attempt records."""

    def __init__(self, site: str, attempts: List[dict]):
        super().__init__(
            f"site {site!r} failed after {len(attempts)} attempt(s): "
            f"{attempts[-1]['error'] if attempts else 'no attempts'}")
        self.site = site
        self.attempts = attempts


class RetryPolicy:
    """Exponential backoff: delay_k = min(max_delay, base * multiplier**k),
    plus up to ``jitter`` fractional extra drawn from ``random.Random(seed)``
    (seeded => the schedule is reproducible in tests; unseeded in
    production so co-failing hosts decorrelate).

    ``timeout`` is a per-call wall-clock budget across ALL attempts of one
    ``retry_call`` (0 = unlimited): no further attempt is started once it
    would begin past the budget.
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 multiplier: float = 2.0,
                 max_delay: Optional[float] = None,
                 jitter: Optional[float] = None,
                 timeout: Optional[float] = None,
                 seed: Optional[int] = None):
        from .. import config

        self.max_attempts = int(max_attempts if max_attempts is not None
                                else config.get("retry_max_attempts"))
        self.base_delay = float(base_delay if base_delay is not None
                                else config.get("retry_base_delay"))
        self.multiplier = float(multiplier)
        self.max_delay = float(max_delay if max_delay is not None
                               else config.get("retry_max_delay"))
        self.jitter = float(jitter if jitter is not None
                            else config.get("retry_jitter"))
        self.timeout = float(timeout if timeout is not None
                             else config.get("retry_timeout"))
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        import random as _random

        self._rng = _random.Random(seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based failed attempt)."""
        d = min(self.max_delay, self.base_delay * self.multiplier ** (attempt - 1))
        return d * (1.0 + self.jitter * self._rng.random())


# per-site attempt records: {"site", "attempt", "ok", "error", "delay"}
# ("delay" = backoff slept AFTER a failed attempt; None on the last one)
_history: Dict[str, List[dict]] = {}
_HISTORY_CAP = 1000  # per site — chaos runs fire thousands of attempts
# retried sites may run on more than one thread — guard the shared
# attempt log
_history_lock = threading.Lock()


def attempt_log(site: str) -> List[dict]:
    """The recorded attempts for ``site`` (most recent last)."""
    with _history_lock:
        return list(_history.get(site, ()))


def clear_log(site: Optional[str] = None) -> None:
    with _history_lock:
        if site is None:
            _history.clear()
        else:
            _history.pop(site, None)


def _record(site: str, rec: dict) -> None:
    with _history_lock:
        h = _history.setdefault(site, [])
        h.append(rec)
        if len(h) > _HISTORY_CAP:
            del h[:-_HISTORY_CAP]
    # observability bridge: every attempt also lands in the process-wide
    # metrics registry (labels: site, ok). Always on — retries are rare and
    # the counters must be trustworthy even without full telemetry (the
    # serving drill asserts them).
    from .. import observability as _obs

    _obs.counter("retry_attempts_total",
                 "retry_call attempts per fault site").inc(
                     site=site, ok="true" if rec["ok"] else "false")


def device_failures() -> tuple:
    """The exception classes :func:`retry_call` never retries: failures of
    the card or of the program on it (see the module docstring)."""
    import torch

    from ..base import MXNetError

    sticky = getattr(torch, "AcceleratorError", None)
    return (MXNetError,) + ((sticky,) if sticky is not None else ())


def _retryable(e: Exception) -> bool:
    return getattr(e, "retryable", True) and \
        not isinstance(e, device_failures())


def retry_call(fn: Callable, site: str, policy: Optional[RetryPolicy] = None):
    """Run ``fn()`` under ``policy``, retrying transient ``Exception``s.

    ``BaseException``s that are not ``Exception``s — KeyboardInterrupt,
    SystemExit, and the fault injector's :class:`~.faults.InjectedCrash` —
    pass straight through: a simulated (or real) process death must not be
    "absorbed" into a successful-looking retry. Exceptions whose class sets
    ``retryable = False``, and :func:`device_failures` (a sticky CUDA
    error, a kernel that failed to build or launch, a failed capture), are
    recorded as a failed attempt and re-raised unwrapped immediately.
    """
    policy = policy or RetryPolicy()
    start = time.monotonic()
    attempts: List[dict] = []
    for attempt in range(1, policy.max_attempts + 1):
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — IO edge: anything transient
            rec = {"site": site, "attempt": attempt, "ok": False,
                   "error": f"{type(e).__name__}: {e}", "delay": None}
            attempts.append(rec)
            _record(site, rec)
            if not _retryable(e):
                logger.error("non-retryable failure: site=%s error=%s",
                             site, rec["error"])
                raise
            out_of_budget = policy.timeout > 0 and \
                (time.monotonic() - start) >= policy.timeout
            if attempt >= policy.max_attempts or out_of_budget:
                logger.error(
                    "retry exhausted: site=%s attempts=%d elapsed=%.3fs "
                    "last_error=%s", site, attempt,
                    time.monotonic() - start, rec["error"])
                raise RetryError(site, attempts) from e
            delay = policy.delay(attempt)
            if policy.timeout > 0:
                # never sleep past the budget; the next attempt still runs
                # (it is cheaper to try once more than to give up mid-sleep)
                delay = min(delay, max(0.0,
                                       policy.timeout - (time.monotonic() - start)))
            rec["delay"] = delay
            logger.warning(
                "retrying: site=%s attempt=%d/%d backoff=%.4fs error=%s",
                site, attempt, policy.max_attempts, delay, rec["error"])
            time.sleep(delay)
        else:
            rec = {"site": site, "attempt": attempt, "ok": True,
                   "error": None, "delay": None}
            attempts.append(rec)
            _record(site, rec)
            if attempt > 1:
                logger.info("recovered: site=%s attempts=%d elapsed=%.3fs",
                            site, attempt, time.monotonic() - start)
            return result

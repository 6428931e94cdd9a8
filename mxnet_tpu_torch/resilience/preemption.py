"""Graceful preemption: SIGTERM/SIGINT -> checkpoint at the next step
boundary -> clean exit. A copy of ``mxnet_tpu/resilience/preemption.py``.

The contract:

  1. the signal handler only flips a flag — no IO, no allocation, nothing
     async-signal-unsafe happens inside the handler;
  2. the training loop polls the flag at each *step boundary* (the end of
     ``TrainStep.__call__``, of each window of ``TrainStep.run`` and of
     ``Trainer.step``), so the step or window in flight always completes;
  3. on a raised flag the installer's checkpoint action runs, then
     :class:`Preempted` (a ``SystemExit`` with code 0) unwinds the process
     cleanly.

``PreemptionGuard.request()`` exercises the whole path without a signal.
"""
from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

__all__ = ["Preempted", "PreemptionGuard"]

logger = logging.getLogger("mxnet_tpu_torch.resilience.preemption")


class Preempted(SystemExit):
    """Raised at a step boundary after the preemption checkpoint landed.

    A ``SystemExit`` with code 0: an *orderly* shutdown the process exits
    cleanly on unless the caller catches it to run its own teardown.
    """

    def __init__(self, signum: Optional[int] = None):
        super().__init__(0)
        self.signum = signum


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev = {}
        self._installed = False
        self._event = threading.Event()
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, signum: Optional[int] = None) -> None:
        """Flag a preemption programmatically (tests / external schedulers)."""
        self.signum = signum
        self._event.set()

    def clear(self) -> None:
        """Drop a pending request (a fresh run reusing this guard)."""
        self.signum = None
        self._event.clear()

    def _on_signal(self, signum, frame) -> None:
        # flag only — every real action happens at the next step boundary
        self.signum = signum
        self._event.set()

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # signal.signal only works in the main thread; in worker threads
            # the guard still works via request()
            logger.warning("PreemptionGuard: not in main thread, signal "
                           "handlers not installed (request() still works)")
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

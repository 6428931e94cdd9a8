"""Serving resilience: degradation governor + dispatch watchdog, a copy
of ``mxnet_tpu/resilience/serving.py``, consumed by
:class:`~mxnet_tpu_torch.inference.ContinuousBatcher`:

  - :class:`AcceptRateTracker` / :class:`SpeculationGovernor` — a windowed
    accept-rate monitor over speculative draft+verify rounds. When the
    accept rate collapses below a floor (adversarial prompts, a stale or
    mismatched draft model), every round still *costs* a draft and a
    verify program but *emits* barely one token — worse than not
    speculating at all. The governor falls back to the plain paged decode
    step (token-identical by the speculative-decoding contract) and
    re-arms speculation after a cooldown, so a pathological traffic mix
    degrades throughput instead of inverting it.
  - :class:`DispatchWatchdog` — a soft timeout around each dispatch of the
    serving loop. Threading-based (``threading.Timer``, no signal
    dependency, safe off the main thread): if a dispatch does not return
    within the budget it emits a ``gen_stuck_dispatch`` event carrying the
    program family, the last step id and the replica/rank identity,
    instead of hanging silently. The dispatch itself is never killed; the
    watchdog is observability, not preemption. On the card a step's
    launches return at once: the batcher's guard encloses the engine call
    up to its host sync (the tokens read back), which is what waits for a
    stuck stream. The timer thread itself never touches CUDA (a hung
    stream would hang the alarm too): it bumps a counter and emits an
    event about victims the serving loop computed on the host.

Fault sites ``gen.prefill`` / ``gen.decode`` / ``gen.verify`` (fired
inside :class:`~mxnet_tpu_torch.inference.GenerationEngine`, retried by the
batcher through :func:`~mxnet_tpu_torch.resilience.retry.retry_call`)
complete the picture; ``tools/torch_servedrill.py`` drives batcher traffic
under injected serving faults, deadline pressure and a forced accept-rate
collapse, and asserts explicit finish reasons, bit-identical surviving
rows, and a clean drained state.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
from collections import deque
from typing import Optional

from .. import observability as _obs

__all__ = ["AcceptRateTracker", "SpeculationGovernor", "DispatchWatchdog"]

logger = logging.getLogger("mxnet_tpu_torch.resilience.serving")


class AcceptRateTracker:
    """Windowed accepted/drafted ratio over the last ``window`` speculative
    rounds. ``rate`` is None until a full window has been observed — a
    fallback decision on two unlucky rounds would thrash."""

    def __init__(self, window: int = 8):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = int(window)
        self._rounds: deque = deque(maxlen=self.window)

    def observe(self, accepted: int, drafted: int) -> None:
        """Record one round. Rounds with nothing drafted (no active rows)
        carry no signal and are ignored."""
        if drafted > 0:
            self._rounds.append((int(accepted), int(drafted)))

    @property
    def full(self) -> bool:
        return len(self._rounds) == self.window

    @property
    def rate(self) -> Optional[float]:
        """Accept rate over the window (None until the window is full)."""
        if not self.full:
            return None
        drafted = sum(d for _, d in self._rounds)
        if drafted == 0:
            return None
        return sum(a for a, _ in self._rounds) / float(drafted)

    def reset(self) -> None:
        self._rounds.clear()


class SpeculationGovernor:
    """Degrade-to-safe state machine for a speculative serving engine.

    Modes:

      - ``"spec"`` (initial) — the batcher runs draft+verify rounds and
        feeds each round's (accepted, drafted) here. When a full window's
        accept rate drops below ``floor`` the governor switches to
        fallback (counter ``gen_spec_fallbacks_total``, event
        ``gen_spec_fallback`` with the collapsed rate).
      - ``"fallback"`` — the batcher runs the plain paged decode step
        (token-identical, one dispatch per token instead of two per
        round). After ``cooldown`` plain steps the governor re-arms
        speculation with a cleared window (counter
        ``gen_spec_rearms_total``, event ``gen_spec_rearm``) — a
        transient adversarial burst doesn't disable speculation forever.

    The break-even accept rate of speculation with window k is ~1/k
    (a round costs 2 dispatches for ``accept_rate * k + 1`` tokens vs 1
    dispatch per token plain), so ``floor`` should sit at or below that.

    Note: plain steps do not write the *draft* model's KV cache, so rows
    decoded during fallback have draft-cache holes after re-arm. That is
    accept-rate (performance) damage only — verification never trusts the
    draft — and it heals as those rows finish.
    """

    SPEC, FALLBACK = "spec", "fallback"

    def __init__(self, window: int = 8, floor: float = 0.125,
                 cooldown: int = 16):
        if not 0.0 <= floor <= 1.0:
            raise ValueError("floor must be in [0, 1]")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        self.floor = float(floor)
        self.cooldown = int(cooldown)
        self.tracker = AcceptRateTracker(window)
        self._mode = self.SPEC
        self._cooldown_left = 0
        self.fallbacks = 0
        self.rearms = 0
        self._mode_gauge()

    @property
    def mode(self) -> str:
        return self._mode

    @property
    def speculating(self) -> bool:
        return self._mode == self.SPEC

    def _mode_gauge(self) -> None:
        _obs.gauge("gen_spec_mode",
                   "1 = speculative rounds, 0 = plain-decode fallback").set(
                       1.0 if self._mode == self.SPEC else 0.0)

    def observe_round(self, accepted: int, drafted: int) -> None:
        """Feed one speculative round; may switch to fallback."""
        if self._mode != self.SPEC:
            return
        self.tracker.observe(accepted, drafted)
        rate = self.tracker.rate
        if rate is not None:
            _obs.gauge("gen_spec_accept_rate_window",
                       "windowed accepted/drafted ratio the governor "
                       "decides on").set(rate)
        if rate is not None and rate < self.floor:
            self._mode = self.FALLBACK
            self._cooldown_left = self.cooldown
            self.fallbacks += 1
            _obs.counter("gen_spec_fallbacks_total",
                         "speculation disabled on accept-rate collapse").inc()
            self._mode_gauge()
            _obs.emit("gen_spec_fallback", accept_rate=rate,
                      floor=self.floor, window=self.tracker.window,
                      cooldown=self.cooldown)
            logger.warning(
                "speculative accept rate collapsed (%.3f < floor %.3f over "
                "%d rounds): falling back to plain decode for %d steps",
                rate, self.floor, self.tracker.window, self.cooldown)

    def observe_plain_step(self) -> None:
        """Feed one fallback decode step; re-arms after the cooldown."""
        if self._mode != self.FALLBACK:
            return
        self._cooldown_left -= 1
        if self._cooldown_left <= 0:
            self._mode = self.SPEC
            self.tracker.reset()
            self.rearms += 1
            _obs.counter("gen_spec_rearms_total",
                         "speculation re-armed after fallback cooldown").inc()
            self._mode_gauge()
            _obs.emit("gen_spec_rearm", cooldown=self.cooldown)
            logger.info("speculation re-armed after %d plain steps",
                        self.cooldown)


class DispatchWatchdog:
    """Soft timeout around serving dispatches.

    ``guard(family, step_id)`` arms a ``threading.Timer`` for the duration
    of the dispatch; if the body does not finish within ``timeout_s`` the
    timer thread emits ``gen_stuck_dispatch`` (event + counter labelled by
    program family) with the last step id — then the guard keeps waiting.
    Timer-based, not signal-based, so it works from any thread (the
    serving loop often is not the main thread) and never interrupts the
    dispatch; ``timeout_s <= 0`` disables the guard to a bare yield.

    The event payload carries the replica/rank identity so a fleet can
    attribute a stall to exactly one replica: set ``replica`` or it falls
    back to ``MXNET_TPU_PROCID``.
    """

    def __init__(self, timeout_s: float = 0.0,
                 replica: Optional[int] = None):
        self.timeout_s = float(timeout_s)
        #: replica/rank this watchdog guards; None falls back to the
        #: process rank env at alarm time
        self.replica = replica
        self.stalls = 0
        self.last_stall: Optional[dict] = None
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.timeout_s > 0

    def _alarm(self, family: str, step_id: int,
               victims: Optional[dict] = None) -> None:
        replica = self.replica
        if replica is None:
            try:
                replica = int(os.environ.get("MXNET_TPU_PROCID", "0"))
            except ValueError:
                replica = 0
        victims = dict(victims or {})
        with self._lock:
            self.stalls += 1
            self.last_stall = {"family": family, "step_id": step_id,
                               "replica": replica,
                               "timeout_s": self.timeout_s,
                               "victims": victims}
        _obs.counter("gen_stuck_dispatch_total",
                     "serving dispatches that exceeded the watchdog "
                     "budget").inc(family=family)
        _obs.emit("gen_stuck_dispatch", family=family, step_id=step_id,
                  replica=replica, timeout_s=self.timeout_s,
                  victims=victims)
        logger.error("stuck dispatch: replica=%s family=%s step_id=%d still "
                     "running after %.3fs (victims: %s)", replica, family,
                     step_id, self.timeout_s,
                     ", ".join(f"slot {s}: req {r}"
                               for s, r in victims.items()) or "unknown")

    @contextlib.contextmanager
    def guard(self, family: str, step_id: int = 0,
              victims: Optional[dict] = None):
        """``victims`` is the ``{slot: request_id}`` mapping of the rows
        riding the guarded dispatch — attached to the stall event so an
        operator (or the fleet health tier) can see exactly which
        requests a wedge is sitting on. Callers compute it only when the
        watchdog is armed; a bare ``guard(family, step)`` still works."""
        if not self.enabled:
            yield
            return
        timer = threading.Timer(self.timeout_s, self._alarm,
                                args=(family, int(step_id), victims))
        timer.daemon = True
        timer.start()
        try:
            yield
        finally:
            timer.cancel()

"""Slot-based continuous batching over a :class:`GenerationEngine`.

Counterpart of ``mxnet_tpu/inference/batcher.py``. The decode batch is a fixed (B, ...) shape and a *slot* is one
row of it. Queued requests are admitted FIFO into free slots at step
boundaries, by a batch-1 prefill into one cache row; a request holds its
slot only once its prefill has returned. Finished rows (EOS, token budget,
cache end, page exhaustion, deadline, cancellation) free their slot and
pages for the next request.

On a paged engine admission is bounded by pages: the queue head is
admitted when ``available_pages`` (free pages plus prefix-cache pages that
eviction could free) covers ``pages_needed`` (the pages its prefill takes
after adopting a cached prefix). While the head is parked on pages, later
requests that the unreserved free pages cover may bypass it (the head
keeps its place), until the aging guard (``serve_head_aging_steps``
deferred boundaries) stops the bypass and reserves freed pages for the
head (``engine.reserve_pages``). A head whose cached prefix was evicted
while it queued, and that no bucket can take without it, is shed
(``cause="prefix_evicted"``).

``submit(..., samples=N)`` asks for N samples of one prompt: the leader
prefills once, and its N - 1 siblings are admitted by copy-on-write fork
(``engine.fork_slot``), each with its own first token drawn from the
leader's prefill logits. A sibling left queued when its leader finished
falls back to an ordinary prefill.

Serving resilience, as in the JAX batcher:

  - **deadlines** — requests carry ``deadline_s`` (default
    ``serve_default_deadline``); at every step boundary expired queued
    requests are dropped before admission and expired active rows are
    finished (reason ``"deadline"``), their pages freed at once;
  - **cancellation** — ``cancel(request_id)`` (or ``req.cancel()``) marks
    a request; the next step boundary applies it (``"cancelled"``) with
    the same slot and page reclaim;
  - **overload control** — a bounded admission queue
    (``serve_max_queue``) with policy ``"reject"`` (shed the new request)
    or ``"shed"`` (evict the oldest queued request already past its
    deadline), plus a free-page load-shed watermark
    (``serve_shed_page_floor``). Shed requests finish with reason
    ``"shed"`` (``gen_shed_total{cause=}``);
  - **degrade-to-safe speculation** — on a speculative engine a
    :class:`~mxnet_tpu_torch.resilience.serving.SpeculationGovernor`
    watches the windowed accept rate and falls back to the plain paged
    decode step (``engine.plain_step``, token-identical) when it
    collapses, re-arming after a cooldown;
  - **dispatch watchdog** — every dispatch runs under a soft
    ``serve_watchdog_s`` timeout that emits ``gen_stuck_dispatch``
    (program family + step id). The guard encloses the whole engine call,
    up to its host sync (the tokens read back), so a step whose graph
    replay returned at once but whose stream hangs still trips it;
  - **fault sites** — the engine fires ``gen.prefill`` / ``gen.decode`` /
    ``gen.verify``, and each dispatch runs under
    :func:`~mxnet_tpu_torch.resilience.retry.retry_call` (one policy for
    all, the engine's in-round verify retry included). A failure of the
    card is never retried (``retry.device_failures``).

Telemetry (always recorded): ``ttft_seconds`` (submit to first token),
``ttft_queue_seconds`` (submit to admission, batcher clock),
``ttft_service_seconds`` (admission to first token, real wall clock),
``decode_tokens_per_s``, ``gen_queue_depth``, ``gen_active_slots``,
``gen_queue_age_seconds{outcome=}``, ``gen_requests_total{reason=}``,
``gen_shed_total{cause=}``, ``gen_deadline_expired_total{where=}``,
``gen_admission_rejects_total{reason=}``, ``gen_admission_bypass_total``.

Request tracing: when ``self.tracer`` is set (the serving replica attaches
one when the ``trace`` knob is on), every request's residency here becomes
spans (``replica.queue``, ``prefill`` or ``fork``, ``decode`` and a
``decode.round`` a dispatch), buffered per trace and tail-sample-flushed
at local finish, in the JAX batcher's places and with its attributes.
``trace_id`` rides in through :meth:`submit` (the fleet router passes its
request id so that the traces of its processes join); direct clients get a
local ``b{id}`` trace. Spans are taken on the host around a dispatch,
never inside a captured step graph. Tracing off costs each site one
``tracer is None`` read.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional, Sequence

from .. import config as _config
from .. import observability as _obs
from ..base import MXNetError, resolve_device
from ..resilience import retry as _retry
from ..resilience import serving as _serving

__all__ = ["ContinuousBatcher", "GenRequest", "FINISH_REASONS"]

#: every way a request can terminate. ``"redistributed"`` is a pull-back
#: for re-routing (``withdraw``, ``abandon``): the work is not abandoned,
#: it re-runs elsewhere (distinct from ``"cancelled"``, a client decision)
FINISH_REASONS = ("eos", "length", "cache_full", "page_exhausted",
                  "deadline", "cancelled", "shed", "redistributed")


class GenRequest:
    """Handle for one submitted generation request."""

    def __init__(self, req_id: int, prompt, max_new_tokens: int,
                 deadline_s: Optional[float] = None,
                 clock=time.perf_counter):
        self.id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.output: List[int] = []
        self.slot: Optional[int] = None
        #: one of FINISH_REASONS once done
        self.finish_reason: Optional[str] = None
        self.submit_t = clock()
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        #: absolute expiry point on the batcher's clock (None = no deadline)
        self.deadline_t = None if self.deadline_s is None \
            else self.submit_t + self.deadline_s
        self.first_token_t: Optional[float] = None
        self.finish_t: Optional[float] = None
        self.cancel_requested = False
        #: admission timestamp (batcher clock)
        self.admit_t: Optional[float] = None
        #: trace identity: the router's request id for fleet traffic, a
        #: local ``b{id}`` for direct clients, None when tracing is off
        self.trace_id: Optional[str] = None
        #: decode steps (or speculative rounds) this request rode
        self.rounds = 0
        #: ``samples=N``: the leader this sibling forks from at admission
        #: (None = independent), and on the leader the group's handles
        self._fork_of: Optional["GenRequest"] = None
        self.samples: Optional[List["GenRequest"]] = None
        #: True when admitted by a copy-on-write fork instead of a prefill
        self.forked = False

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def cancel(self) -> None:
        """Request cancellation; applied at the next step boundary (the
        slot and its pages are reclaimed there, finish reason
        ``"cancelled"``). Idempotent; a no-op once the request is done."""
        self.cancel_requested = True

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def result(self) -> List[int]:
        if not self.done:
            raise RuntimeError(f"request {self.id} still running")
        return list(self.output)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class ContinuousBatcher:
    """FIFO admission of queued requests into free decode slots, with
    deadlines, cancellation, overload shedding and degrade-to-safe
    speculative decoding (see the module docstring). The knobs default to
    the ``serve_*`` config entries (``MXNET_TPU_SERVE_*``); pass
    ``clock=`` to drive deadline arithmetic from a fake clock."""

    def __init__(self, engine, device="cuda",
                 max_queue: Optional[int] = None,
                 queue_policy: Optional[str] = None,
                 shed_page_floor: Optional[int] = None,
                 head_aging_steps: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 spec_window: Optional[int] = None,
                 spec_floor: Optional[float] = None,
                 spec_cooldown: Optional[int] = None,
                 watchdog_s: Optional[float] = None,
                 retry_policy=None, clock=None):
        dev = resolve_device(device)
        if engine.device != dev:
            raise MXNetError(f"engine is on {engine.device}, batcher asked "
                             f"for {dev}")

        def knob(value, name, typ):
            return typ(value if value is not None else _config.get(name))

        self.engine = engine
        self._queue: deque = deque()
        self._slots: List[Optional[GenRequest]] = [None] * engine.batch_size
        self._ids = itertools.count()
        self._clock = clock or time.perf_counter
        self.max_queue = knob(max_queue, "serve_max_queue", int)
        self.queue_policy = knob(queue_policy, "serve_queue_policy", str)
        if self.queue_policy not in ("reject", "shed"):
            raise ValueError(f"unknown queue policy {self.queue_policy!r}")
        self.shed_page_floor = knob(shed_page_floor, "serve_shed_page_floor",
                                    int)
        self.head_aging_steps = knob(head_aging_steps,
                                     "serve_head_aging_steps", int)
        self.default_deadline_s = knob(default_deadline_s,
                                       "serve_default_deadline", float)
        self._retry_policy = retry_policy or _retry.RetryPolicy()
        # one policy governs every serving retry, including the engine's
        # in-round gen.verify retry
        engine.retry_policy = self._retry_policy
        self._watchdog = _serving.DispatchWatchdog(
            knob(watchdog_s, "serve_watchdog_s", float))
        self.governor = None
        if engine.speculative:
            self.governor = _serving.SpeculationGovernor(
                window=knob(spec_window, "serve_spec_window", int),
                floor=knob(spec_floor, "serve_spec_floor", float),
                cooldown=knob(spec_cooldown, "serve_spec_cooldown", int))
        self._step_id = 0
        self._head_id: Optional[int] = None
        self._head_deferrals = 0
        #: the request-span emitter (an ``observability.tracing.Tracer``),
        #: attached by the serving replica when the ``trace`` knob is on
        self.tracer = None
        #: drain mode: no new admissions — queued work is pulled back with
        #: ``withdraw_queued``, in-flight rows finish or expire
        self.draining = False

    # -- client side ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               samples: int = 1) -> GenRequest:
        """Queue a request. Raises ``ValueError`` for a request that could
        never be served: a token id outside ``[0, vocab)``, no prefill
        bucket (unless a cached prefix shrinks the suffix into one), or
        more pages than the pool. Returns an already-finished handle
        (``finish_reason == "shed"``) when overload control sheds it —
        callers must check ``req.done``.

        ``samples=N`` (paged engines) asks for N samples of one prompt,
        whose handles land on the returned leader's ``samples``; siblings
        ride the same overload controls.

        ``trace_id`` joins this request to a fleet-level trace (the router
        passes its request id); when tracing is on and no id is given, a
        local ``b{id}`` trace is opened."""
        eng = self.engine
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if samples < 1:
            raise ValueError("samples must be >= 1")
        if samples > 1 and not eng.paged:
            raise ValueError("samples > 1 needs a paged engine "
                             "(copy-on-write fork)")
        if not all(0 <= int(t) < eng._vocab for t in prompt):
            raise ValueError(f"prompt token ids must lie in [0, {eng._vocab})")
        try:
            eng.bucket_for(len(prompt))  # reject oversize prompts now
        except ValueError:
            # a prompt longer than every bucket is still admissible when a
            # cached prefix shrinks its suffix into one
            if not (eng.paged and eng.prefix_cache is not None
                    and eng.can_admit(prompt)):
                _obs.counter(
                    "gen_admission_rejects_total",
                    "requests rejected or deferred at admission").inc(
                        reason="prompt_length")
                raise
        if eng.paged and eng.pages_for(len(prompt)) > eng.num_pages:
            _obs.counter("gen_admission_rejects_total",
                         "requests rejected or deferred at admission").inc(
                             reason="prompt_pages")
            raise ValueError(
                f"prompt needs {eng.pages_for(len(prompt))} pages; the "
                f"whole pool holds {eng.num_pages}")
        if deadline_s is None and self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
        req = GenRequest(next(self._ids), prompt, max_new_tokens,
                         deadline_s=deadline_s, clock=self._clock)
        if self.tracer is not None:
            req.trace_id = str(trace_id) if trace_id is not None \
                else f"b{req.id}"
        now = req.submit_t
        if self.draining:
            return self._shed(req, now, cause="draining")
        # -- overload control ------------------------------------------------
        if eng.paged and self.shed_page_floor > 0:
            # the watermark charges only what this request would allocate:
            # a cached prefix credits the free-page balance
            cached = eng.pages_for(len(prompt)) - eng.pages_needed(prompt)
            if (eng.free_pages + cached < self.shed_page_floor
                    and (self._queue or self.active == eng.batch_size)):
                return self._shed(req, now, cause="page_floor")
        if self.max_queue > 0 and len(self._queue) >= self.max_queue:
            victim = None
            if self.queue_policy == "shed":
                victim = next((r for r in self._queue if r.expired(now)),
                              None)
            if victim is None:
                return self._shed(req, now, cause="queue_full")
            self._queue.remove(victim)
            self._shed(victim, now, cause="queue_full")
        self._queue.append(req)
        if samples > 1:
            req.samples = [req]
            for _ in range(samples - 1):
                sib = GenRequest(next(self._ids), prompt, max_new_tokens,
                                 deadline_s=deadline_s, clock=self._clock)
                sib._fork_of = req
                if self.tracer is not None:
                    sib.trace_id = f"b{sib.id}"
                req.samples.append(sib)
                if self.max_queue > 0 and len(self._queue) >= self.max_queue:
                    self._shed(sib, sib.submit_t, cause="queue_full")
                    continue
                self._queue.append(sib)
        self._gauges()
        return req

    def cancel(self, req_or_id) -> bool:
        """Mark a request for cancellation by handle or id. The next step
        boundary reclaims its slot and pages (finish reason
        ``"cancelled"``). Returns False for unknown/finished requests."""
        if isinstance(req_or_id, GenRequest):
            req = req_or_id if not req_or_id.done else None
        else:
            req = next((r for r in list(self._queue) + self._slots
                        if r is not None and r.id == req_or_id
                        and not r.done), None)
        if req is None:
            return False
        req.cancel()
        return True

    # -- drain hooks -----------------------------------------------------------
    def begin_drain(self) -> None:
        """Enter drain mode: every later ``submit`` is shed
        (``cause="draining"``) and admission stops; in-flight rows finish
        or expire normally. Idempotent; there is no un-drain."""
        self.draining = True

    def withdraw(self, req_or_id) -> bool:
        """Pull one *queued* request back for re-routing: it finishes at
        once with reason ``"redistributed"``. A queued request holds no
        slot or pages, so there is nothing to reclaim. Returns False for
        active rows and unknown/finished requests."""
        now = self._clock()
        if isinstance(req_or_id, GenRequest):
            req = req_or_id
        else:
            req = next((r for r in self._queue if r.id == req_or_id), None)
        if req is None or req.done or req not in self._queue:
            return False
        self._queue.remove(req)
        self._finish_queued(req, now, "redistributed")
        self._gauges()
        return True

    def withdraw_queued(self) -> List[GenRequest]:
        """Pull back every queued request (drain entry): each finishes
        with reason ``"redistributed"``; the handles are returned."""
        out = list(self._queue)
        self._queue.clear()
        now = self._clock()
        for req in out:
            self._finish_queued(req, now, "redistributed")
        self._gauges()
        return out

    def abandon(self) -> List[GenRequest]:
        """Declare this batcher lost: every live request, queued and
        in-flight, finishes with reason ``"redistributed"``. Bookkeeping
        only: no engine dispatch and no allocator change (the engine may
        be wedged inside one); the engine is discarded with the batcher."""
        now = self._clock()
        out = self.withdraw_queued()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            self._slots[slot] = None
            req.finish_reason = "redistributed"
            req.finish_t = now
            tr = self.tracer
            if tr is not None and req.trace_id is not None:
                tr.span(req.trace_id, "decode",
                        req.first_token_t if req.first_token_t is not None
                        else now, now, rounds=req.rounds, slot=slot,
                        outcome="redistributed", req=req.id)
                tr.finish(req.trace_id, "redistributed", req.submit_t,
                          now, deadline=req.deadline_t, req=req.id)
            _obs.counter("gen_requests_total",
                         "completed generation requests").inc(
                             reason="redistributed")
            out.append(req)
        self._gauges()
        return out

    # -- queue telemetry -----------------------------------------------------
    def queue_ages(self, now: Optional[float] = None) -> List[float]:
        if now is None:
            now = self._clock()
        return [max(0.0, now - r.submit_t) for r in self._queue]

    def queue_age_p95(self, now: Optional[float] = None) -> float:
        """p95 age of the *currently queued* requests (0.0 when empty) —
        the live backlog-pressure signal, distinct from the
        ``gen_queue_age_seconds`` histogram, which records ages at queue
        exit."""
        ages = sorted(self.queue_ages(now))
        if not ages:
            return 0.0
        return ages[max(0, -(-len(ages) * 95 // 100) - 1)]

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def watchdog(self) -> _serving.DispatchWatchdog:
        return self._watchdog

    # -- serving loop --------------------------------------------------------
    def _gauges(self):
        _obs.gauge("gen_queue_depth",
                   "requests waiting for a decode slot").set(len(self._queue))
        _obs.gauge("gen_active_slots", "decode rows in flight").set(self.active)

    def _queue_age(self, req: GenRequest, now: float, outcome: str):
        _obs.histogram("gen_queue_age_seconds",
                       "time spent in the admission queue, by outcome",
                       unit="s").observe(max(0.0, now - req.submit_t),
                                         outcome=outcome)

    def _victims(self) -> Optional[dict]:
        """slot -> request id of every in-flight row, for a stall event;
        computed on the host, and only when the watchdog is armed."""
        if not self._watchdog.enabled:
            return None
        return {str(s): r.id for s, r in enumerate(self._slots)
                if r is not None}

    def _trace_queue_exit(self, req: GenRequest, now: float, outcome: str,
                          terminal: bool, **attrs) -> None:
        """Span the request's admission-queue residency; when the wait
        ended the request (shed, expired, withdrawn), close the local
        trace too: the tail sampler decides whether the spans flush."""
        tr = self.tracer
        if tr is None or req.trace_id is None:
            return
        tr.span(req.trace_id, "replica.queue", req.submit_t, now,
                outcome=outcome, req=req.id, **attrs)
        if terminal:
            tr.finish(req.trace_id, outcome, req.submit_t, now,
                      deadline=req.deadline_t, req=req.id)

    def _shed(self, req: GenRequest, now: float, cause: str) -> GenRequest:
        req.finish_reason = "shed"
        req.finish_t = now
        _obs.counter("gen_requests_total",
                     "completed generation requests").inc(reason="shed")
        _obs.counter("gen_shed_total",
                     "requests shed by overload control").inc(cause=cause)
        self._queue_age(req, now, "shed")
        self._trace_queue_exit(req, now, "shed", terminal=True, cause=cause)
        return req

    def _finish_queued(self, req: GenRequest, now: float, reason: str):
        """Terminate a request that never reached a slot (deadline expiry,
        cancellation or withdrawal while queued)."""
        req.finish_reason = reason
        req.finish_t = now
        _obs.counter("gen_requests_total",
                     "completed generation requests").inc(reason=reason)
        if reason == "deadline":
            _obs.counter("gen_deadline_expired_total",
                         "requests expired by their deadline").inc(
                             where="queue")
        self._queue_age(req, now, reason)
        self._trace_queue_exit(req, now, reason, terminal=True)

    def _finish(self, slot: int, reason: str):
        req = self._slots[slot]
        self._slots[slot] = None
        if (reason in ("eos", "length", "cache_full")
                and self.engine.prefix_cache is not None):
            # index the finished sequence's full pages before the release,
            # so that a next turn (prompt + output + more) adopts them
            self.engine.cache_sequence(slot, list(req.prompt)
                                       + [int(t) for t in req.output])
        self.engine.release_slot(slot)
        req.finish_reason = reason
        req.finish_t = self._clock()
        tr = self.tracer
        if tr is not None and req.trace_id is not None:
            tr.span(req.trace_id, "decode",
                    req.first_token_t if req.first_token_t is not None
                    else req.finish_t,
                    req.finish_t, rounds=req.rounds, slot=slot,
                    outcome=reason, req=req.id)
            tr.finish(req.trace_id, reason, req.submit_t, req.finish_t,
                      deadline=req.deadline_t, req=req.id)
        _obs.counter("gen_requests_total", "completed generation requests").inc(
            reason=reason)
        if reason == "deadline":
            _obs.counter("gen_deadline_expired_total",
                         "requests expired by their deadline").inc(
                             where="slot")
        gen = len(req.output) - 1  # tokens after the TTFT token
        span = req.finish_t - (req.first_token_t or req.submit_t)
        if gen > 0 and span > 0:
            _obs.histogram("decode_tokens_per_s",
                           "per-request generation rate after first token",
                           unit="tokens/s").observe(gen / span)

    def _sweep(self, now: float):
        """Step-boundary housekeeping: apply cancellations and deadline
        expiry to queued requests and active slots. Slot reclaim goes
        through ``release_slot``: pages free at once and the device
        page-table row is cleared before the next dispatch writes
        anything, so surviving rows are never corrupted."""
        if self._queue:
            keep: deque = deque()
            for req in self._queue:
                if req.cancel_requested:
                    self._finish_queued(req, now, "cancelled")
                elif req.expired(now):
                    self._finish_queued(req, now, "deadline")
                else:
                    keep.append(req)
            self._queue = keep
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if req.cancel_requested:
                self._finish(slot, "cancelled")
            elif req.expired(now):
                self._finish(slot, "deadline")

    def _seat(self, slot: int, req: GenRequest, now: float, tok: int,
              service_s: float, src: Optional[int] = None):
        """Seat an admitted request in ``slot`` with its first token
        (``src``: the leader's slot of a forked sibling)."""
        req.slot = slot
        self._slots[slot] = req
        req.admit_t = now
        self._queue_age(req, now, "admitted")
        if src is None:
            self._trace_queue_exit(req, now, "admitted", terminal=False,
                                   slot=slot)
        else:
            self._trace_queue_exit(req, now, "admitted", terminal=False,
                                   slot=slot, forked=True)
        req.first_token_t = self._clock()
        _obs.histogram("ttft_queue_seconds",
                       "submit -> admission: the queue-wait half of ttft",
                       unit="s").observe(max(0.0, now - req.submit_t))
        _obs.histogram("ttft_seconds", "submit -> first sampled token",
                       unit="s").observe(req.first_token_t - req.submit_t)
        _obs.histogram("ttft_service_seconds",
                       "admission -> first sampled token: the service "
                       "half of ttft, on the real wall clock",
                       unit="s").observe(service_s)
        tr = self.tracer
        if tr is not None and req.trace_id is not None:
            if src is None:
                tr.span(req.trace_id, "prefill", req.admit_t,
                        req.first_token_t, service_s=round(service_s, 6),
                        slot=slot, req=req.id)
            else:
                tr.span(req.trace_id, "fork", req.admit_t,
                        req.first_token_t, service_s=round(service_s, 6),
                        slot=slot, src=src, req=req.id)
        req.output.append(tok)

    def _admit_into(self, slot: int, req: GenRequest, now: float):
        """One bucketed batch-1 prefill under the retry policy and the
        watchdog (the engine fires ``gen.prefill`` before any allocator
        change). The request takes the slot only once the prefill has
        returned: a prefill that still fails leaves the slot free and puts
        the request back at the head of the queue."""

        def attempt():
            # the watchdog arms per ATTEMPT (inside the retried closure):
            # retry backoff sleeps must never read as a stuck dispatch
            with self._watchdog.guard("prefill", self._step_id,
                                      victims={str(slot): req.id}
                                      if self._watchdog.enabled else None):
                return self.engine.prefill(req.prompt, slot)

        svc0 = time.perf_counter()
        try:
            tok = _retry.retry_call(attempt, site="gen.prefill",
                                    policy=self._retry_policy)
        except BaseException:
            self._queue.appendleft(req)
            raise
        self._seat(slot, req, now, tok, time.perf_counter() - svc0)
        if (req.samples is not None and self.engine.paged
                and not self.engine.done[slot]):
            # fork before the leader can finish: siblings need its pages
            self._admit_forks(req, now)
        if self.engine.done[slot]:  # first token was EOS
            self._finish(slot, "eos")
        elif req.max_new_tokens == 1:
            self._finish(slot, "length")

    def _admit_forks(self, leader: GenRequest, now: float):
        """Admit the leader's still-queued siblings into free slots by
        copy-on-write fork: refcount bumps and one draw from the leader's
        prefill logits, no prefill and no new pages. Siblings that find no
        free slot stay queued."""
        eng = self.engine
        for sib in [r for r in self._queue if r._fork_of is leader]:
            if eng.done[leader.slot]:
                break  # the leader finished (a sampled EOS on a fork)
            slot = next((s for s in range(eng.batch_size)
                         if self._slots[s] is None), None)
            if slot is None:
                break
            self._queue.remove(sib)
            sib.forked = True
            svc0 = time.perf_counter()
            tok = eng.fork_slot(leader.slot, slot, resample_first=True)
            self._seat(slot, sib, now, tok, time.perf_counter() - svc0,
                       src=leader.slot)
            if eng.done[slot]:  # the resampled first token was EOS
                self._finish(slot, "eos")
            elif sib.max_new_tokens == 1:
                self._finish(slot, "length")

    def _admit(self, now: float):
        """Step-boundary admission: fill free slots FIFO, bounded by pages
        on a paged engine (see the module docstring)."""
        if self.draining:
            return  # drain mode: in-flight only, nothing new starts
        eng = self.engine
        if eng.paged and eng.prefix_cache is not None:
            # a head admitted past the bucket check on the strength of a
            # cached prefix may have lost it to eviction while it queued
            while self._queue and not eng.can_admit(self._queue[0].prompt):
                self._shed(self._queue.popleft(), now,
                           cause="prefix_evicted")
        deferral_counted = False
        for slot in range(eng.batch_size):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            head = self._queue[0]
            if not eng.paged:
                self._admit_into(slot, self._queue.popleft(), now)
                continue
            need = eng.pages_needed(head.prompt)
            if eng.available_pages >= need:
                eng.reserve_pages(0)
                self._head_id = None
                self._head_deferrals = 0
                self._admit_into(slot, self._queue.popleft(), now)
                continue
            # the head waits for pages: one deferral a boundary
            if not deferral_counted:
                deferral_counted = True
                _obs.counter("gen_admission_rejects_total",
                             "requests rejected or deferred at admission").inc(
                                 reason="free_pages")
                if head.id != self._head_id:
                    self._head_id = head.id
                    self._head_deferrals = 0
                self._head_deferrals += 1
            if (self.head_aging_steps > 0
                    and self._head_deferrals > self.head_aging_steps):
                # aging guard: stop the bypass, hold freed pages for the head
                eng.reserve_pages(need)
                break
            # bypass: the first later request the unreserved pool covers
            avail = eng.free_pages - eng.reserved_pages
            cand = next((i for i in range(1, len(self._queue))
                         if eng.pages_needed(self._queue[i].prompt)
                         <= avail), None)
            if cand is None:
                break
            req = self._queue[cand]
            del self._queue[cand]
            _obs.counter("gen_admission_bypass_total",
                         "small requests admitted past a page-parked "
                         "queue head").inc()
            self._admit_into(slot, req, now)
        if not self._queue:
            self._head_id = None
            self._head_deferrals = 0
            if eng.paged and eng.reserved_pages:
                eng.reserve_pages(0)

    def _done_reason(self, slot: int, last_token) -> str:
        """Why the engine marked this row done: a sampled EOS, a forced
        cache-end finish, or (paged) a page-pool eviction."""
        if self.engine.paged and bool(self.engine.page_exhausted[slot]):
            return "page_exhausted"
        if (self.engine.eos_id is not None
                and last_token == self.engine.eos_id):
            return "eos"
        if self.engine.positions[slot] >= self.engine.max_length:
            return "cache_full"
        return "eos"

    def _dispatch(self, family: str, fn):
        """``fn()`` under the watchdog, inside ``retry_call`` at site
        ``gen.decode`` (the watchdog arms per attempt)."""

        def attempt():
            with self._watchdog.guard(family, self._step_id,
                                      victims=self._victims()):
                return fn()

        return _retry.retry_call(attempt, site="gen.decode",
                                 policy=self._retry_policy)

    def step(self) -> bool:
        """Sweep deadlines and cancellations, admit, then run one decode
        step (or one speculative draft + verify round, or, in governor
        fallback, one plain step on the speculative engine). Returns True
        while any work (active rows or queued requests) remains."""
        now = self._clock()
        self._step_id += 1
        self._sweep(now)
        self._admit(now)
        self._gauges()
        if self.active == 0:
            return bool(self._queue)
        was_active = [s for s, r in enumerate(self._slots) if r is not None]
        eng = self.engine
        tr = self.tracer
        if eng.speculative and self.governor.speculating:
            r0 = self._clock() if tr is not None else now
            toks, counts, done = self._dispatch("spec_round", eng.spec_step)
            r1 = self._clock() if tr is not None else now
            if eng.last_round_drafted:
                self.governor.observe_round(eng.last_round_accepted,
                                            eng.last_round_drafted)
            for slot in was_active:
                req = self._slots[slot]
                req.rounds += 1
                n = int(counts[slot])
                room = req.max_new_tokens - len(req.output)
                req.output.extend(int(t) for t in toks[slot, :min(n, room)])
                if tr is not None and req.trace_id is not None:
                    tr.span(req.trace_id, "decode.round", r0, r1,
                            step=self._step_id, mode="spec", slot=slot,
                            accepted=int(eng.last_round_accepted),
                            drafted=int(eng.last_round_drafted),
                            tokens=min(n, room))
                if room < n:  # the budget ended inside the window
                    self._finish(slot, "length")
                elif done[slot]:
                    self._finish(slot, self._done_reason(
                        slot, req.output[-1] if req.output else None))
                elif len(req.output) >= req.max_new_tokens:
                    self._finish(slot, "length")
        else:
            r0 = self._clock() if tr is not None else now
            tok, done, _ = self._dispatch(
                "decode", eng.plain_step if eng.speculative
                else eng.decode_step)
            r1 = self._clock() if tr is not None else now
            if self.governor is not None:
                self.governor.observe_plain_step()
            for slot in was_active:
                req = self._slots[slot]
                req.rounds += 1
                if tr is not None and req.trace_id is not None:
                    tr.span(req.trace_id, "decode.round", r0, r1,
                            step=self._step_id,
                            mode="plain" if eng.speculative else "decode",
                            slot=slot, tokens=1)
                if eng.paged and done[slot] and bool(eng.page_exhausted[slot]):
                    # evicted BEFORE the step: the row emitted pad this
                    # step, not a token
                    self._finish(slot, "page_exhausted")
                    continue
                req.output.append(int(tok[slot]))
                if done[slot]:
                    self._finish(slot, self._done_reason(slot, req.output[-1]))
                elif len(req.output) >= req.max_new_tokens:
                    self._finish(slot, "length")
        self._gauges()
        return bool(self._queue) or self.active > 0

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        """Drive steps until queue and slots are empty (or ``max_steps``)."""
        self.run(max_steps)

    def run(self, max_steps: Optional[int] = None) -> int:
        """Drive steps until queue and slots are empty (or ``max_steps``).
        Returns the number of steps taken."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

"""Fleet router: priority admission, telemetry-driven balancing, session
affinity, redistribution. A copy of ``mxnet_tpu/serving/router.py``: the
same placement decisions from the same ``random.Random(seed)`` draws, in
the same order, so that a drill routes identically in both packages.

The router owns the *work*, replicas own the *execution*. Every request
submitted here keeps an authoritative record (prompt, budget, absolute
deadline, priority class, session) in the router, so losing a replica
loses at most the tokens it had decoded — the request itself is
re-enqueued and re-run elsewhere while its deadline still has room.

Scheduling is one ``step()`` per tick:

  1. read every replica's newest *published* snapshot
     (:func:`~mxnet_tpu_torch.serving.replica.read_fleet_views` — the router
     deliberately has no in-process shortcut to a batcher's state);
  2. run :class:`~mxnet_tpu_torch.serving.health.FleetHealth` and apply the
     side effects — on DRAINING the replica stops admitting and its
     queued work is pulled back (finish reason ``"redistributed"``); on
     DEAD its remaining in-deadline work is re-enqueued and the handle
     detached;
  3. harvest finished requests off their replicas;
  4. expire backlogged requests past their deadline;
  5. dispatch the backlog in priority-class order: session-affine
     requests go to the replica already holding their prefix pages
     (while it is LIVE) — sessionless requests get the same treatment
     keyed by a hash of their first ``router_prefix_tokens`` prompt
     tokens, so template-sharing traffic concentrates its radix
     prefix-cache hits on one replica; everything else is placed by
     power-of-two-choices over the published
     ``free_pages - queue_depth - queue_age_p95`` score, and only onto
     replicas whose published queue depth is within
     ``router_queue_bound`` — under overload low classes wait in the
     router, they do not bury the replicas.

Telemetry: ``router_requests_total{priority=}``,
``router_admissions_total{replica=}``,
``router_redistributions_total{replica=,cause=}``,
``router_completions_total{reason=}``, ``router_backlog_depth`` and the
health tier's ``router_replica_state{replica=}``; :meth:`publish` drops
them into ``{fleet_dir}/router/`` so ``tools/torch_fleetreport.py``
renders the router columns from snapshots alone.

Request tracing: with the ``trace`` knob on, the router is the trace *owner* — it spans
every request's backlog/attempt residency into
``{fleet_dir}/router/spans-g0.jsonl`` and writes the terminal ``end``
verdict the SLO ledger folds. The spans telescope (each boundary closes
one span and opens the next at the same timestamp), so their sum equals
the end-to-end latency exactly and a killed replica leaves no gap — its
residency is the router's ``router.attempt`` span. The trace id is the
router request id, passed to the replica via ``submit(trace_id=...)``
so the batcher's detail spans join at aggregation.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from .. import observability as _obs
from ..observability import fleet as _fleet
from ..observability import tracing as _tracing
from . import health as _health
from .replica import ServingReplica, read_fleet_views

__all__ = ["FleetRouter", "RouterRequest"]

#: finish reasons terminal at the ROUTER (``"redistributed"`` never is —
#: it means "this attempt moved", not "this request ended")
TERMINAL_REASONS = ("eos", "length", "cache_full", "page_exhausted",
                    "deadline", "cancelled", "shed")


class RouterRequest:
    """The router's authoritative record of one request."""

    def __init__(self, req_id: int, prompt: Sequence[int],
                 max_new_tokens: int, priority: str,
                 session: Optional[str], deadline_s: Optional[float],
                 now: float):
        self.id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.priority = priority
        self.session = session
        #: affinity-map key: the session id, or (sessionless) a hash of
        #: the leading prompt tokens so template-sharing requests land on
        #: the replica whose prefix cache already holds their pages
        self.affinity_key: Optional[str] = session
        self.submit_t = float(now)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.deadline_t = None if self.deadline_s is None \
            else self.submit_t + self.deadline_s
        #: (replica_id, GenRequest) while an attempt is in flight
        self.current: Optional[Tuple[int, object]] = None
        self.replicas_tried: List[int] = []
        self.redistributions = 0
        self.finish_reason: Optional[str] = None
        self.output: List[int] = []
        self.finish_t: Optional[float] = None
        #: start of the CURRENT trace phase (backlog or attempt) — every
        #: phase boundary closes a span [phase_t0, now] and resets this
        #: to now, so the spans telescope to exactly the e2e latency
        self.phase_t0 = self.submit_t

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t

    def remaining(self, now: float) -> Optional[float]:
        if self.deadline_t is None:
            return None
        return self.deadline_t - now

    def result(self) -> List[int]:
        if not self.done:
            raise RuntimeError(f"request {self.id} still running")
        return list(self.output)


class FleetRouter:
    """Route requests over a fleet of :class:`ServingReplica` handles,
    balancing and degrading purely on their published telemetry.
    Constructor knobs default to the ``router_*`` config entries
    (``MXNET_TPU_ROUTER_*``); pass ``clock=`` to share the drill's fake
    clock with the replicas and the health thresholds."""

    def __init__(self, fleet_dir: str,
                 health: Optional[_health.FleetHealth] = None,
                 queue_bound: Optional[int] = None,
                 classes: Optional[Sequence[str]] = None,
                 affinity: Optional[bool] = None,
                 prefix_tokens: Optional[int] = None,
                 seed: Optional[int] = None, clock=None, tracer=None):
        from .. import config

        self.fleet_dir = os.path.abspath(fleet_dir)
        self._clock = clock or time.time
        #: owner-side request tracer (None unless the ``trace`` knob is
        #: on or an explicit Tracer is passed — drills pass sample=1.0)
        self.tracer = tracer if tracer is not None else _tracing.maybe_tracer(
            os.path.join(self.fleet_dir, "router", "spans-g0.jsonl"),
            source="router", owner=True, clock=self._clock)
        self.health = health or _health.FleetHealth()
        self.queue_bound = int(queue_bound if queue_bound is not None
                               else config.get("router_queue_bound"))
        raw = classes if classes is not None \
            else config.get("router_classes").split(",")
        self.classes = [c.strip() for c in raw if c.strip()]
        if not self.classes:
            raise ValueError("router needs at least one priority class")
        self.affinity = bool(affinity if affinity is not None
                             else config.get("router_affinity"))
        self.prefix_tokens = int(prefix_tokens if prefix_tokens is not None
                                 else config.get("router_prefix_tokens"))
        self._rng = random.Random(int(seed if seed is not None
                                      else config.get("router_seed")))
        self.replicas: Dict[int, ServingReplica] = {}
        self._backlog: Dict[str, deque] = {c: deque() for c in self.classes}
        self._sessions: Dict[str, int] = {}
        #: (replica_id, gen_request_id) -> RouterRequest, in-flight only
        self._assigned: Dict[Tuple[int, int], RouterRequest] = {}
        self._ids = itertools.count()
        self.requests: List[RouterRequest] = []

    # -- fleet membership ----------------------------------------------------
    def attach(self, replica: ServingReplica) -> None:
        """Add a replica to the routable fleet (also how a replacement
        for a drained replica joins — under a NEW id; dead ids are
        terminal in health and never reused)."""
        rid = replica.replica_id
        if rid in self.replicas:
            raise ValueError(f"replica {rid} already attached")
        if self.health.state(rid) == _health.DEAD:
            raise ValueError(f"replica id {rid} is dead; replacements "
                             "join under a fresh id")
        self.replicas[rid] = replica
        self.health.register(rid, self._clock())

    # -- client side ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               priority: Optional[str] = None, session: Optional[str] = None,
               deadline_s: Optional[float] = None) -> RouterRequest:
        """Admit one request into the router backlog. ``priority`` must
        be a configured class (default: the last = lowest); dispatch to
        a replica happens at the next ``step()``."""
        cls = priority if priority is not None else self.classes[-1]
        if cls not in self._backlog:
            raise ValueError(f"unknown priority class {cls!r} "
                             f"(configured: {self.classes})")
        req = RouterRequest(next(self._ids), prompt, max_new_tokens, cls,
                            session, deadline_s, self._clock())
        if (session is None and self.affinity and self.prefix_tokens > 0
                and len(req.prompt) >= self.prefix_tokens):
            head = ",".join(str(int(t))
                            for t in req.prompt[:self.prefix_tokens])
            req.affinity_key = f"prefix:{zlib.crc32(head.encode()):08x}"
        self.requests.append(req)
        self._backlog[cls].append(req)
        _obs.counter("router_requests_total",
                     "requests admitted into the router backlog").inc(
                         priority=cls)
        self._gauges()
        return req

    @property
    def backlog(self) -> int:
        return sum(len(q) for q in self._backlog.values())

    @property
    def in_flight(self) -> int:
        return len(self._assigned)

    @property
    def idle(self) -> bool:
        return self.backlog == 0 and self.in_flight == 0

    def assignments(self) -> Dict[int, int]:
        """In-flight attempt count per replica (router's own records —
        used by drills and reporting, not by placement, which runs on
        published telemetry only)."""
        out: Dict[int, int] = {}
        for rid, _gid in self._assigned:
            out[rid] = out.get(rid, 0) + 1
        return out

    def _gauges(self) -> None:
        _obs.gauge("router_backlog_depth",
                   "requests waiting in the router for a replica").set(
                       self.backlog)

    # -- scheduling tick -----------------------------------------------------
    def step(self) -> List[dict]:
        """One scheduling tick (see module docstring); returns the
        health transitions it applied."""
        now = self._clock()
        views = read_fleet_views(self.fleet_dir)
        transitions = self.health.evaluate(now, views)
        for tr in transitions:
            rid = tr["replica"]
            if tr["to"] in (_health.DEGRADED, _health.DRAINING,
                            _health.DEAD):
                self._drop_affinity(rid)
            if tr["to"] == _health.DRAINING:
                rep = self.replicas.get(rid)
                if rep is not None:
                    for gr in rep.begin_drain():
                        self._pull_back(rid, gr, "drain", now)
            elif tr["to"] == _health.DEAD:
                self._on_dead(rid, now)
        self._harvest(now)
        self._expire_backlog(now)
        self._dispatch(now, views)
        self._gauges()
        return transitions

    def _drop_affinity(self, rid: int) -> None:
        for sess in [s for s, r in self._sessions.items() if r == rid]:
            del self._sessions[sess]

    def _on_dead(self, rid: int, now: float) -> None:
        rep = self.replicas.pop(rid, None)
        if rep is not None:
            for gr in rep.abandon():
                self._pull_back(rid, gr, "replica_dead", now)
        # attempts the handle no longer accounts for (e.g. a replica
        # detached before its abandon) still re-enqueue from the
        # router's own records — the request must never be lost
        for key, rreq in [(k, v) for k, v in self._assigned.items()
                          if k[0] == rid]:
            del self._assigned[key]
            self._requeue(rreq, rid, "replica_dead", now)

    def _pull_back(self, rid: int, gen_req, cause: str, now: float) -> None:
        rreq = self._assigned.pop((rid, gen_req.id), None)
        if rreq is None:
            return
        self._requeue(rreq, rid, cause, now)

    def _requeue(self, rreq: RouterRequest, rid: int, cause: str,
                 now: float) -> None:
        """Re-enqueue a pulled-back attempt at the FRONT of its class
        (it has already waited); a request past its deadline finishes
        ``"deadline"`` instead — redistribution never extends a
        deadline."""
        rreq.current = None
        if rreq.done:
            return
        if self.tracer is not None:
            # close the attempt at the pull-back boundary — this span is
            # what keeps a killed replica's residency gap-free (the dead
            # replica's own span file may never have flushed)
            self.tracer.span(str(rreq.id), "router.attempt",
                             rreq.phase_t0, now, replica=rid,
                             outcome=cause)
            rreq.phase_t0 = now
        if rreq.expired(now):
            self._finish(rreq, "deadline", [], now)
            return
        rreq.redistributions += 1
        _obs.counter("router_redistributions_total",
                     "requests pulled back from a replica and "
                     "re-enqueued").inc(replica=str(rid), cause=cause)
        if self.tracer is not None:
            self.tracer.span(str(rreq.id), "redistribution", now, now,
                             replica=rid, cause=cause,
                             hop=rreq.redistributions)
        self._backlog[rreq.priority].appendleft(rreq)

    def _finish(self, rreq: RouterRequest, reason: str, output,
                now: float) -> None:
        rreq.finish_reason = reason
        rreq.output = list(output)
        rreq.finish_t = now
        _obs.counter("router_completions_total",
                     "router requests completed, by finish reason").inc(
                         reason=reason)
        if self.tracer is not None:
            # the owner verdict: tail sampling decides the span flush
            # here, and the SLO ledger folds exactly these records
            self.tracer.finish(str(rreq.id), reason, rreq.submit_t, now,
                               cls=rreq.priority,
                               deadline=rreq.deadline_t,
                               hops=rreq.redistributions,
                               tokens=len(rreq.output),
                               session=rreq.session)

    def _harvest(self, now: float) -> None:
        for key, rreq in list(self._assigned.items()):
            rid, _ = key
            gr = rreq.current[1] if rreq.current else None
            if gr is None or gr.finish_reason is None:
                continue
            del self._assigned[key]
            if gr.finish_reason == "redistributed":
                # withdrawn outside the drain/dead paths (defensive):
                # same re-enqueue contract
                self._requeue(rreq, rid, "withdrawn", now)
            elif gr.finish_reason == "shed":
                # shed mid-flight by replica overload control: the work
                # is intact in the router, try another replica while the
                # deadline holds
                self._requeue(rreq, rid, "replica_shed", now)
            else:
                if self.tracer is not None:
                    self.tracer.span(str(rreq.id), "router.attempt",
                                     rreq.phase_t0, now, replica=rid,
                                     outcome=gr.finish_reason)
                    rreq.phase_t0 = now
                self._finish(rreq, gr.finish_reason, gr.output, now)

    def _expire_backlog(self, now: float) -> None:
        for cls, q in self._backlog.items():
            keep: deque = deque()
            for rreq in q:
                if rreq.expired(now):
                    if self.tracer is not None:
                        self.tracer.span(str(rreq.id), "router.backlog",
                                         rreq.phase_t0, now, cls=cls,
                                         outcome="deadline")
                        rreq.phase_t0 = now
                    self._finish(rreq, "deadline", [], now)
                else:
                    keep.append(rreq)
            self._backlog[cls] = keep

    # -- placement -----------------------------------------------------------
    @staticmethod
    def _score(view: dict, added: int) -> float:
        return (float(view.get("free_pages", 0.0))
                - (float(view.get("queue_depth", 0.0)) + added)
                - float(view.get("queue_age_p95", 0.0)))

    def _pick(self, rreq: RouterRequest, candidates: List[int],
              views: Dict[int, dict], added: Dict[int, int]
              ) -> Optional[int]:
        if self.affinity and rreq.affinity_key is not None:
            rid = self._sessions.get(rreq.affinity_key)
            if rid is not None and rid in candidates:
                return rid  # prefix pages live here; affinity wins
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        sa = self._score(views.get(a, {}), added.get(a, 0))
        sb = self._score(views.get(b, {}), added.get(b, 0))
        if sa == sb:
            return min(a, b)
        return a if sa > sb else b

    def _dispatch(self, now: float, views: Dict[int, dict]) -> None:
        #: submissions placed THIS tick, folded into the published depth
        #: so one tick can't bury a replica the snapshot said was idle
        added: Dict[int, int] = {}
        blocked: set = set()

        def candidates():
            out = []
            for rid in self.health.live():
                if rid not in self.replicas or rid in blocked:
                    continue
                depth = float(views.get(rid, {}).get("queue_depth", 0.0)) \
                    + added.get(rid, 0)
                if self.queue_bound > 0 and depth > self.queue_bound:
                    continue
                out.append(rid)
            return out

        for cls in self.classes:
            q = self._backlog[cls]
            while q:
                cand = candidates()
                rid = self._pick(q[0], cand, views, added)
                if rid is None:
                    break  # nothing routable; the class waits
                rreq = q[0]
                gr = self.replicas[rid].submit(
                    rreq.prompt, max_new_tokens=rreq.max_new_tokens,
                    deadline_s=rreq.remaining(now),
                    trace_id=str(rreq.id) if self.tracer is not None
                    else None)
                if gr.done:  # shed at the replica's door
                    blocked.add(rid)
                    continue
                q.popleft()
                rreq.current = (rid, gr)
                rreq.replicas_tried.append(rid)
                self._assigned[(rid, gr.id)] = rreq
                added[rid] = added.get(rid, 0) + 1
                if self.tracer is not None:
                    tid = str(rreq.id)
                    self.tracer.span(tid, "router.backlog", rreq.phase_t0,
                                     now, cls=cls, outcome="placed")
                    self.tracer.span(tid, "router.place", now, now,
                                     replica=rid,
                                     attempt=len(rreq.replicas_tried))
                    rreq.phase_t0 = now
                _obs.counter("router_admissions_total",
                             "requests handed to a replica").inc(
                                 replica=str(rid))
                if self.affinity and rreq.affinity_key is not None:
                    self._sessions[rreq.affinity_key] = rid

    # -- telemetry -----------------------------------------------------------
    def publish(self, generation: int = 0) -> bool:
        """Snapshot this process's ``router_*`` metric series into
        ``{fleet_dir}/router/metrics-g{gen}.json`` (atomic), the router
        half of the fleet-report contract. Best-effort like every other
        telemetry write."""
        from ..observability import REGISTRY

        snap = {k: v for k, v in REGISTRY.snapshot().items()
                if k.startswith("router_")}
        payload = {"meta": {"generation": int(generation),
                            "pid": os.getpid(),
                            "ts": round(float(self._clock()), 6)},
                   "metrics": snap}
        d = os.path.join(self.fleet_dir, "router")
        try:
            os.makedirs(d, exist_ok=True)
            _fleet._atomic_write(
                os.path.join(d, f"metrics-g{int(generation)}.json"),
                json.dumps(payload))
            return True
        except OSError:
            return False

"""One serving replica: a ContinuousBatcher behind a replica id, publishing
its health signals through the fleet shared-dir transport. A copy of
``mxnet_tpu/serving/replica.py`` over the port's batcher.

The router never inspects a batcher directly — it balances and degrades
on what each replica *published* into
``{fleet_dir}/telemetry-h{replica}/metrics-g{gen}.json`` (the
FleetSnapshotter contract of ``observability.fleet``: atomic tmp +
``os.replace`` writes, generation-numbered files, torn files skipped by
every reader). That keeps the in-process drill honest
— a replica that stops publishing looks exactly like a dead process —
and makes the tier deploy unchanged across real processes.

Published series (registry snapshot format, so :class:`FleetAggregator`
folds them without special cases):

  - ``replica_free_pages``          free KV pages in this engine's pool
  - ``replica_queue_depth``         requests waiting for a slot
  - ``replica_active_slots``        rows currently decoding
  - ``replica_queue_age_p95``       p95 age of the *live* queue (s)
  - ``replica_admissions_total``    requests that reached a slot here
  - ``replica_redistributions_total`` requests pulled back for re-routing
  - ``replica_stuck_dispatches_total`` watchdog stalls attributed here

plus the liveness heartbeat: ``meta.ts`` of the newest valid snapshot —
a replica that misses its publish cadence goes stale there and fleet
health degrades it.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from ..inference.batcher import ContinuousBatcher, GenRequest
from ..observability import fleet as _fleet
from ..observability import tracing as _tracing

__all__ = ["ServingReplica", "read_fleet_views"]

_RANK_DIR = re.compile(r"telemetry-h(\d+)$")


class ServingReplica:
    """One replica of the serving fleet.

    Wraps an existing :class:`ContinuousBatcher` (the engine stays
    untouched — this tier is policy, not execution), attributes its
    dispatch watchdog to ``replica_id``, and publishes a telemetry
    snapshot after every step so the router always balances on signals
    at most one step old. ``clock`` drives the heartbeat timestamp —
    pass the drill's fake clock for deterministic staleness arithmetic.
    """

    def __init__(self, replica_id: int, batcher: ContinuousBatcher,
                 fleet_dir: str, generation: int = 0, clock=None,
                 tracer=None):
        import time

        self.replica_id = int(replica_id)
        self.batcher = batcher
        self.engine = batcher.engine
        self.generation = int(generation)
        self._clock = clock or time.time
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.directory = os.path.join(self.fleet_dir,
                                      f"telemetry-h{self.replica_id}")
        os.makedirs(self.directory, exist_ok=True)
        # stalls carry the replica id from here on: fleet health
        # attributes gen_stuck_dispatch without guessing
        batcher.watchdog.replica = self.replica_id
        # request tracing: attach the replica-side span emitter to the
        # batcher; a finishing trace whose deadline margin dips below
        # trace_margin_floor drops a prof-request trigger so this
        # replica's next step gets a measured capture
        if tracer is None:
            tracer = _tracing.maybe_tracer(
                os.path.join(self.directory,
                             f"spans-g{self.generation}.jsonl"),
                source=f"h{self.replica_id}", owner=False,
                clock=self._clock, capture_cb=self._slow_capture)
        elif tracer.capture_cb is None:
            tracer.capture_cb = self._slow_capture
        self.tracer = tracer
        if tracer is not None:
            batcher.tracer = tracer
        #: every request routed here, for admission/redistribution counts
        self.requests: List[GenRequest] = []

    def _slow_capture(self, trace_id: str, margin: float) -> None:
        """A request finished with less deadline margin than
        ``trace_margin_floor``: request a measured-profile capture on
        THIS replica via the ``prof-request-h{rid}.json`` trigger the
        step-capture controller consumes (one pending request per
        replica; best-effort, like the straggler trigger it
        complements)."""
        from ..observability import profiling as _profiling

        path = _profiling.request_path(self.fleet_dir, self.replica_id)
        if os.path.exists(path):
            return  # a capture request is already pending here
        try:
            _fleet._atomic_write(path, json.dumps({
                "reason": "slow_request", "kind": "deadline_margin",
                "trace": str(trace_id), "margin": round(float(margin), 6),
                "replica": self.replica_id,
                "ts": round(float(self._clock()), 6)}))
        except OSError:
            pass  # advisory telemetry: never fail the serving loop

    # -- request side (called by the router) ---------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> GenRequest:
        req = self.batcher.submit(prompt, max_new_tokens=max_new_tokens,
                                  deadline_s=deadline_s, trace_id=trace_id)
        self.requests.append(req)
        return req

    @property
    def admissions(self) -> int:
        return sum(r.slot is not None for r in self.requests)

    @property
    def redistributions(self) -> int:
        return sum(r.finish_reason == "redistributed" for r in self.requests)

    # -- serving loop --------------------------------------------------------
    def step(self) -> bool:
        """One batcher step + one telemetry publish. The publish is the
        heartbeat: a replica whose loop wedges between boundaries stops
        calling this and goes stale in the fleet dir."""
        alive = self.batcher.step()
        self.publish()
        return alive

    def begin_drain(self) -> List[GenRequest]:
        """Enter drain mode and pull back every queued request
        (finish reason ``"redistributed"``); in-flight rows keep
        decoding until they finish or expire. Returns the withdrawn
        handles for the router to re-enqueue."""
        self.batcher.begin_drain()
        out = self.batcher.withdraw_queued()
        self.publish()
        return out

    def abandon(self) -> List[GenRequest]:
        """Declare the replica lost: every live request (queued and
        in-flight) finishes ``"redistributed"``, bookkeeping only — see
        :meth:`ContinuousBatcher.abandon`. No publish: a dead replica
        writes nothing."""
        return self.batcher.abandon()

    @property
    def drained(self) -> bool:
        return self.batcher.active == 0 and self.batcher.pending == 0

    # -- telemetry publish ---------------------------------------------------
    def _series(self) -> Dict[str, dict]:
        bat, eng = self.batcher, self.engine
        now = self._clock()
        vals = {
            "replica_free_pages": float(getattr(eng, "free_pages", 0)),
            "replica_queue_depth": float(bat.pending),
            "replica_active_slots": float(bat.active),
            "replica_queue_age_p95": float(bat.queue_age_p95(now)),
            "replica_admissions_total": float(self.admissions),
            "replica_redistributions_total": float(self.redistributions),
            "replica_stuck_dispatches_total": float(bat.watchdog.stalls),
        }
        kind = {"replica_admissions_total": "counter",
                "replica_redistributions_total": "counter",
                "replica_stuck_dispatches_total": "counter"}
        return {name: {"kind": kind.get(name, "gauge"),
                       "help": "fleet-replica health signal", "unit": "",
                       "series": [{"labels": {}, "value": v}]}
                for name, v in vals.items()}

    def publish(self) -> bool:
        """Write one snapshot (atomic); True when it landed. Failures
        never propagate — an unpublishable replica simply goes stale and
        fleet health handles it like any other missed heartbeat."""
        payload = {
            "meta": {"rank": self.replica_id, "replica": self.replica_id,
                     "generation": self.generation, "pid": os.getpid(),
                     "ts": round(float(self._clock()), 6)},
            "metrics": self._series(),
        }
        try:
            _fleet._atomic_write(
                os.path.join(self.directory,
                             f"metrics-g{self.generation}.json"),
                json.dumps(payload))
            return True
        except OSError:
            return False


def read_fleet_views(fleet_dir: str) -> Dict[int, dict]:
    """The router's eyes: per replica, the newest *parseable* published
    snapshot flattened to ``{ts, free_pages, queue_depth, active_slots,
    queue_age_p95, admissions, redistributions, stuck_dispatches,
    generation}``.

    Walks that replica's generation files newest-first and takes the
    first one that parses — a writer killed mid-write (torn newest file,
    already only possible for non-atomic writers) falls back to the
    previous valid snapshot, whose *older* heartbeat correctly reads as
    staleness instead of resurrecting the replica with garbage."""
    views: Dict[int, dict] = {}
    import glob

    for d in sorted(glob.glob(os.path.join(os.path.abspath(fleet_dir),
                                           "telemetry-h*"))):
        m = _RANK_DIR.search(d)
        if not m or not os.path.isdir(d):
            continue
        rid = int(m.group(1))
        for path in reversed(_fleet._gen_sorted(
                glob.glob(os.path.join(d, "metrics-g*.json")))):
            try:
                with open(path) as f:
                    snap = json.load(f)
                metrics = snap["metrics"]
                meta = snap.get("meta", {})
                if not isinstance(metrics, dict):
                    raise TypeError(type(metrics).__name__)
            except (OSError, ValueError, KeyError, TypeError):
                continue  # torn: try the previous generation

            def val(name, default=0.0):
                m_ = metrics.get(name)
                series = m_.get("series") if isinstance(m_, dict) else None
                if not series:
                    return default
                try:
                    return float(series[0]["value"])
                except (KeyError, TypeError, ValueError, IndexError):
                    return default

            views[rid] = {
                "replica": rid,
                "ts": meta.get("ts"),
                "generation": _fleet._file_gen(path),
                "free_pages": val("replica_free_pages"),
                "queue_depth": val("replica_queue_depth"),
                "active_slots": val("replica_active_slots"),
                "queue_age_p95": val("replica_queue_age_p95"),
                "admissions": val("replica_admissions_total"),
                "redistributions": val("replica_redistributions_total"),
                "stuck_dispatches": val("replica_stuck_dispatches_total"),
            }
            break
    return views

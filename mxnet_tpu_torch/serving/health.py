"""Replica health state machine: LIVE -> DEGRADED -> DRAINING -> DEAD,
a copy of ``mxnet_tpu/serving/health.py``.

Decisions run entirely on *published* evidence — heartbeat timestamps
and the stuck-dispatch counter from each replica's fleet-dir snapshot —
never on in-process peeking, so the same policy holds when replicas are
real processes:

  - ``LIVE``      routable. Degrades when the heartbeat goes stale past
                  ``router_hb_timeout`` (missed publishes: dead process,
                  stalled loop, partitioned FS) or when the replica's
                  ``gen_stuck_dispatch`` attribution count grows (a
                  dispatch wedged past the watchdog budget — the loop
                  may still heartbeat around it).
  - ``DEGRADED``  unroutable but recoverable: a fresh heartbeat with no
                  new stalls returns it to LIVE (a transient FS hiccup
                  must not cost a drain). Degraded past
                  ``router_drain_after`` -> DRAINING.
  - ``DRAINING``  no new admissions; the router pulls the queued work
                  back (finish reason ``"redistributed"``) and in-flight
                  rows finish or expire. Drained-empty — or out of
                  ``router_dead_grace`` — -> DEAD. One-way: a draining
                  replica is being replaced, not nursed.
  - ``DEAD``      terminal; the router re-enqueues its in-deadline work
                  and detaches it. A late snapshot from a dead replica
                  never resurrects it (split-brain guard: its successor
                  may already own the traffic).

Transitions emit ``replica_degraded`` / ``replica_recovered`` /
``replica_drain`` / ``replica_dead`` events and keep the
``router_replica_state`` gauge (coded live=0 degraded=1 draining=2
dead=3) current, so ``tools/torch_fleetreport.py`` can render the
fleet's state column from snapshots alone.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .. import observability as _obs

__all__ = ["FleetHealth", "ReplicaHealth", "LIVE", "DEGRADED", "DRAINING",
           "DEAD", "STATE_CODES", "STATE_NAMES"]

LIVE, DEGRADED, DRAINING, DEAD = "live", "degraded", "draining", "dead"
STATE_CODES = {LIVE: 0, DEGRADED: 1, DRAINING: 2, DEAD: 3}
STATE_NAMES = {v: k for k, v in STATE_CODES.items()}


class ReplicaHealth:
    """One replica's health record (owned by :class:`FleetHealth`)."""

    def __init__(self, replica: int, now: float):
        self.replica = int(replica)
        self.state = LIVE
        #: when the current state was entered (router clock)
        self.since = float(now)
        #: registration time — a replica that has never published gets
        #: its staleness measured from here, not from epoch
        self.first_seen = float(now)
        self.last_hb: Optional[float] = None
        self.stuck_seen = 0.0
        self.degrade_cause: Optional[str] = None
        self.transitions: List[dict] = []

    def heartbeat_age(self, now: float) -> float:
        anchor = self.last_hb if self.last_hb is not None else self.first_seen
        return max(0.0, now - anchor)


class FleetHealth:
    """Evaluate every replica's published evidence into state
    transitions. ``evaluate(now, views)`` is the single decision point —
    the router calls it each scheduling tick and applies the side
    effects (drain, redistribute, detach) for each returned transition
    dict ``{replica, from, to, cause, ts}``."""

    def __init__(self, hb_timeout: Optional[float] = None,
                 drain_after: Optional[float] = None,
                 dead_grace: Optional[float] = None):
        from .. import config

        self.hb_timeout = float(hb_timeout if hb_timeout is not None
                                else config.get("router_hb_timeout"))
        self.drain_after = float(drain_after if drain_after is not None
                                 else config.get("router_drain_after"))
        self.dead_grace = float(dead_grace if dead_grace is not None
                                else config.get("router_dead_grace"))
        self.records: Dict[int, ReplicaHealth] = {}

    # -- bookkeeping ---------------------------------------------------------
    def register(self, replica: int, now: float) -> ReplicaHealth:
        rec = self.records.get(int(replica))
        if rec is None:
            rec = ReplicaHealth(int(replica), now)
            self.records[int(replica)] = rec
            self._state_gauge(rec)
        return rec

    def state(self, replica: int) -> Optional[str]:
        rec = self.records.get(int(replica))
        return rec.state if rec else None

    def live(self) -> List[int]:
        return sorted(r for r, rec in self.records.items()
                      if rec.state == LIVE)

    def _state_gauge(self, rec: ReplicaHealth) -> None:
        _obs.gauge("router_replica_state",
                   "fleet-health state per replica (live=0 degraded=1 "
                   "draining=2 dead=3)").set(STATE_CODES[rec.state],
                                             replica=str(rec.replica))

    def _move(self, rec: ReplicaHealth, to: str, cause: str,
              now: float) -> dict:
        tr = {"replica": rec.replica, "from": rec.state, "to": to,
              "cause": cause, "ts": now}
        rec.transitions.append(tr)
        rec.state = to
        rec.since = now
        self._state_gauge(rec)
        event = {DEGRADED: "replica_degraded", LIVE: "replica_recovered",
                 DRAINING: "replica_drain", DEAD: "replica_dead"}[to]
        _obs.counter("router_replica_transitions_total",
                     "fleet-health state transitions").inc(to=to)
        _obs.emit(event, replica=rec.replica, cause=cause,
                  was=tr["from"], at=now)
        return tr

    # -- the decision point --------------------------------------------------
    def evaluate(self, now: float,
                 views: Dict[int, Optional[dict]]) -> List[dict]:
        """Fold the latest published views into state transitions.
        ``views`` maps replica id -> flattened snapshot (or None when
        the replica has never published); replicas the router knows but
        the views miss are judged purely on heartbeat staleness."""
        out: List[dict] = []
        for rid in sorted(set(self.records) | set(views)):
            rec = self.register(rid, now)
            view = views.get(rid)
            if rec.state == DEAD:
                continue  # terminal: late snapshots never resurrect
            new_stalls = 0.0
            if view is not None:
                ts = view.get("ts")
                if isinstance(ts, (int, float)):
                    rec.last_hb = max(rec.last_hb or float(ts), float(ts))
                stuck = float(view.get("stuck_dispatches") or 0.0)
                new_stalls = stuck - rec.stuck_seen
                rec.stuck_seen = max(rec.stuck_seen, stuck)
            stale = rec.heartbeat_age(now) > self.hb_timeout
            if rec.state == LIVE:
                if new_stalls > 0:
                    rec.degrade_cause = "stuck_dispatch"
                    out.append(self._move(rec, DEGRADED, "stuck_dispatch",
                                          now))
                elif stale:
                    rec.degrade_cause = "heartbeat"
                    out.append(self._move(rec, DEGRADED, "heartbeat", now))
            elif rec.state == DEGRADED:
                if now - rec.since > self.drain_after:
                    out.append(self._move(rec, DRAINING,
                                          rec.degrade_cause or "degraded",
                                          now))
                elif not stale and new_stalls <= 0 \
                        and rec.degrade_cause == "heartbeat":
                    # the transient healed before the drain deadline; a
                    # stuck dispatch never self-heals (the wedged program
                    # still owns the card) so only heartbeat causes
                    # recover
                    rec.degrade_cause = None
                    out.append(self._move(rec, LIVE, "heartbeat_recovered",
                                          now))
            elif rec.state == DRAINING:
                drained = (view is not None
                           and view.get("active_slots", 1.0) == 0.0
                           and view.get("queue_depth", 1.0) == 0.0)
                if drained:
                    out.append(self._move(rec, DEAD, "drained", now))
                elif now - rec.since > self.dead_grace:
                    out.append(self._move(rec, DEAD, "drain_grace_expired",
                                          now))
        return out

"""Multi-replica serving tier: telemetry-driven routing, health-gated
drain/replace. The port's counterpart of ``mxnet_tpu/serving``, plain
Python over the port's :class:`~mxnet_tpu_torch.inference.ContinuousBatcher`.

Every serving-resilience mechanism below this layer (deadlines, shed,
watchdog, degrade-to-safe speculation) protects exactly one engine; a wedged replica is still a total outage for every
request routed at it. This package is the thin policy tier over
*unmodified* engines (the TVM/Relay deploy-tier split: routing policy
stays declarative above the compiled engines, never inside them):

  - :class:`ServingReplica` (``replica.py``) — wraps one
    :class:`~mxnet_tpu_torch.inference.ContinuousBatcher` behind a replica id
    and publishes its health signals (free pages, admission-queue depth,
    live queue-age p95, stuck-dispatch count) plus a liveness heartbeat
    through the FleetSnapshotter shared-dir transport
    (``{fleet_dir}/telemetry-h{replica}/metrics-g{gen}.json``) — the
    router trusts only what a replica *published*, exactly what a
    multi-process deployment would see.
  - :class:`FleetRouter` (``router.py``) — admits by priority class,
    load-balances with power-of-two-choices over a free-pages/queue-age
    score computed from the published telemetry, keeps session affinity
    (multi-turn traffic lands on the replica holding its prefix pages),
    and re-enqueues in-deadline requests pulled back from a draining or
    lost replica.
  - :class:`FleetHealth` (``health.py``) — per-replica state machine
    ``LIVE -> DEGRADED -> DRAINING -> DEAD``: missed heartbeats or a
    ``gen_stuck_dispatch`` attribution degrade a replica; a persistently
    degraded replica is drained (no new admissions, in-flight finish or
    expire, queued work redistributed) and finally declared dead.

``tools/torch_servedrill.py --fleet`` is the tier-level gate: one replica
killed and one wedged mid-burst must lose zero in-deadline requests,
walk the wedged replica through DEGRADED→DRAINING→DEAD with its work
redistributed, and leave the survivors fully drained with explicit finish
reasons everywhere.
"""
from __future__ import annotations

from . import health, replica, router  # noqa: F401
from .health import (DEAD, DEGRADED, DRAINING, LIVE,  # noqa: F401
                     STATE_CODES, STATE_NAMES, FleetHealth, ReplicaHealth)
from .replica import ServingReplica, read_fleet_views  # noqa: F401
from .router import FleetRouter, RouterRequest  # noqa: F401

__all__ = ["ServingReplica", "read_fleet_views", "FleetRouter",
           "RouterRequest", "FleetHealth", "ReplicaHealth",
           "LIVE", "DEGRADED", "DRAINING", "DEAD",
           "STATE_CODES", "STATE_NAMES", "replica", "router", "health"]

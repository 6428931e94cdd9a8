"""Cross-rank fleet telemetry: snapshot, aggregate, detect stragglers.
A copy of ``mxnet_tpu/observability/fleet.py`` (which imports nothing of
JAX): a fleet directory written by either package reads the same in the
other's :class:`FleetAggregator`.

Two halves over one shared directory:

  - :class:`FleetSnapshotter` (worker side) — periodically snapshots this
    rank's metrics registry and event log into
    ``{fleet_dir}/telemetry-h{rank}/`` as ``metrics-g{gen}.json``
    (atomic: tmp + ``os.replace``) + ``events-g{gen}.jsonl``
    (append-only incremental copy — only the delta since the last
    snapshot moves across the shared FS). Failures never propagate into
    the step loop; a rank that dies mid-write leaves at worst a stale
    metrics snapshot or a torn final event line, which the JSONL reader
    already skips.

  - :class:`FleetAggregator` (rank-0 / supervisor side) — merges every
    rank's snapshots (all generations) into one :class:`FleetReport`:
    per-rank step-time and collective-wait distributions, comm bytes,
    queue depths, serving rollups (TTFT / decode-rate percentiles, slot
    utilization), the serving replicas' self-reports and the router's
    rollup, the SLO ledger of the request traces, the goodput ledger
    (``observability.goodput``), and straggler detection — a rank whose
    per-step time or collective-wait exceeds the fleet median by
    ``straggler_factor`` (``MXNET_TPU_STRAGGLER_FACTOR``) is flagged with
    a ``straggler`` event, a ``fleet_step_skew_seconds`` observation, the
    ``straggler_rank`` gauge and a ``prof-request-h{rank}.json`` capture
    trigger. Torn or unparseable snapshot files are skipped and counted
    (``fleet_torn_snapshots_total``), never fatal.

``tools/torch_fleetreport.py`` renders the report.
"""
from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import logging
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import events as _events
from . import metrics as _metrics
from . import tracing as _tracing
from .goodput import GoodputReport, goodput_ledger

__all__ = ["FleetSnapshotter", "FleetAggregator", "FleetReport",
           "RankStats", "ensure_snapshotter", "snapshotter",
           "shutdown_snapshotter", "detect_stragglers"]

logger = logging.getLogger("mxnet_tpu_torch.observability.fleet")

_RANK_DIR = re.compile(r"telemetry-h(\d+)$")
_GEN_FILE = re.compile(r"-g(\d+)\.(json|jsonl)(\.gz)?$")


def _atomic_write(path: str, data: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def _file_gen(path: str) -> int:
    m = _GEN_FILE.search(path)
    return int(m.group(1)) if m else 0


def _gen_sorted(paths) -> List[str]:
    """Snapshot files ordered by their parsed generation NUMBER —
    lexicographic order would put g10 before g2, making "latest wins"
    gauge folds read a stale generation on long preemption-heavy runs."""
    return sorted(paths, key=lambda p: (_file_gen(p), p))


class FleetSnapshotter:
    """Periodic per-rank telemetry snapshots into the shared fleet dir.

    ``start()`` runs the writer from a daemon thread (heartbeat-style);
    ``maybe_snapshot()`` is the step-boundary variant the elastic context
    calls — throttled to ``interval``, so its hot-path cost is one clock
    read and a compare. Every write path swallows OSError: telemetry must
    never fail the training loop.
    """

    def __init__(self, directory: str, rank: Optional[int] = None,
                 generation: Optional[int] = None,
                 interval: Optional[float] = None):
        from .. import config

        self.rank = int(os.environ.get("MXNET_TPU_PROCID", "0")) \
            if rank is None else int(rank)
        self.generation = int(os.environ.get("MXNET_TPU_GENERATION", "0")) \
            if generation is None else int(generation)
        self.interval = float(interval if interval is not None
                              else config.get("fleet_snapshot_interval"))
        self.directory = os.path.join(
            os.path.abspath(directory), f"telemetry-h{self.rank}")
        os.makedirs(self.directory, exist_ok=True)
        self._last = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._warned = False
        # incremental event copy: bytes of the LIVE event-log file already
        # appended to this generation's events file (a full re-copy per
        # tick would move O(run length) bytes across the shared FS)
        self._copied = 0
        self._seeded_rotation = False
        # highest rotation index already drained — rotation is detected
        # by the sequence advancing, never by the live file's size (a
        # fresh live file can outgrow the old offset between two ticks,
        # which a shrink check would read as "no rotation")
        self._last_seq = 0

    def snapshot(self) -> bool:
        """Write one snapshot now (atomic); True when it landed."""
        with self._lock:
            self._last = time.time()
            try:
                self._write()
                return True
            except OSError as e:
                if not self._warned:
                    logger.warning("fleet snapshot failed: %s", e)
                    self._warned = True
                return False

    def _write(self) -> None:
        g = self.generation
        payload = {
            "meta": {"rank": self.rank, "generation": g, "pid": os.getpid(),
                     "run": _events.LOG.run_id,
                     "ts": round(time.time(), 6)},
            "metrics": _metrics.REGISTRY.snapshot(),
        }
        _atomic_write(os.path.join(self.directory, f"metrics-g{g}.json"),
                      json.dumps(payload))
        self._copy_events(g)

    def _copy_events(self, g: int) -> None:
        """Append the event log's NEW bytes to ``events-g{g}.jsonl``.

        Incremental: only the delta since the last snapshot moves across
        the shared filesystem. The destination is append-only JSONL — a
        rank dying mid-append can tear at most the final line, which the
        JSONL reader already skips. Rotation of the source is detected by
        the live file shrinking: the remainder of the old live file is
        recovered from its newest rotated segment (gzip-compressed since
        the ``events_keep_bytes`` rework — decompressed transparently)
        before restarting at 0."""
        src = _events.LOG.path
        if not src:
            return
        dst = os.path.join(self.directory, f"events-g{g}.jsonl")
        segs = _events.rotated_segments(src)
        max_seq = _events.segment_seq(src, segs[-1]) if segs else 0
        if not self._seeded_rotation:
            self._seeded_rotation = True
            # this instance owns the (rank, generation) file: truncate any
            # previous instance's copy (a re-enabled process would
            # otherwise re-append the whole log), then seed with whatever
            # rotated out before the snapshotter armed
            try:
                open(dst, "wb").close()
            except OSError:
                return
            for seg in segs:
                self._append_range(seg, 0, dst)
            self._last_seq = max_seq
        elif max_seq > self._last_seq:
            # the live file rotated under us (possibly more than once):
            # the remainder of what we were copying sits at offset
            # ``_copied`` of the segment that WAS the live file (seq ==
            # last_seq + 1); every later new segment copies whole. A
            # swept segment (events_keep_bytes retention outran the
            # snapshot cadence) is gone — the survivors copy from 0
            for seg in segs:
                seq = _events.segment_seq(src, seg)
                if seq <= self._last_seq:
                    continue
                self._append_range(
                    seg, self._copied if seq == self._last_seq + 1 else 0,
                    dst)
            self._copied = 0
            self._last_seq = max_seq
        try:
            size = os.path.getsize(src)
        except OSError:
            return
        if size > self._copied:
            self._copied += self._append_range(src, self._copied, dst)

    @staticmethod
    def _append_range(src: Optional[str], offset: int, dst: str) -> int:
        """Append ``src[offset:]`` to ``dst`` (offsets are uncompressed
        positions; a ``.gz`` source is decompressed on the way through);
        bytes copied (0 on any miss — a swept source is a skipped copy,
        never an error). A plain rotated segment can vanish BETWEEN the
        directory listing and the open: the background compressor
        atomically replaces it with ``<seg>.gz`` and unlinks the plain
        file. Its bytes still exist, just under the other name — retry
        the ``.gz`` twin (complete by construction: it only becomes
        visible via ``os.replace``) so the race loses zero events."""
        if not src:
            return 0
        for attempt in ((src, src + ".gz") if not src.endswith(".gz")
                        else (src,)):
            try:
                opener = gzip.open if attempt.endswith(".gz") else open
                with opener(attempt, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
                if chunk:
                    with open(dst, "ab") as out:
                        out.write(chunk)
                return len(chunk)
            except FileNotFoundError:
                continue
            except (OSError, EOFError):
                return 0
        return 0

    def maybe_snapshot(self) -> bool:
        """Step-boundary throttle: snapshot when ``interval`` has elapsed
        since the last one (one clock read + compare otherwise)."""
        if time.time() - self._last < self.interval:
            return False
        return self.snapshot()

    def start(self) -> "FleetSnapshotter":
        if self._thread is not None:
            return self
        self.snapshot()

        def _loop():
            while not self._stop.wait(self.interval):
                self.snapshot()

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="fleet-snapshot")
        self._thread.start()
        return self

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1.0)
            self._thread = None
        if final:
            self.snapshot()


_snapshotter: Optional[FleetSnapshotter] = None
_snap_lock = threading.Lock()


def ensure_snapshotter(directory: Optional[str] = None
                       ) -> Optional[FleetSnapshotter]:
    """Process-wide snapshotter, armed once from the ``fleet_dir`` config
    knob (``MXNET_TPU_FLEET_DIR``, exported by the elastic supervisor).
    Returns None when no fleet directory is configured."""
    global _snapshotter
    from .. import config

    d = directory or config.get("fleet_dir")
    if not d:
        return None
    with _snap_lock:
        if _snapshotter is None:
            try:
                _snapshotter = FleetSnapshotter(d).start()
            except OSError as e:
                logger.warning("fleet snapshotter not started: %s", e)
                return None
        return _snapshotter


def snapshotter() -> Optional[FleetSnapshotter]:
    return _snapshotter


def shutdown_snapshotter() -> None:
    """Final snapshot + stop (idempotent; called from ``obs.shutdown``)."""
    global _snapshotter
    with _snap_lock:
        if _snapshotter is not None:
            _snapshotter.stop(final=True)
            _snapshotter = None


# -- aggregation -------------------------------------------------------------
def _hist_acc():
    return {"count": 0, "sum": 0.0, "min": None, "max": None,
            "edges": None, "buckets": None}


def _merge_hist(acc: dict, val: dict) -> None:
    """Fold one snapshot histogram-series value into an accumulator
    (bucket-exact when edges agree — the default-bucket case)."""
    acc["count"] += int(val.get("count", 0))
    acc["sum"] += float(val.get("sum", 0.0))
    for k, pick in (("min", min), ("max", max)):
        v = val.get(k)
        if v is not None:
            acc[k] = v if acc[k] is None else pick(acc[k], v)
    b = val.get("buckets")
    if not isinstance(b, dict):
        return
    edges = list(b.keys())
    counts = [int(v) for v in b.values()]
    if acc["edges"] is None:
        acc["edges"], acc["buckets"] = edges, counts
    elif acc["buckets"] is not None and acc["edges"] == edges:
        acc["buckets"] = [a + c for a, c in zip(acc["buckets"], counts)]
    else:  # mismatched bucket layouts: keep count/sum, drop percentiles
        acc["buckets"] = None


def _hist_pct(acc: dict, q: float) -> Optional[float]:
    if acc["buckets"] is None or not acc["count"]:
        return None
    edges = []
    for e in acc["edges"]:
        try:
            v = float(e)
        except ValueError:
            continue
        # the "+Inf" overflow edge parses to inf — it must NOT become a
        # finite edge, or a quantile landing in the overflow bucket would
        # read as Infinity instead of the observed max
        if math.isfinite(v):
            edges.append(v)
    return _metrics.series_percentile(
        {"count": acc["count"], "max": acc["max"], "buckets": acc["buckets"]},
        edges, q)


def _hist_summary(acc: dict) -> dict:
    return {"count": acc["count"], "sum": round(acc["sum"], 6),
            "mean": round(acc["sum"] / acc["count"], 6) if acc["count"] else None,
            "min": acc["min"], "max": acc["max"],
            "p50": _hist_pct(acc, 0.5), "p95": _hist_pct(acc, 0.95),
            "p99": _hist_pct(acc, 0.99)}


@dataclasses.dataclass
class RankStats:
    """One rank's merged telemetry (summed across its generations)."""

    rank: int
    generations: List[int] = dataclasses.field(default_factory=list)
    step_hist: dict = dataclasses.field(default_factory=_hist_acc)
    wait_hist: dict = dataclasses.field(default_factory=_hist_acc)
    comm_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    queue_depths: Dict[str, float] = dataclasses.field(default_factory=dict)
    tokens_per_sec: Optional[float] = None
    flops_per_step: Optional[float] = None
    mfu: Optional[float] = None
    # the schedule auditor's static bound + exposed-comm share
    # (train_mfu_bound / train_comm_exposed_share gauges, set by
    # TrainStep.audit once analysis/* is ported)
    mfu_bound: Optional[float] = None
    comm_exposed_share: Optional[float] = None
    last_ts: Optional[float] = None
    # serving-replica self-report (serving.replica publishes
    # replica_* series through the same rank-dir transport; None for a
    # training rank)
    replica: Optional[dict] = None

    def summary(self) -> dict:
        return {"rank": self.rank, "generations": sorted(self.generations),
                "step_seconds": _hist_summary(self.step_hist),
                "collective_wait_seconds": _hist_summary(self.wait_hist),
                "comm_bytes": {k: int(v)
                               for k, v in sorted(self.comm_bytes.items())},
                "queue_depths": dict(self.queue_depths),
                "tokens_per_sec": self.tokens_per_sec,
                "flops_per_step": self.flops_per_step, "mfu": self.mfu,
                "mfu_bound": self.mfu_bound,
                "comm_exposed_share": self.comm_exposed_share,
                "replica": self.replica,
                "last_ts": self.last_ts}


@dataclasses.dataclass
class FleetReport:
    """One merged view over every rank's snapshots (all generations)."""

    directory: str
    ranks: Dict[int, RankStats]
    generations: List[int]
    events: List[dict]  # merged, each tagged with _rank/_gen
    stragglers: List[dict]
    skew_timeline: List[dict]
    goodput: Optional[GoodputReport]
    serving: dict
    torn_snapshots: int
    # newest measured-profile snapshot per rank (profile.json written by
    # a periodic or straggler-triggered step capture)
    profiles: Dict[int, dict] = dataclasses.field(default_factory=dict)
    # router-tier rollup ({fleet_dir}/router/ snapshots written by
    # serving.FleetRouter.publish): per-replica state /
    # admissions / redistributions, request and completion counts
    router: dict = dataclasses.field(default_factory=dict)
    # SLO attainment ledger folded from the router's trace "end"
    # verdict records (observability.tracing.slo_ledger): per-priority-
    # class attainment fraction, deadline-margin percentiles and
    # multi-window burn rates
    slo: dict = dataclasses.field(default_factory=dict)
    # request-trace census over the span JSONL files (counts only; the
    # full waterfall view is tools/torch_tracereport.py)
    traces: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "directory": self.directory,
            "ranks": {str(r): s.summary()
                      for r, s in sorted(self.ranks.items())},
            "generations": self.generations,
            "n_events": len(self.events),
            "stragglers": list(self.stragglers),
            "skew_timeline": list(self.skew_timeline),
            "goodput": self.goodput.summary() if self.goodput else None,
            "serving": dict(self.serving),
            "torn_snapshots": self.torn_snapshots,
            "profiles": {str(r): p for r, p
                         in sorted(self.profiles.items())},
            "router": dict(self.router),
            "slo": dict(self.slo),
            "traces": dict(self.traces),
        }


def detect_stragglers(events: List[dict], factor: float,
                      min_seconds: float = 0.001
                      ) -> Tuple[List[dict], List[dict]]:
    """Cross-rank skew from merged per-step timings: for every (gen, step)
    reported by >= 2 ranks, a rank whose ``step_seconds`` exceeds the
    fleet median by ``factor`` (and by ``min_seconds`` absolute, so
    microsecond noise never flags) is a straggler. Returns
    ``(stragglers, skew_timeline)``."""
    by_step: Dict[Tuple[int, int], Dict[int, float]] = {}
    for e in events:
        if e.get("event") != "train_step":
            continue
        r, g = e.get("_rank"), e.get("_gen", 0)
        s, dt = e.get("step"), e.get("step_seconds")
        if r is None or not isinstance(dt, (int, float)) \
                or not isinstance(s, int):
            continue
        # a rank may replay a step after a restore: keep the slowest
        cur = by_step.setdefault((g, s), {})
        cur[r] = max(cur.get(r, 0.0), float(dt))
    stragglers: List[dict] = []
    timeline: List[dict] = []
    for (g, s), per_rank in sorted(by_step.items()):
        if len(per_rank) < 2:
            continue
        vals = sorted(per_rank.values())
        n = len(vals)
        median = vals[n // 2] if n % 2 else (vals[n // 2 - 1]
                                             + vals[n // 2]) / 2
        worst_rank = max(per_rank, key=per_rank.get)
        worst = per_rank[worst_rank]
        skew = worst - median
        timeline.append({"generation": g, "step": s,
                         "skew_seconds": round(skew, 6),
                         "median_seconds": round(median, 6),
                         "slowest_rank": worst_rank})
        for r, v in sorted(per_rank.items()):
            if v > max(factor * median, median + min_seconds):
                stragglers.append({
                    "kind": "step", "generation": g, "step": s, "rank": r,
                    "seconds": round(v, 6),
                    "median_seconds": round(median, 6),
                    "ratio": round(v / median, 3) if median > 0 else None})
    return stragglers, timeline


def _wait_stragglers(ranks: Dict[int, RankStats], factor: float,
                     min_seconds: float = 0.001) -> List[dict]:
    """Collective-wait skew: a rank whose mean DCN collective latency
    exceeds the fleet median-of-means by ``factor`` is being held up —
    the complementary signal to step-time skew (the rank every OTHER rank
    waits for shows a *small* wait and a big step time)."""
    means = {r: s.wait_hist["sum"] / s.wait_hist["count"]
             for r, s in ranks.items() if s.wait_hist["count"]}
    if len(means) < 2:
        return []
    vals = sorted(means.values())
    n = len(vals)
    median = vals[n // 2] if n % 2 else (vals[n // 2 - 1] + vals[n // 2]) / 2
    out = []
    for r, v in sorted(means.items()):
        if v > max(factor * median, median + min_seconds):
            out.append({"kind": "collective_wait", "rank": r,
                        "seconds": round(v, 6),
                        "median_seconds": round(median, 6),
                        "ratio": round(v / median, 3) if median > 0 else None})
    return out


class _ServingAcc:
    """Fleet-wide serving rollup: TTFT / decode-rate percentiles merged
    from every rank's exported histogram buckets (single-rank consumers
    read the pre-computed p50/p95/p99; a cross-rank merge is the one case
    that needs the raw buckets), plus slot utilization and completion
    counts."""

    def __init__(self):
        self.accs = {"ttft_seconds": _hist_acc(),
                     "decode_tokens_per_s": _hist_acc()}
        self.util: List[float] = []
        self.requests: Dict[str, int] = {}

    def fold(self, metrics: dict) -> None:
        def series(name):
            m = metrics.get(name)
            return m.get("series", []) if isinstance(m, dict) else []

        for name, acc in self.accs.items():
            for s in series(name):
                _merge_hist(acc, s["value"])
        for s in series("gen_slot_utilization"):
            self.util.append(float(s["value"]))
        for s in series("gen_requests_total"):
            reason = s["labels"].get("reason", "?")
            self.requests[reason] = self.requests.get(reason, 0) \
                + int(s["value"])

    def summary(self) -> dict:
        out: dict = {}
        for name, acc in self.accs.items():
            if acc["count"]:
                out[name] = _hist_summary(acc)
        if self.util:
            out["slot_utilization"] = round(sum(self.util) / len(self.util), 4)
        if self.requests:
            out["requests"] = dict(self.requests)
        return out


#: router_replica_state gauge codes (serving.health
#: STATE_CODES, duplicated here so observability never imports the
#: serving tier)
_REPLICA_STATES = {0: "live", 1: "degraded", 2: "draining", 3: "dead"}

#: replica self-report series -> RankStats.replica keys
_REPLICA_SERIES = (("replica_free_pages", "free_pages"),
                   ("replica_queue_depth", "queue_depth"),
                   ("replica_active_slots", "active_slots"),
                   ("replica_queue_age_p95", "queue_age_p95"),
                   ("replica_admissions_total", "admissions"),
                   ("replica_redistributions_total", "redistributions"),
                   ("replica_stuck_dispatches_total", "stuck_dispatches"))


class _RouterAcc:
    """Router-tier rollup from ``{fleet_dir}/router/`` snapshots: the
    fleet-health state, admission and redistribution counts per replica
    plus the router's request/completion tallies. Counter series are
    cumulative within the router process, so "latest generation wins"
    per exact label set is the correct fold (summing snapshot files
    would double count)."""

    def __init__(self):
        self.replicas: Dict[str, dict] = {}
        self.requests: Dict[str, int] = {}
        self.completions: Dict[str, int] = {}
        self.redistributions: Dict[str, Dict[str, int]] = {}

    def _rep(self, labels) -> dict:
        return self.replicas.setdefault(labels.get("replica", "?"), {})

    def fold(self, metrics: dict) -> None:
        def series(name):
            m = metrics.get(name)
            return m.get("series", []) if isinstance(m, dict) else []

        for s in series("router_replica_state"):
            code = int(s["value"])
            self._rep(s["labels"])["state"] = _REPLICA_STATES.get(
                code, str(code))
        for s in series("router_admissions_total"):
            self._rep(s["labels"])["admissions"] = int(s["value"])
        for s in series("router_redistributions_total"):
            rid = s["labels"].get("replica", "?")
            cause = s["labels"].get("cause", "?")
            self.redistributions.setdefault(rid, {})[cause] = int(s["value"])
        for s in series("router_requests_total"):
            self.requests[s["labels"].get("priority", "?")] = int(s["value"])
        for s in series("router_completions_total"):
            self.completions[s["labels"].get("reason", "?")] = int(s["value"])

    def summary(self) -> dict:
        if not (self.replicas or self.requests or self.completions):
            return {}
        reps = {}
        for rid, rec in self.replicas.items():
            by_cause = self.redistributions.get(rid, {})
            reps[rid] = dict(rec, redistributions=sum(by_cause.values()),
                             redistributions_by_cause=dict(by_cause))
        for rid, by_cause in self.redistributions.items():
            if rid not in reps:  # redistributions off an already-gone id
                reps[rid] = {"redistributions": sum(by_cause.values()),
                             "redistributions_by_cause": dict(by_cause)}
        return {"replicas": reps, "requests": dict(self.requests),
                "completions": dict(self.completions)}


class FleetAggregator:
    """Merge every rank's fleet-dir snapshots into a :class:`FleetReport`.

    ``collect()`` is pure (parse + merge + detect, no telemetry writes);
    ``poll()`` additionally emits only the *new* findings since the last
    poll into this process's registry/event log — the supervisor calls it
    on a cadence without double counting.
    """

    def __init__(self, directory: str,
                 straggler_factor: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        from .. import config

        self.directory = os.path.abspath(directory)
        self.factor = float(straggler_factor if straggler_factor is not None
                            else config.get("straggler_factor"))
        self.peak_flops = float(peak_flops if peak_flops is not None
                                else config.get("peak_flops"))
        self._seen: set = set()
        self._torn_seen: set = set()

    # -- parsing -------------------------------------------------------------
    def _rank_dirs(self) -> List[Tuple[int, str]]:
        out = []
        for p in sorted(glob.glob(os.path.join(self.directory,
                                               "telemetry-h*"))):
            m = _RANK_DIR.search(p)
            if m and os.path.isdir(p):
                out.append((int(m.group(1)), p))
        return out

    def collect(self) -> Optional[FleetReport]:
        """Parse + merge every rank's snapshots (pure: no telemetry
        emission — that is ``poll()``'s job). None when the directory
        holds no rank telemetry at all."""
        rank_dirs = self._rank_dirs()
        ranks: Dict[int, RankStats] = {}
        events: List[dict] = []
        torn: List[str] = []
        gens: set = set()
        serving = _ServingAcc()
        for rank, d in rank_dirs:
            stats = ranks.setdefault(rank, RankStats(rank))
            for path in _gen_sorted(glob.glob(
                    os.path.join(d, "metrics-g*.json"))):
                g = _file_gen(path)
                try:
                    with open(path) as f:
                        snap = json.load(f)
                    metrics = snap["metrics"]
                    meta = snap.get("meta", {})
                    if not isinstance(metrics, dict):
                        raise TypeError(type(metrics).__name__)
                except (OSError, ValueError, KeyError, TypeError):
                    torn.append(path)  # torn/corrupt: skip, count, go on
                    continue
                gens.add(g)
                stats.generations.append(g)
                self._fold_metrics(stats, metrics, meta)
                serving.fold(metrics)
            for path in _gen_sorted(
                    glob.glob(os.path.join(d, "events-g*.jsonl"))
                    + glob.glob(os.path.join(d, "events-g*.jsonl.gz"))):
                g = _file_gen(path)
                for rec in _events.read_events(path):
                    rec["_rank"], rec["_gen"] = rank, g
                    events.append(rec)
                gens.add(g)
        router = _RouterAcc()
        for path in _gen_sorted(glob.glob(
                os.path.join(self.directory, "router", "metrics-g*.json"))):
            try:
                with open(path) as f:
                    snap = json.load(f)
                metrics = snap["metrics"]
                if not isinstance(metrics, dict):
                    raise TypeError(type(metrics).__name__)
            except (OSError, ValueError, KeyError, TypeError):
                torn.append(path)  # same skip-count-go-on contract
                continue
            router.fold(metrics)
        profiles = self._collect_profiles(rank_dirs)
        slo, trace_census = self._collect_traces()
        self._last_torn = list(torn)
        if not events and not torn and not router.summary() \
                and not trace_census \
                and not any(s.generations for s in ranks.values()):
            return None
        events.sort(key=lambda e: e.get("ts") or 0.0)
        stragglers, timeline = detect_stragglers(events, self.factor)
        stragglers += _wait_stragglers(ranks, self.factor)
        ledger = goodput_ledger(events)
        return FleetReport(
            directory=self.directory, ranks=ranks,
            generations=sorted(gens), events=events, stragglers=stragglers,
            skew_timeline=timeline, goodput=ledger,
            serving=serving.summary(), torn_snapshots=len(torn),
            profiles=profiles, router=router.summary(),
            slo=slo, traces=trace_census)

    def _collect_traces(self) -> Tuple[dict, dict]:
        """Join the span JSONL files (router + every replica) by trace
        id and fold the owner ``end`` verdicts into the SLO ledger.
        Returns ``(slo, census)`` — both empty when no trace records
        exist (tracing off, or no serving traffic)."""
        records = _tracing.collect_records(self.directory)
        if not records:
            return {}, {}
        assembled = _tracing.assemble(records)
        ends = [t["end"] for t in assembled.values()
                if t["end"] is not None]
        kept = sum(1 for e in ends if e.get("keep"))
        census = {
            "records": len(records),
            "traces": len(assembled),
            "ends": len(ends),
            "kept": kept,
            "dropped": len(ends) - kept,
            # spans whose trace never got an owner end record: in-flight
            # work at snapshot time, or (the drill's red path) a span
            # that lost its request
            "orphans": sum(1 for t in assembled.values()
                           if t["end"] is None and t["spans"]),
        }
        return _tracing.slo_ledger(ends), census

    @staticmethod
    def _collect_profiles(rank_dirs) -> Dict[int, dict]:
        """Newest ``prof-*/profile.json`` per rank — the measured hot-op
        snapshot a periodic or straggler-triggered capture wrote into the
        shared dir (torn files skipped, like every other snapshot)."""
        from .profiling import latest_profile

        out: Dict[int, dict] = {}
        for rank, d in rank_dirs:
            p = latest_profile(d)
            if p is not None:
                out[rank] = p
        return out

    def _fold_metrics(self, stats: RankStats, metrics: dict,
                      meta: dict) -> None:
        def series(name):
            m = metrics.get(name)
            return m.get("series", []) if isinstance(m, dict) else []

        for s in series("train_step_seconds"):
            _merge_hist(stats.step_hist, s["value"])
        for s in series("kv_psum_seconds"):
            _merge_hist(stats.wait_hist, s["value"])
        for s in series("kv_psum_bytes_total"):
            op = s["labels"].get("op", "?")
            stats.comm_bytes[op] = stats.comm_bytes.get(op, 0.0) \
                + float(s["value"])
        for name, key in (("prefetch_queue_depth", "prefetch"),
                          ("gen_queue_depth", "gen")):
            for s in series(name):
                stats.queue_depths[key] = float(s["value"])
        for name, attr in (("train_tokens_per_sec", "tokens_per_sec"),
                           ("train_model_flops_per_step", "flops_per_step"),
                           ("train_mfu", "mfu"),
                           ("train_mfu_bound", "mfu_bound"),
                           ("train_comm_exposed_share",
                            "comm_exposed_share")):
            for s in series(name):
                setattr(stats, attr, float(s["value"]))
        for name, key in _REPLICA_SERIES:
            for s in series(name):
                if stats.replica is None:
                    stats.replica = {}
                stats.replica[key] = float(s["value"])
        ts = meta.get("ts")
        if isinstance(ts, (int, float)):
            stats.last_ts = max(stats.last_ts or ts, ts)

    # -- incremental emission (supervisor cadence) ----------------------------
    def poll(self) -> Tuple[Optional[FleetReport], List[dict]]:
        """collect() + emit only findings not seen by a previous poll:
        new ``straggler`` events, their ``fleet_step_skew_seconds``
        observations, the ``straggler_rank`` gauge, and the
        ``fleet_torn_snapshots_total`` counter. Each NEW straggler also
        gets a capture request dropped into the shared dir
        (``prof-request-h{rank}.json``) so the flagged rank traces its
        next step and snapshots the measured timeline back into
        ``telemetry-h{rank}/``. Returns ``(report, new_stragglers)``."""
        report = self.collect()
        for p in getattr(self, "_last_torn", []):
            if p not in self._torn_seen:
                self._torn_seen.add(p)
                _metrics.REGISTRY.counter(
                    "fleet_torn_snapshots_total",
                    "unreadable per-rank telemetry snapshots skipped by "
                    "the fleet aggregator").inc()
        if report is None:
            return None, []
        new = []
        for s in report.stragglers:
            key = (s["kind"], s.get("generation"), s.get("step"), s["rank"])
            if key in self._seen:
                continue
            self._seen.add(key)
            new.append(s)
            _metrics.REGISTRY.gauge(
                "straggler_rank",
                "most recently flagged straggler rank").set(s["rank"])
            _events.LOG.emit("straggler", **s)
            self._request_capture(s)
        for t in report.skew_timeline:
            key = ("skew", t["generation"], t["step"])
            if key in self._seen:
                continue
            self._seen.add(key)
            _metrics.REGISTRY.histogram(
                "fleet_step_skew_seconds",
                "per-step cross-rank skew (slowest - median)",
                unit="s").observe(t["skew_seconds"])
        return report, new

    def _request_capture(self, finding: dict) -> None:
        """Drop the trigger file the flagged rank's step-capture
        controller consumes (best-effort, one pending request per rank —
        the request, the capture and the snapshot are all advisory
        telemetry and must never fail the poll)."""
        from .profiling import request_path

        path = request_path(self.directory, finding["rank"])
        if os.path.exists(path):
            return  # a request is already pending for this rank
        try:
            _atomic_write(path, json.dumps({
                "reason": "straggler", "kind": finding["kind"],
                "generation": finding.get("generation"),
                "step": finding.get("step"),
                "ratio": finding.get("ratio"),
                "ts": round(time.time(), 6)}))
        except OSError as e:
            logger.warning("capture request for rank %s not written: %s",
                           finding["rank"], e)

"""Profiler: MXNet's control surface (``set_config`` /
``set_state('run'|'stop')`` / ``dump`` / ``dumps``, ``scope``) over
``torch.profiler``. The port's counterpart of ``mxnet_tpu/profiler.py``.

A ``run``/``stop`` pair is one ``torch.profiler`` session (the host and,
where there is a card, its kernels through CUPTI); ``stop`` exports its
Chrome trace into a new session directory under the configured dump
directory (``plugins/profile/<timestamp>/trace.pt.trace.json``), which
Perfetto or ``chrome://tracing`` opens and
:func:`mxnet_tpu_torch.observability.profiling.parse_trace` reads.
``scope()`` aggregates live in the metrics registry
(``profiler_scope_seconds``), as in the JAX package.
"""
from __future__ import annotations

import logging
import os
import threading
from contextlib import contextmanager

__all__ = ["set_config", "set_state", "dump", "dumps", "pause", "resume",
           "scope", "Profiler"]

logger = logging.getLogger("mxnet_tpu_torch.profiler")

#: ``dir`` empty = the ``profiler_dir`` knob (else ``mxnet_tpu_profile``
#: under the temporary directory), resolved at the first start
_state = {"running": False, "dir": "", "ever_ran": False, "prof": None}
# set_state/pause/resume may be driven from a monitor thread while the step
# loop reads `running`: serialize the start/stop transitions
_state_lock = threading.RLock()

# scope() aggregates live in the observability metrics registry; this is
# the metric name dumps() reads and reset clears
_SCOPE_METRIC = "profiler_scope_seconds"


def _dir() -> str:
    if not _state["dir"]:
        from .observability.profiling import _default_dir

        _state["dir"] = _default_dir()  # lint: disable=JH005 -- the same value from any thread
    return _state["dir"]


def set_config(filename=None, profile_all=False, profile_symbolic=True,
               profile_imperative=True, profile_memory=True, profile_api=True,
               aggregate_stats=False, **kwargs):
    with _state_lock:
        if filename:
            _state["dir"] = os.path.dirname(os.path.abspath(filename)) or "."
        _state["aggregate_stats"] = aggregate_stats


def set_state(state="stop", profile_process="worker"):
    """Start/stop the trace session. A second ``set_state("run")`` is a
    no-op. A session some other code holds open (``capture()``, a step
    capture, a caller's ``torch.profiler``) is not taken over: ``run``
    then marks the profiler running without a session of its own, with a
    warning, and the matching ``stop`` writes nothing."""
    import torch

    from .observability import profiling as _profiling

    if state == "run":
        with _state_lock:
            if _state["running"]:
                return
            prof = None
            if _profiling.trace_active():
                logger.warning("a trace session is already open in this "
                               "process; set_state('run') records nothing")
            else:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            _state["prof"] = prof
            _state["running"] = True
            _state["ever_ran"] = True
    elif state == "stop":
        with _state_lock:
            if not _state["running"]:
                return
            prof, _state["prof"] = _state["prof"], None
            _state["running"] = False
            if prof is not None:
                _profiling._stop(prof, _dir())


def pause(profile_process="worker"):
    set_state("stop")


def resume(profile_process="worker"):
    set_state("run")


def dump(finished=True, profile_process="worker"):
    """Finish the active session and return the trace directory — or None
    when no trace was ever started."""
    if _state["running"]:
        set_state("stop")
    return _dir() if _state["ever_ran"] else None


def _aggregate(dump_dir):
    """Per-(plane, op) stats of the newest session's trace (MXNet's
    ``AggregateStats`` table): one row per device per op, so that timings
    of the host and of the card never merge into one average."""
    from .observability import profiling

    stats = {}  # (plane, name) -> [count, total_ns, min_ns, max_ns]
    # only the LATEST session directory (parse_trace picks it): earlier
    # sessions in the same dump dir are not counted again
    timeline = profiling.parse_trace(dump_dir)
    for plane in timeline.planes:
        pname = plane.name or ""
        if not ("TPU" in pname or "GPU" in pname or "CPU" in pname
                or "Host" in pname or "python" in pname.lower()):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = ev.name
                dur = ev.dur_ns
                if not name or dur <= 0:
                    continue
                # python-tracer stack frames are not ops
                if name.startswith(("$", "<frozen")) or ".py:" in name:
                    continue
                rec = stats.setdefault((pname, name),
                                       [0, 0, float("inf"), 0])
                rec[0] += 1
                rec[1] += dur
                rec[2] = min(rec[2], dur)
                rec[3] = max(rec[3], dur)
    return stats


def dumps(reset=False):
    """Aggregate per-op stat table (MXNet's ``AggregateStats::DumpTable``):
    the trace's rows from the last dumped session with the ``scope()``
    aggregates. Columns: Name, Total Count, Time total/avg/min/max (ms)."""
    from .observability import REGISTRY

    header = (f"{'Name':<48} {'Count':>8} {'Total(ms)':>12} {'Avg(ms)':>10} "
              f"{'Min(ms)':>10} {'Max(ms)':>10}")
    lines = ["Profile Statistics", header, "-" * len(header)]
    xstats = _aggregate(_dir())
    planes = sorted({p for p, _n in xstats})
    plane_totals = {}
    rows = []
    for (plane, name), (count, total_ns, mn, mx) in xstats.items():
        # one row per (plane, op): the plane tag keeps the host's and the
        # card's timings apart (single-plane dumps stay unadorned)
        shown = name if len(planes) <= 1 \
            else f"{name} [{plane.split('/')[-1].replace('device:', '')}]"
        rows.append((shown, count, total_ns / 1e6, total_ns / 1e6 / count,
                     mn / 1e6, mx / 1e6))
        plane_totals[plane] = plane_totals.get(plane, 0.0) + total_ns / 1e6
    hist = REGISTRY.get(_SCOPE_METRIC)
    if hist is not None:
        for labels, s in hist.series():
            if not s["count"]:
                continue
            t_ms = s["sum"] * 1e3
            rows.append((f"scope:{labels.get('scope', '?')}", s["count"], t_ms,
                         t_ms / s["count"], s["min"] * 1e3, s["max"] * 1e3))
    rows.sort(key=lambda r: -r[2])
    for name, count, tot, avg, mn, mx in rows:
        lines.append(f"{name[:48]:<48} {count:>8} {tot:>12.3f} {avg:>10.3f} "
                     f"{mn:>10.3f} {mx:>10.3f}")
    if len(plane_totals) > 1:
        lines.append("Per-device totals")
        for plane, tot in sorted(plane_totals.items()):
            lines.append(f"{plane[:48]:<48} {'':>8} {tot:>12.3f}")
    if reset:
        REGISTRY.reset(_SCOPE_METRIC)
    return "\n".join(lines)


@contextmanager
def scope(name="<unk>:"):
    from .observability import timed_region

    with timed_region(_SCOPE_METRIC, "profiler.scope() region wall-clock",
                      name, scope=name):
        yield


annotate = scope


class Profiler:
    """Context-manager convenience: ``set_state('run')`` on entry,
    ``set_state('stop')`` on exit."""

    def __init__(self, output_dir=None):
        if output_dir:
            set_config(filename=os.path.join(output_dir, "profile.json"))

    def __enter__(self):
        set_state("run")
        return self

    def __exit__(self, *exc):
        set_state("stop")

"""Telemetry of the port: the counterpart of ``mxnet_tpu/observability``.

  - ``metrics``  — process-wide registry of counters / gauges / histograms
                   with labels; Prometheus-textfile + JSON exporters;
  - ``events``   — structured JSONL event log (one writer, run-id / host /
                   step envelope, size rotation);
  - ``span``     — times a region into the ``span_seconds`` histogram AND
                   opens ``torch.profiler.record_function`` under the same
                   name, so wall-clock metrics and profiler rows correlate.

The switch: hot-path instrumentation (the engine's per-step histograms) is
gated on :func:`enabled`, a single module-global bool read. Low-frequency
sites (retry attempts, the batcher's request counters, the serving
governor and watchdog) always record into the registry: their counters
must be trustworthy even when nobody asked for full telemetry.

Enable via ``MXNET_TPU_TELEMETRY=1`` (+ ``MXNET_TPU_TELEMETRY_DIR``) or::

    from mxnet_tpu_torch import observability as obs
    obs.enable(run_dir)             # events-h0.jsonl + metrics.json on exit
    ...serve...
    obs.shutdown()                  # flush metrics.json / metrics.prom

The fleet view (``fleet``: per-rank snapshots into ``fleet_dir`` and their
aggregation), the goodput ledger (``goodput``), request tracing and the SLO
ledger (``tracing``) and measured profiling (``profiling``) sit beside
them, as in the JAX package.
"""
from __future__ import annotations

import atexit
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Optional

from . import events  # noqa: F401
from . import goodput  # noqa: F401
from . import metrics  # noqa: F401
from .events import emit, read_events, set_step  # noqa: F401
from .metrics import REGISTRY, counter, gauge, histogram  # noqa: F401
from . import profiling  # noqa: F401  (imports events/metrics above)
from . import fleet  # noqa: F401  (imports events/metrics/goodput/profiling)
from . import tracing  # noqa: F401  (imports metrics above)

__all__ = ["metrics", "events", "REGISTRY", "counter", "gauge", "histogram",
           "emit", "set_step", "read_events", "enabled", "enable", "disable",
           "shutdown", "span", "timed_region", "telemetry_dir",
           "throughput_delta", "fleet", "goodput", "profiling", "tracing"]


def throughput_delta(prev):
    """samples/sec from the registry's step telemetry since ``prev``.

    The one throughput calculation the console reporters share
    (``callback.Speedometer``, the estimator's ``LoggingHandler``), so they
    agree with each other and with the exporters. Returns ``(speed,
    state)``: pass ``state`` back as ``prev`` on the next call; ``speed``
    is None until two calls bracket new step telemetry."""
    c = REGISTRY.get("train_samples_total")
    h = REGISTRY.get("train_step_seconds")
    if c is None or h is None:
        return None, prev
    cur = (c.total(), h.total_sum())
    if prev is None:
        return None, cur
    ds, dt = cur[0] - prev[0], cur[1] - prev[1]
    return (ds / dt if ds > 0 and dt > 0 else None), cur

_enabled: Optional[bool] = None  # tri-state: None = not yet resolved from config
_dir: Optional[str] = None
_atexit_registered = False


def enabled() -> bool:
    """Fast gate for hot-path instrumentation (one global read after the
    first call resolves the ``MXNET_TPU_TELEMETRY`` config knob)."""
    global _enabled
    if _enabled is None:
        from .. import config

        if config.get("telemetry"):
            enable()
        else:
            _enabled = False
    return _enabled


def telemetry_dir() -> Optional[str]:
    return _dir


def enable(directory: Optional[str] = None, run_id: Optional[str] = None) -> str:
    """Turn telemetry on: open the per-host event log under ``directory``
    (default: the ``telemetry_dir`` config knob, else a new directory of
    this process's own under ``tempfile.gettempdir()``) and arrange for
    ``metrics.json`` / ``metrics.prom`` to be written at :func:`shutdown`
    (also registered atexit). Returns the run directory."""
    global _enabled, _dir, _atexit_registered
    from .. import config

    directory = directory or config.get("telemetry_dir")
    _dir = os.path.abspath(directory or tempfile.mkdtemp(
        prefix="mxnet_tpu_telemetry-"))
    os.makedirs(_dir, exist_ok=True)
    host = events._host_index()
    events.LOG.configure(
        os.path.join(_dir, f"events-h{host}.jsonl"), run_id=run_id,
        rotate_bytes=config.get("telemetry_rotate_mb") * 1024 * 1024,
        keep_bytes=config.get("events_keep_bytes"))
    _enabled = True
    if not _atexit_registered:
        atexit.register(shutdown)
        _atexit_registered = True
    events.emit("telemetry_enabled", dir=_dir)
    # fleet view: when a shared fleet directory is configured
    # (MXNET_TPU_FLEET_DIR), start the per-rank snapshot writer alongside
    # telemetry
    fleet.ensure_snapshotter()
    return _dir


def disable() -> None:
    """Turn the hot-path gate off and close the event log (registry content
    is kept — counters survive an enable/disable cycle)."""
    global _enabled
    _enabled = False
    events.LOG.close()


def shutdown() -> None:
    """Flush exporters into the run directory and close the event log.
    Idempotent; registered atexit by :func:`enable`."""
    if _dir is None:
        return
    # final fleet snapshot BEFORE the event log closes (the snapshot
    # copies the event files; a clean exit must land its tail)
    fleet.shutdown_snapshotter()
    host = events._host_index()
    suffix = f"-h{host}" if host else ""
    try:
        REGISTRY.write_json(os.path.join(_dir, f"metrics{suffix}.json"))
        REGISTRY.write_prometheus(os.path.join(_dir, f"metrics{suffix}.prom"))
    except OSError:
        pass
    events.LOG.close()


@contextmanager
def timed_region(metric_name: str, help: str, name: str, **labels):
    """Always-on core of :func:`span`: time a region into
    ``metric_name``'s histogram under a ``torch.profiler.record_function``
    of the same name. Exception-safe — the sample records even when the
    body raises."""
    import torch

    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            histogram(metric_name, help,
                      unit="s").observe(time.perf_counter() - t0, **labels)


@contextmanager
def span(name: str, **labels):
    """Time a region into ``span_seconds{span=name,...}`` and annotate the
    profiler trace with the same name, so a slow span found in metrics can
    be located in the timeline (and vice versa). No-op (one bool check)
    when telemetry is off."""
    if not enabled():
        yield
        return
    with timed_region("span_seconds", "obs.span region wall-clock", name,
                      span=name, **labels):
        yield

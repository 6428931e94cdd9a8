"""Process-wide metrics registry: counters, gauges, histograms with labels.

A copy of ``mxnet_tpu/observability/metrics.py`` (which imports nothing of
JAX), so that the two registries give the same ``snapshot()`` and the same
Prometheus text for the same operations. The registry is the single source
of numeric truth for a run: the serving engine and batcher (``gen_*``,
``ttft_*``), the retry layer and the serving governor and watchdog record
here, and every consumer (the Prometheus textfile and JSON exporters, the
tests, ``chip_smoke.py``) reads the same numbers.

Design constraints:

  - *cheap*: one dict lookup + float add per record; a ``threading.Lock``
    guards mutation (the dispatch watchdog's timer thread records from
    outside the serving loop);
  - *labelled*: every series is keyed by a sorted tuple of ``(k, v)`` label
    pairs, Prometheus-style, so ``kv_psum_seconds{op="psum_batch"}`` and
    ``{op="psum"}`` are separate series of one metric;
  - *exportable*: ``snapshot()`` is plain data (JSON-safe), and
    ``to_prometheus()`` emits the textfile-collector format, which is why
    metric names use underscores, never dots.

Histograms use fixed log-spaced latency buckets by default (5e-4s .. 60s)
and additionally track per-series min/max/sum/count, so the profiler's
exporters get exact extremes, not bucket edges.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def series_percentile(s: Optional[dict], buckets, q: float) -> Optional[float]:
    """Bucket-edge q-quantile (0..1) of one histogram series dict
    (``{"count", "max", "buckets": [per-bucket counts...]}``) — shared by
    the live :meth:`Histogram.percentile`, both exporters, and the fleet
    aggregator's cross-rank bucket merges."""
    if s is None or not s["count"]:
        return None
    target = q * s["count"]
    acc = 0
    for i, n in enumerate(s["buckets"]):
        acc += n
        if acc >= target:
            return buckets[i] if i < len(buckets) else s["max"]
    return s["max"]


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self._series: Dict[_LabelKey, object] = {}
        self._lock = threading.Lock()

    def labelsets(self) -> List[dict]:
        return [dict(k) for k in self._series]

    def _snapshot_value(self, v):
        return v

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind, "help": self.help, "unit": self.unit,
                "series": [{"labels": dict(k),
                            "value": self._snapshot_value(v)}
                           for k, v in self._series.items()],
            }


class Counter(_Metric):
    """Monotonic float counter; ``inc`` never accepts negative amounts."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum across every label combination."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(amount)

    def value(self, **labels) -> Optional[float]:
        v = self._series.get(_label_key(labels))
        return None if v is None else float(v)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics) + exact
    min/max/sum/count per series."""

    kind = "histogram"

    def __init__(self, name, help="", unit="", buckets=None):
        super().__init__(name, help, unit)
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
                     "buckets": [0] * (len(self.buckets) + 1)}
                self._series[key] = s
            s["count"] += 1
            s["sum"] += value
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    s["buckets"][i] += 1
                    break
            else:
                s["buckets"][-1] += 1  # +Inf overflow bucket

    def stats(self, **labels) -> Optional[dict]:
        s = self._series.get(_label_key(labels))
        return None if s is None else dict(s, buckets=list(s["buckets"]))

    def series(self) -> List[Tuple[dict, dict]]:
        with self._lock:
            return [(dict(k), dict(v, buckets=list(v["buckets"])))
                    for k, v in self._series.items()]

    def total_count(self) -> int:
        with self._lock:
            return sum(s["count"] for s in self._series.values())

    def total_sum(self) -> float:
        with self._lock:
            return float(sum(s["sum"] for s in self._series.values()))

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Bucket-edge estimate of the q-quantile (0..1) for one series."""
        return series_percentile(self._series.get(_label_key(labels)),
                                 self.buckets, q)

    def _snapshot_value(self, s):
        # non-cumulative per-bucket counts keyed by upper edge, JSON-safe.
        # p50/p95/p99 are exported alongside the raw buckets so consumers
        # (the fleet report, dashboards) never re-derive them.
        edges = [str(e) for e in self.buckets] + ["+Inf"]
        return {"count": s["count"], "sum": s["sum"],
                "min": None if s["count"] == 0 else s["min"],
                "max": None if s["count"] == 0 else s["max"],
                "p50": series_percentile(s, self.buckets, 0.5),
                "p95": series_percentile(s, self.buckets, 0.95),
                "p99": series_percentile(s, self.buckets, 0.99),
                "buckets": dict(zip(edges, s["buckets"]))}


class Registry:
    """Name -> metric map with get-or-create accessors.

    Re-registering an existing name with the same kind returns the existing
    metric (help/unit of the first registration win); a kind clash raises.
    """

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, unit, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}, "
                        f"not {cls.kind}")
                return m
            m = cls(name, help=help, unit=unit, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get_or_create(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, unit,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def reset(self, name: Optional[str] = None) -> None:
        """Drop recorded series (``name=None`` clears every metric's series;
        metric definitions survive so held references stay valid)."""
        with self._lock:
            targets = [self._metrics[name]] if name in self._metrics else \
                (list(self._metrics.values()) if name is None else [])
        for m in targets:
            with m._lock:
                m._series.clear()

    # -- exporters -----------------------------------------------------------
    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))

    def to_prometheus(self) -> str:
        """Prometheus textfile-collector exposition format."""
        out = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                help_text = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                out.append(f"# HELP {name} {help_text}")
            out.append(f"# TYPE {name} {m.kind if m.kind != 'untyped' else 'gauge'}")
            if isinstance(m, Histogram):
                pct_lines = []
                for labels, s in m.series():
                    cum = 0
                    for edge, n in zip(list(m.buckets) + ["+Inf"], s["buckets"]):
                        cum += n
                        out.append(f"{name}_bucket"
                                   f"{_prom_labels(labels, le=edge)} {cum}")
                    out.append(f"{name}_sum{_prom_labels(labels)} {s['sum']}")
                    out.append(f"{name}_count{_prom_labels(labels)} {s['count']}")
                    for suffix, q in (("p50", 0.5), ("p95", 0.95),
                                      ("p99", 0.99)):
                        v = series_percentile(s, m.buckets, q)
                        if v is not None:
                            pct_lines.append(
                                (suffix,
                                 f"{name}_{suffix}{_prom_labels(labels)} "
                                 f"{float(v)}"))
                # pre-computed percentile summaries as companion gauges —
                # consumers stop re-deriving quantiles from raw buckets
                for suffix in ("p50", "p95", "p99"):
                    lines = [ln for sfx, ln in pct_lines if sfx == suffix]
                    if lines:
                        out.append(f"# TYPE {name}_{suffix} gauge")
                        out.extend(lines)
            else:
                with m._lock:
                    items = list(m._series.items())
                for key, v in items:
                    out.append(f"{name}{_prom_labels(dict(key))} {float(v)}")
        return "\n".join(out) + "\n"

    def write_prometheus(self, path: str) -> None:
        import os

        tmp = path + ".tmp"  # textfile collectors read atomically-replaced files
        with open(tmp, "w") as f:
            f.write(self.to_prometheus())
        os.replace(tmp, path)


def _prom_escape(v: str) -> str:
    # exposition-format label values escape backslash, quote, and newline
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: dict, **extra) -> str:
    merged = dict(labels, **{k: v for k, v in extra.items()})
    if not merged:
        return ""
    body = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in sorted(
        (str(k), str(v)) for k, v in merged.items()))
    return "{" + body + "}"


#: the process-wide default registry — everything in the framework records here
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram

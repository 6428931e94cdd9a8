#!/usr/bin/env python
"""Render a measured-profile snapshot, through the port's modules: the
counterpart of ``tools/profreport.py``, with its output. Runs without JAX
installed.

Reads either a ``profile.json`` written by a step capture (periodic /
trigger-file / ``write_snapshot``), a capture directory containing one,
or a raw trace directory (the ``plugins/profile/...`` layout of a
``torch.profiler`` capture or of a JAX one — parsed on the spot), and
prints one
operator-facing summary: measured step time, the hot-op table (self
time, count, bytes where the trace carries them), per-device totals,
span breakdown, measured compute/collective overlap, and — when the
snapshot carries one — the predicted-vs-measured calibration table with
any flagged roofline-constant drift.

Usage::

    python3 tools/torch_profreport.py PATH            # table
    python3 tools/torch_profreport.py PATH --json     # machine-readable

Exits non-zero when PATH holds neither a snapshot nor a parseable trace.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fmt_ms(ns):
    if ns is None:
        return "-"
    return f"{ns / 1e6:.3f}"


def _fmt_s(v):
    if v is None:
        return "-"
    return f"{v * 1e3:.2f} ms" if v < 1.0 else f"{v:.3f} s"


def load(path: str):
    """(summary dict, origin) from a snapshot json / capture dir / raw
    trace dir; None when nothing parseable is there."""
    from mxnet_tpu_torch.observability import profiling

    if os.path.isfile(path):
        try:
            with open(path) as f:
                return json.load(f), path
        except (OSError, ValueError):
            return None
    snap = profiling.latest_profile(path) if os.path.isdir(path) else None
    if snap is not None:
        return snap, path
    if os.path.isdir(path):
        timeline = profiling.parse_trace(path)
        if timeline.n_events:
            report = profiling.measured_report(timeline)
            return {"meta": {}, "report": report.summary(),
                    "trace_dir": path}, timeline.source
    return None


def render(s: dict) -> str:
    out = []
    w = out.append
    meta = s.get("meta", {})
    r = s.get("report", {})
    w(f"== measured profile: {s.get('trace_dir', '?')}")
    ctx = " ".join(f"{k}={meta[k]}" for k in ("rank", "generation", "step",
                                              "trigger") if k in meta)
    if ctx:
        w(f"   {ctx}")
    st = r.get("step_seconds", {})
    w(f"   steps={r.get('steps', 0)}  step_time mean={_fmt_s(st.get('mean'))} "
      f"min={_fmt_s(st.get('min'))} max={_fmt_s(st.get('max'))}  "
      f"op_rows={r.get('n_op_rows', 0)} parse_errors={r.get('parse_errors', 0)}")
    w("-- hot ops (self time)")
    w(f"   {'op':<40} {'class':<12} {'count':>6} {'self ms':>10} "
      f"{'total ms':>10} {'bytes':>12}")
    for h in r.get("hot_ops", []):
        w(f"   {h['name'][:40]:<40} {h['op_class']:<12} {h['count']:>6} "
          f"{_fmt_ms(h['self_ns']):>10} {_fmt_ms(h['total_ns']):>10} "
          f"{h['bytes'] if h.get('bytes') is not None else '-':>12}")
    devs = r.get("per_device_seconds", {})
    if len(devs) > 1:
        w("-- per-device totals")
        for d, v in sorted(devs.items()):
            w(f"   {d}: {_fmt_s(v)}")
    spans = r.get("spans", {})
    if spans:
        w("-- spans")
        for name, v in sorted(spans.items()):
            w(f"   {name}: n={v['count']} total={_fmt_s(v['seconds'])} "
              f"mean={_fmt_s(v['mean_seconds'])}")
    w("-- overlap")
    w(f"   collective={_fmt_s(r.get('collective_seconds'))} "
      f"hidden={_fmt_s(r.get('hidden_collective_seconds'))} "
      f"compute={_fmt_s(r.get('compute_seconds'))} "
      f"measured overlap_fraction={r.get('overlap_fraction')}")
    cal = s.get("calibration")
    if cal:
        w("-- calibration (predicted roofline vs measured, "
          f"band={cal.get('band')})")
        w(f"   predicted step {cal['predicted_step_seconds']:.3e}s vs "
          f"measured {cal['measured_step_seconds'] and format(cal['measured_step_seconds'], '.3e') or '-'}s  "
          f"overall pred/meas ratio "
          f"{cal['overall_ratio'] and format(cal['overall_ratio'], '.3e') or '-'}")
        w(f"   predicted overlap {cal['predicted_overlap']} vs measured "
          f"{cal['measured_overlap']}")
        for row in cal.get("rows", []):
            flag = "  << DRIFT" if row.get("drift") else ""
            w(f"   {row['op_class']:<16} pred {row['predicted_seconds']:.3e}s"
              f"  meas {row['measured_seconds']:.3e}s  norm "
              f"{row['normalized'] and format(row['normalized'], '.2f') or '-'}"
              f"{flag}")
        for d in cal.get("drifting", []):
            w(f"   DRIFT: {d['op_class']} normalized ratio "
              f"{d['normalized_ratio']} — re-tune {d['knob']}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="profile.json, capture dir, or trace dir")
    ap.add_argument("--json", action="store_true",
                    help="print the snapshot as JSON")
    args = ap.parse_args(argv)
    loaded = load(args.path)
    if loaded is None:
        print(f"profreport: no measured profile under {args.path!r} "
              "(expected profile.json or a plugins/profile trace)",
              file=sys.stderr)
        return 1
    s, _origin = loaded
    print(json.dumps(s, indent=1, sort_keys=True) if args.json
          else render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Render per-request trace waterfalls from a fleet directory, through
the port's modules: the counterpart of ``tools/tracereport.py``, with its
output. Runs without JAX installed.

Joins the span JSONL the router (``router/spans-g*.jsonl``) and every
replica (``telemetry-h*/spans-g*.jsonl``) appended, assembles one span
tree per trace id, reconciles each tree against its end record (the
router-level spans must cover submit → finish contiguously and sum to
the end-to-end latency within tolerance), and prints the top-K tail
offenders — deadline breaches and redistribution victims first, then
thinnest deadline margin, then slowest — with per-phase attribution:
how much of each request went to router backlog, replica queue,
prefill, decode, and redistribution hops.

Usage::

    python3 tools/torch_tracereport.py FLEET_DIR           # top offenders
    python3 tools/torch_tracereport.py FLEET_DIR --top 10
    python3 tools/torch_tracereport.py FLEET_DIR --json    # machine-readable
    python3 tools/torch_tracereport.py FLEET_DIR --check   # exit 1 on any
                                                          # broken/orphan

Exits non-zero when the directory holds no trace records, or (with
``--check``) when any assembled trace fails reconciliation — the
chaos-fleet drill leans on the same library checks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_s(v):
    if v is None:
        return "-"
    return f"{v * 1e3:.2f} ms" if abs(v) < 1.0 else f"{v:.3f} s"


def _offender_key(trace, chk):
    """Sort key: broken first, then anomalous outcome, then thinnest
    margin, then slowest."""
    end = trace.get("end") or {}
    margin = end.get("margin")
    return (
        0 if not chk["ok"] else 1,
        0 if end.get("outcome") not in ("eos", "length") else 1,
        0 if int(end.get("hops") or 0) > 0 else 1,
        margin if margin is not None else float("inf"),
        -(end.get("e2e") or 0.0),
    )


def render_trace(tid, trace, chk):
    from mxnet_tpu_torch.observability.tracing import ROUTER_LEVEL_SPANS

    out = []
    w = out.append
    end = trace.get("end") or {}
    margin = end.get("margin")
    head = (f"== trace {tid} [{end.get('cls', '?')}] "
            f"outcome={end.get('outcome', '?')} "
            f"e2e={_fmt_s(end.get('e2e'))}")
    if margin is not None:
        head += f" margin={'+' if margin >= 0 else ''}{_fmt_s(margin)}"
    head += (f" hops={end.get('hops', 0)}"
             f" keep={end.get('why', '?')}")
    w(head)
    base = end.get("t0")
    if base is None and trace["spans"]:
        base = trace["spans"][0].get("t0", 0.0)
    base = base or 0.0
    for s in trace["spans"]:
        t0, t1 = float(s.get("t0", 0.0)), float(s.get("t1", 0.0))
        top = s["name"] in ROUTER_LEVEL_SPANS or s["name"] == "redistribution"
        # replica detail spans are nested attribution inside an attempt;
        # they share the router timebase only when the processes share a
        # clock, so they render indented, offsets on their own clock
        pad = "   " if top else "     "
        attrs = {k: v for k, v in s.items()
                 if k not in ("kind", "trace", "name", "t0", "t1", "src")}
        w(f"{pad}{t0 - base:+9.3f}s {t1 - t0:8.3f}s  {s['name']:<16} "
          f"({s.get('src', '?')})"
          + ("  " + " ".join(f"{k}={v}" for k, v in sorted(attrs.items()))
             if attrs else ""))
    phases = chk["phases"]
    if phases:
        w("   phases: " + "  ".join(
            f"{name}={_fmt_s(total)}"
            for name, total in sorted(phases.items(),
                                      key=lambda kv: -kv[1])))
    if chk["e2e"] is not None:
        w(f"   phase sum {_fmt_s(chk['phase_sum'])} vs e2e "
          f"{_fmt_s(chk['e2e'])} "
          f"({chk['rel_err'] * 100:.2f}% err)" if chk["rel_err"] is not None
          else "   phase sum: -")
    for p in chk["problems"]:
        w(f"   !! {p}")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fleet_dir",
                    help="shared fleet directory holding span JSONL files")
    ap.add_argument("--top", type=int, default=5,
                    help="waterfalls to print (worst offenders first)")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="relative phase-sum vs e2e tolerance (default 5%%)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable: per-trace checks + SLO ledger")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero when any trace fails "
                         "reconciliation or any span is orphaned")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mxnet_tpu_torch.observability import tracing

    records = tracing.collect_records(args.fleet_dir)
    if not records:
        print(f"tracereport: no trace records under {args.fleet_dir!r} "
              "(expected router/spans-g*.jsonl / "
              "telemetry-h*/spans-g*.jsonl)", file=sys.stderr)
        return 1
    assembled = tracing.assemble(records)
    checks = {tid: tracing.check_trace(t, tol=args.tolerance)
              for tid, t in assembled.items()}
    # a trace with spans but no end record either is still in flight or
    # lost its request — surfaced, and fatal under --check
    orphans = [tid for tid, t in assembled.items()
               if t["end"] is None and t["spans"]]
    broken = [tid for tid, t in assembled.items()
              if t["end"] is not None and not checks[tid]["ok"]]
    ends = [t["end"] for t in assembled.values() if t["end"] is not None]
    ledger = tracing.slo_ledger(ends)

    if args.json:
        print(json.dumps({
            "traces": len(assembled), "ends": len(ends),
            "orphans": orphans, "broken": broken,
            "checks": {tid: checks[tid] for tid in sorted(checks)},
            "slo": ledger,
        }, indent=1, sort_keys=True))
    else:
        print(f"== tracereport: {os.path.abspath(args.fleet_dir)}")
        kept = sum(1 for e in ends if e.get("keep"))
        print(f"   traces={len(assembled)} ends={len(ends)} kept={kept} "
              f"dropped={len(ends) - kept} orphans={len(orphans)} "
              f"broken={len(broken)}")
        if ledger:
            tot = ledger.get("total", {})
            print(f"   slo: target={ledger['target']:.4g} "
                  f"attainment={tot.get('attainment')} "
                  f"burn={tot.get('burn')}")
        ranked = sorted(
            ((tid, t) for tid, t in assembled.items()
             if t["end"] is not None or t["spans"]),
            key=lambda kv: _offender_key(kv[1], checks[kv[0]]))
        for tid, t in ranked[:max(0, args.top)]:
            print(render_trace(tid, t, checks[tid]))
        for tid in orphans:
            if not any(tid == r for r, _ in ranked[:args.top]):
                print(f"== trace {tid}: ORPHAN — {len(assembled[tid]['spans'])} "
                      "span(s), no end record")
    if args.check and (orphans or broken):
        print(f"tracereport: FAIL — {len(broken)} broken, "
              f"{len(orphans)} orphaned trace(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

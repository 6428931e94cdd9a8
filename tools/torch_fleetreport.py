#!/usr/bin/env python
"""Render the fleet observability report from a shared fleet directory,
through the port's modules: the counterpart of ``tools/fleetreport.py``,
with its output. Runs without JAX installed.

Reads every rank's ``telemetry-h{rank}/`` snapshots (all generations),
merges them through
:class:`mxnet_tpu_torch.observability.fleet.FleetAggregator`
and prints one operator-facing summary: per-rank step-time /
collective-wait distributions, the straggler/skew timeline, the goodput
ledger (productive train vs checkpoint / restore / re-formation downtime /
data stalls / idle), MFU, and serving rollups (TTFT + decode-rate
percentiles, slot utilization) — plus, when a fleet router published
into ``{fleet_dir}/router/``, the router-tier columns: per-replica
health state, admissions and redistributions joined with each replica's
own published load signals.

Usage::

    python3 tools/torch_fleetreport.py FLEET_DIR            # table
    python3 tools/torch_fleetreport.py FLEET_DIR --json     # machine-readable

Exits non-zero when the directory holds no rank telemetry.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _fmt_s(v):
    if v is None:
        return "-"
    return f"{v * 1e3:.2f} ms" if v < 1.0 else f"{v:.3f} s"


def _fmt_bytes(n):
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0


def _fmt_flops(v):
    if not v:
        return "-"
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000 or unit == "P":
            return f"{v:.2f} {unit}FLOP"
        v /= 1000.0


def render(s: dict) -> str:
    out = []
    w = out.append
    w(f"== fleet report: {s['directory']}")
    w(f"   ranks={len(s['ranks'])} generations={s['generations']} "
      f"events={s['n_events']} torn_snapshots={s['torn_snapshots']}")

    w("-- per-rank")
    w(f"   {'rank':>4} {'gens':>6} {'steps':>6} {'step p50':>10} "
      f"{'step p95':>10} {'wait p50':>10} {'wait p95':>10} "
      f"{'comm':>10} {'tok/s':>9} {'mfu':>7}")
    for r, rs in sorted(s["ranks"].items(), key=lambda kv: int(kv[0])):
        st, wt = rs["step_seconds"], rs["collective_wait_seconds"]
        comm = sum(rs["comm_bytes"].values())
        w(f"   {rs['rank']:>4} {','.join(map(str, rs['generations'])):>6} "
          f"{st['count']:>6} {_fmt_s(st['p50']):>10} {_fmt_s(st['p95']):>10} "
          f"{_fmt_s(wt['p50']):>10} {_fmt_s(wt['p95']):>10} "
          f"{_fmt_bytes(comm):>10} "
          f"{rs['tokens_per_sec'] and round(rs['tokens_per_sec']) or '-':>9} "
          f"{rs['mfu'] is not None and format(rs['mfu'], '.4g') or '-':>7}")

    if s["stragglers"]:
        w("-- stragglers")
        for t in s["stragglers"]:
            where = (f"gen={t.get('generation')} step={t.get('step')}"
                     if t["kind"] == "step" else "collective wait")
            w(f"   rank {t['rank']}: {where} {_fmt_s(t['seconds'])} "
              f"vs fleet median {_fmt_s(t['median_seconds'])} "
              f"({t['ratio']}x)")
    else:
        w("-- stragglers: none")

    tl = s["skew_timeline"]
    if tl:
        worst = sorted(tl, key=lambda t: -t["skew_seconds"])[:5]
        w("-- skew timeline (worst steps)")
        for t in worst:
            w(f"   gen={t['generation']} step={t['step']}: "
              f"skew={_fmt_s(t['skew_seconds'])} "
              f"(median {_fmt_s(t['median_seconds'])}, "
              f"slowest rank {t['slowest_rank']})")

    g = s["goodput"]
    if g:
        w("-- goodput")
        w(f"   wall={g['wall_seconds']:.3f}s  goodput={g['goodput']:.3f}")
        for cat, v in sorted(g["buckets"].items(), key=lambda kv: -kv[1]):
            if v > 0:
                w(f"   {cat:>12}: {v:9.3f}s "
                  f"({100.0 * v / g['wall_seconds']:5.1f}%)"
                  if g["wall_seconds"] else f"   {cat:>12}: {v:9.3f}s")

    flops = [rs["flops_per_step"] for rs in s["ranks"].values()
             if rs.get("flops_per_step")]
    mfus = [rs["mfu"] for rs in s["ranks"].values()
            if rs.get("mfu") is not None]
    bounds = [rs["mfu_bound"] for rs in s["ranks"].values()
              if rs.get("mfu_bound") is not None]
    exposed = [rs["comm_exposed_share"] for rs in s["ranks"].values()
               if rs.get("comm_exposed_share") is not None]
    if flops or mfus or bounds:
        w("-- mfu")
        if flops:
            w(f"   model flops/step: {_fmt_flops(max(flops))}")
        if mfus:
            w(f"   train_mfu: mean={sum(mfus) / len(mfus):.4g} "
              f"max={max(mfus):.4g}")
        if bounds:
            # the schedule auditor's static ceiling: achieved MFU can
            # only approach this; a widening gap is scheduling loss, a
            # LOW bound is exposed communication (the share line)
            w(f"   static bound (schedule auditor): {max(bounds):.4g}")
        if exposed:
            w(f"   exposed-comm share of critical path: "
              f"{max(exposed):.3f}")

    profiles = s.get("profiles", {})
    if profiles:
        # newest capture across ranks: the measured hot-op list sits
        # right under the static bound it must be read against
        rank, prof = max(profiles.items(),
                         key=lambda kv: kv[1].get("meta", {}).get("ts", 0))
        meta = prof.get("meta", {})
        r = prof.get("report", {})
        w(f"-- hot ops (measured profile: rank {rank}, "
          f"step={meta.get('step')}, trigger={meta.get('trigger')})")
        st = r.get("step_seconds") or {}
        w(f"   steps={r.get('steps')} step mean={_fmt_s(st.get('mean'))} "
          f"op_rows={r.get('n_op_rows')} "
          f"measured overlap={r.get('overlap_fraction')}")
        for h in r.get("hot_ops", [])[:10]:
            w(f"   {h['name'][:40]:<40} {h['op_class']:<12} "
              f"n={h['count']:<5} self={h['self_ns'] / 1e6:.3f} ms"
              + (f" bytes={h['bytes']}" if h.get("bytes") is not None
                 else ""))

    sv = s["serving"]
    if sv:
        w("-- serving")
        for name in ("ttft_seconds", "decode_tokens_per_s"):
            h = sv.get(name)
            if h:
                unit = _fmt_s if name == "ttft_seconds" else \
                    (lambda v: f"{v:.0f}/s" if v is not None else "-")
                w(f"   {name}: n={h['count']} p50={unit(h['p50'])} "
                  f"p95={unit(h['p95'])} p99={unit(h['p99'])}")
        if "slot_utilization" in sv:
            w(f"   slot utilization: {sv['slot_utilization']:.2f}")
        if "requests" in sv:
            w("   requests: " + ", ".join(
                f"{k}={v}" for k, v in sorted(sv["requests"].items())))

    rt = s.get("router") or {}
    if rt:
        # router-tier columns (mxnet_tpu_torch.serving): health state +
        # admission/redistribution counts per replica, joined with each
        # replica's own published load signals from its rank dir
        w("-- router")
        w(f"   {'replica':>7} {'state':>9} {'admits':>7} {'redist':>7} "
          f"{'free pg':>8} {'queue':>6} {'age p95':>10}")
        def _n(v):
            return "-" if v is None else int(v)

        for rid, rec in sorted(rt.get("replicas", {}).items(),
                               key=lambda kv: kv[0]):
            self_rep = (s["ranks"].get(str(rid)) or {}).get("replica") or {}
            age = self_rep.get("queue_age_p95")
            w(f"   {rid:>7} {rec.get('state', '?'):>9} "
              f"{rec.get('admissions', 0):>7} "
              f"{rec.get('redistributions', 0):>7} "
              f"{_n(self_rep.get('free_pages')):>8} "
              f"{_n(self_rep.get('queue_depth')):>6} "
              f"{_fmt_s(age) if age is not None else '-':>10}")
        for name in ("requests", "completions"):
            if rt.get(name):
                w(f"   {name}: " + ", ".join(
                    f"{k}={v}" for k, v in sorted(rt[name].items())))

    slo = s.get("slo") or {}
    if slo:
        # per-priority-class SLO attainment + burn rates folded from the
        # request-trace end records; burn > 1 spends error budget faster
        # than it accrues over that window
        w(f"-- slo (target {slo['target']:.4g}, windows "
          f"{','.join(slo['windows'])})")
        hdr = (f"   {'class':>12} {'n':>5} {'attain':>8} "
               f"{'margin p50':>11} {'margin p95':>11} {'redist':>7}")
        w(hdr + "".join(f" {'burn ' + win:>10}" for win in slo["windows"]))
        rows = list(sorted(slo.get("classes", {}).items()))
        rows.append(("TOTAL", slo.get("total", {})))
        for cls, rec in rows:
            if not rec:
                continue
            att = rec.get("attainment")
            m = rec.get("margin") or {}
            line = (f"   {cls:>12} {rec.get('eligible', 0):>5} "
                    f"{att if att is None else format(att, '.4f'):>8} "
                    f"{_fmt_s(m.get('p50')):>11} {_fmt_s(m.get('p95')):>11} "
                    f"{rec.get('redistributed', 0):>7}")
            for win in slo["windows"]:
                b = (rec.get("burn") or {}).get(win)
                line += f" {'-' if b is None else format(b, '.3f'):>10}"
            w(line)

    tc = s.get("traces") or {}
    if tc:
        w("-- traces")
        w(f"   traces={tc.get('traces', 0)} ends={tc.get('ends', 0)} "
          f"kept={tc.get('kept', 0)} dropped={tc.get('dropped', 0)} "
          f"orphans={tc.get('orphans', 0)} "
          f"(waterfalls: tools/torch_tracereport.py)")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("fleet_dir",
                    help="shared fleet directory (telemetry-h{rank}/ dirs)")
    ap.add_argument("--json", action="store_true",
                    help="print the merged report as JSON")
    ap.add_argument("--straggler-factor", type=float, default=None,
                    help="override MXNET_TPU_STRAGGLER_FACTOR")
    ap.add_argument("--peak-flops", type=float, default=None,
                    help="override MXNET_TPU_PEAK_FLOPS for the MFU line")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mxnet_tpu_torch.observability.fleet import FleetAggregator

    agg = FleetAggregator(args.fleet_dir,
                          straggler_factor=args.straggler_factor,
                          peak_flops=args.peak_flops)
    report = agg.collect()
    if report is None:
        print(f"fleetreport: no rank telemetry under {args.fleet_dir!r} "
              "(expected telemetry-h{rank}/ snapshot dirs)", file=sys.stderr)
        return 1
    s = report.summary()
    print(json.dumps(s, indent=1, sort_keys=True) if args.json
          else render(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Program-audit gate of the PyTorch/CUDA port (the counterpart of
``tools/audit.py``).

Audits the port's two carry-updating program families through
``TrainStep.audit()`` / ``GenerationEngine.audit()`` and FAILS unless the
structural contracts hold:

  1. **bf16 purity**: the bf16-policy TrainStep's record (single step AND
     the k-step window) holds bf16 products only and ZERO f64 ops;
  2. **carry coverage**: 100% of the TrainStep carry (parameters, masters,
     optimizer states; window included) and of each decode engine's KV
     cache is updated in place, and no serving program holds a host
     transfer;
  3. **recompile causes**: a new program forced by a batch-shape change is
     *logged* with cause ``"shape"`` and an ``arg: old -> new`` detail in
     the event log, not just counted.

On the card (``--device cuda``) the programs run first, so each audit also
holds the census of the CUDA graph the program replays: its kernel nodes
must equal the launch counters' delta over the capture and the record's
kernel ops, and the decode graphs must hold no memcpy to or from the
host.

Usage::

    python tools/torch_audit.py                 # on the CPU
    python tools/torch_audit.py --device cuda   # on the card

Prints one JSON object and ``OK``/``FAIL`` lines; exits 1 on a failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _census_fails(name, audit, fails):
    from mxnet_tpu_torch.analysis import census_mismatches

    if audit.compiled is None:
        return
    bad = census_mismatches(audit)
    if bad:
        fails.append(f"{name}: the graph census, the launch counters and "
                     f"the record disagree: {bad}")


def train_step_section(device, fails):
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import TrainStep

    tmx.random.seed(0)
    ctx = tmx.gpu(0) if device == "cuda" else tmx.cpu()
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu"), nn.Dense(8))
    net.initialize(ctx=ctx)
    x = torch.ones(8, 16, device=device)
    _ = net(x)
    ts = TrainStep(net, lambda out, *l: ((out - l[0]) ** 2).mean(),
                   optimizer.Adam(learning_rate=1e-3), amp="bfloat16")
    batch = (x, torch.zeros(8, 8, device=device))
    if device == "cuda":  # warm up and capture both programs
        for _ in range(3):
            ts(*batch)
            ts.run(iter([batch] * 3), steps=3, window=3)
    out = {}
    for name, audit in (("step", ts.audit(*batch)),
                        ("window", ts.audit(*batch, window=3))):
        dots = audit.lowered.dot_dtypes()
        f64 = audit.lowered.ops_with_dtype("f64")
        cov = audit.carry_donation()
        out[name] = {"dots": dots, "f64_ops": len(f64),
                     "kernels": audit.lowered.summary()["kernels"],
                     "carry_n": len(audit.carry_indices),
                     "donation_coverage": cov,
                     "graph": (audit.compiled.op_census()
                               if audit.compiled is not None
                               else audit.why_not_compiled)}
        if dots.get("bf16", 0) < 2 or set(dots) != {"bf16"}:
            fails.append(f"{name}: the bf16-policy program's products are "
                         f"not all bf16 ({dots})")
        if f64:
            fails.append(f"{name}: {len(f64)} f64 ops in the bf16 program: "
                         f"{f64[:3]}")
        if cov < 1.0:
            fails.append(f"{name}: carry in place {cov:.0%} < 100% — "
                         f"missing inputs {audit.carry_missing()}")
        if device == "cuda" and audit.compiled is None:
            fails.append(f"{name}: no graph census on the card "
                         f"({audit.why_not_compiled})")
        _census_fails(name, audit, fails)
    return out


def decode_engine_section(device, fails):
    from mxnet_tpu_torch.inference import GenerationEngine
    from mxnet_tpu_torch.models import gpt2

    net = gpt2.get_gpt2("gpt2_117m", dropout=0.0, num_layers=2, units=64,
                        num_heads=1, max_length=64, vocab_size=64,
                        device=device, seed=0)
    kw = dict(batch_size=2, max_length=64, prefill_buckets=(8, 16),
              device=device)
    eng = GenerationEngine(net, **kw)
    paged = GenerationEngine(net, paged=True, page_size=16, **kw)
    spec = GenerationEngine(net, paged=True, page_size=16, draft_net=net,
                            speculate_k=4, **kw)
    for e in (eng, paged):  # the decode and prefill programs' graphs
        e.prefill([1, 2, 3], slot=0)
        for _ in range(3):
            e.decode_step()
    spec.prefill([1, 2, 3], slot=0)
    for _ in range(3):
        spec.spec_step()
    out = {}
    audits = (("decode", eng.audit()),
              ("prefill", eng.audit(bucket=8)),
              ("paged_decode", paged.audit()),
              ("paged_prefill", paged.audit(bucket=8)),
              ("paged_cow", paged.audit(program="cow")),
              ("spec_draft", spec.audit()),
              ("spec_verify", spec.audit(program="verify")),
              ("spec_prefill", spec.audit(bucket=8)))
    for name, audit in audits:
        cov = audit.carry_donation()
        hosts = [o.name for rep in (audit.lowered, audit.compiled)
                 if rep is not None for o in rep.host_transfers()]
        out[name] = {"carry_n": len(audit.carry_indices),
                     "donation_coverage": cov, "host_transfers": hosts,
                     "kernels": audit.lowered.summary()["kernels"],
                     "graph": (audit.compiled.op_census()
                               if audit.compiled is not None
                               else audit.why_not_compiled)}
        if cov < 1.0:
            fails.append(f"{name}: KV-cache carry in place {cov:.0%} < "
                         f"100% — missing {audit.carry_missing()}")
        if hosts:
            fails.append(f"{name}: host transfers in the serving program: "
                         f"{hosts}")
        _census_fails(name, audit, fails)
    return out


def recompile_cause_section(device, fails):
    """A shape-change recompile lands in the event log with cause "shape"
    and a detail naming the changed argument."""
    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import observability as obs, optimizer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.parallel import TrainStep

    with tempfile.TemporaryDirectory() as tmp:
        obs.enable(tmp)
        try:
            tmx.random.seed(0)
            net = nn.Dense(4, in_units=3)
            net.initialize(ctx=tmx.gpu(0) if device == "cuda"
                           else tmx.cpu())
            _ = net(torch.ones(2, 3, device=device))
            ts = TrainStep(net, lambda out, y: ((out - y) ** 2).mean(),
                           optimizer.SGD(learning_rate=0.1))
            ts(torch.ones(2, 3, device=device),
               torch.ones(2, 4, device=device))
            ts(torch.ones(6, 3, device=device),   # the shape change
               torch.ones(6, 4, device=device))
            obs.shutdown()
            recs = [e for e in obs.read_events(tmp)
                    if e["event"] == "recompile"]
        finally:
            obs.disable()
    shape_evs = [e for e in recs if e.get("reason") == "shape"]
    out = {"recompile_events": len(recs),
           "shape_events": [{k: e.get(k) for k in
                             ("reason", "cause", "detail")}
                            for e in shape_evs]}
    if not shape_evs:
        fails.append(f"no recompile event with reason='shape' (got "
                     f"{[e.get('reason') for e in recs]})")
    elif not (shape_evs[0].get("cause") == "shape"
              and "->" in shape_evs[0].get("detail", "")):
        fails.append(f"shape recompile not explained: {shape_evs[0]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    from mxnet_tpu_torch.context import Context

    fails: list = []
    with Context(args.device):  # blocks are built on the audited device
        row = {"gate": "torch_audit", "device": args.device,
               "train_step": train_step_section(args.device, fails),
               "decode_engine": decode_engine_section(args.device, fails),
               "recompile_cause": recompile_cause_section(args.device,
                                                          fails)}
    row["ok"] = not fails
    if fails:
        row["failures"] = fails
    print(json.dumps(row, indent=1, default=str))
    if fails:
        for msg in fails:
            print(f"FAIL: {msg}")
        return 1
    ts = row["train_step"]
    print(f"OK ({args.device}): bf16 step/window carry in place 100% "
          f"({ts['step']['carry_n']}+{ts['window']['carry_n']} buffers), "
          f"bf16 products only, 0 f64 ops; dense/paged/speculative cache "
          f"carry in place 100% with no host transfer; the shape recompile "
          f"explained in the event log")
    return 0


if __name__ == "__main__":
    sys.exit(main())

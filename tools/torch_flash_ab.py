#!/usr/bin/env python3
"""Time the flash kernels and the paged read of several checkouts, or of
variants of this one's sources, in turns, on one card.

    python3 tools/torch_flash_ab.py TREE [TREE ...] [--variant NAME ...]
                                    [--dtype float32] [--check] [--plans]

Each TREE is a checkout of this repository (for a parent-against-change
comparison: the parent commit unpacked by ``git archive`` into a
git-ignored directory, and ``.``), timed in the order given (parent,
change, change, parent). Each ``--variant`` is a design alternative of the
f32 backward or the paged prefill (``VARIANTS`` of
tools/torch_flash_faults.py, whose helpers make the edited copy), timed
after the trees. Every run is a process of
its own that imports its tree's ``mxnet_tpu_torch`` and ``chip_smoke.py``
and builds its ``csrc/flash_attention.cu`` and ``csrc/paged_attention.cu``.
Per run it times the flash forward (with lse), dK/dV and dQ at
chip_smoke.py's training shapes (B=4, H=16, D=64, causal; T=1024 and
T=2048), and the f32 paged read at the serve path's shapes (a decode step
of B=8 rows with 512 live keys, ps 16, four layers' pools in turn; a
prefill of one row of 512 queries from position 0), on the same seeded
inputs, as device time by CUDA graph replay (chip_smoke's
``graph_time_ms``). With ``--plans`` it also times the f32 prefill read at
several (B, Tq) from position 0, 16 heads, under each split plan of
``PLANS`` (the tree's own ``_split_plan`` replaced for the call): the
measurements that set ``ops/paged_attention.py``'s prefill plan. This
checkout's prefill kernel does not split, so the split plans need a tree
whose kernel does: ``--variant prefill_split`` (alone, without trees). With
``--check`` it first runs chip_smoke's flash checks in that dtype
(``phase_flash_kernels``, every failure collected) and reports their
largest errors and failures. Prints one JSON line per run, then the card's
name and power limit. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

from torch_flash_faults import VARIANTS, edited_tree, run_in

RUN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mxnet_tpu_torch.ops import cuda_common
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import paged_attention as pa
torch.backends.cuda.matmul.allow_tf32 = False
dtype = getattr(torch, sys.argv[1])
cuda_common.build(["flash_attention", "paged_attention"])
res = {}
if sys.argv[2] == "1":
    errs, fails = {}, []
    cs.phase_flash_kernels(errs, dtypes=(dtype,), failures=fails)
    res.update(max_abs_err=errs, failures=fails)
dev = torch.device("cuda")
rows = {}
for t in (1024, 2048):
    gen = torch.Generator().manual_seed(6)
    q, k, v = cs._flash_inputs(gen, 4, 16, t, t, 64, dtype, dev)
    do = torch.randn(4, 16, t, 64, generator=gen).to(dev, dtype)
    out, lse = fa._flash_fwd(q, k, v, True, return_lse=True)
    di = fa._row_dot(do, out).contiguous()
    rows[f"fwd T={t}"] = cs.graph_time_ms(
        lambda: fa._flash_fwd(q, k, v, True, return_lse=True))
    rows[f"dkv T={t}"] = cs.graph_time_ms(
        lambda: fa._bwd_dkv(q, k, v, do, lse, di, True))
    rows[f"dq T={t}"] = cs.graph_time_ms(
        lambda: fa._bwd_dq(q, k, v, do, lse, di, True))
    rows[f"pair T={t}"] = rows[f"dkv T={t}"] + rows[f"dq T={t}"]

# the paged read, f32: 16 heads, Ch 64, pages of 16, 4 pools of 1024 pages
gen = torch.Generator().manual_seed(2)
h, ch, ps = 16, 64, 16
pools = [tuple(torch.randn(1025, h, ps, ch, generator=gen).to(dev)
               for _ in range(2)) for _ in range(4)]
it = iter(range(10 ** 9))
table = torch.arange(1, 1025, dtype=torch.int32, device=dev).reshape(16, 64)
qd = torch.randn(8, h, 1, ch, generator=gen).to(dev)
pos = torch.full((8,), 511, dtype=torch.int32, device=dev)
rows["paged decode B=8 L=512"] = cs.graph_time_ms(
    lambda: pa.paged_attention_read(qd, *pools[next(it) % 4], table[:8], pos))


def prefill(b, tq):
    q = torch.randn(b, h, tq, ch, generator=gen).to(dev)
    p0 = torch.zeros(b, dtype=torch.int32, device=dev)
    kp, vp = pools[0]
    return cs.graph_time_ms(
        lambda: pa.paged_attention_read(q, kp, vp, table[:b], p0))


rows["paged prefill B=1 Tq=512"] = prefill(1, 512)
res["device_us"] = {k: v * 1e3 for k, v in rows.items()}
if sys.argv[3] == "1":
    plans, own = {}, pa._split_plan
    for name, keys in PLANS.items():
        pa._split_plan = (lambda cap, tq, bh, keys=keys: own(cap, tq, bh)
                          if tq == 1 or keys is None else
                          (keys, max(1, -(-cap // keys))))
        for b, tq in PLAN_SHAPES:
            plans[f"{name} B={b} Tq={tq}"] = prefill(b, tq) * 1e3
    pa._split_plan = own
    res["prefill_plans_us"] = plans
print("RESULT " + json.dumps(res))
"""

# prefill split plans that --plans times: name -> logical keys a split
# (None: the tree's own plan; 2^30: one split)
PLANS = {"own": None, "whole": 1 << 30, "split128": 128, "split256": 256}
# (B, Tq) of the prefill reads under each plan, from position 0
PLAN_SHAPES = [(1, 128), (1, 256), (1, 512), (2, 512), (4, 512), (8, 128)]
RUN = f"PLANS = {PLANS!r}\nPLAN_SHAPES = {PLAN_SHAPES!r}\n" + RUN


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(t, Path(t).resolve()) for t in args.trees]
        runs += [(f"variant {n}", edited_tree(Path(tmp) / n, n, *VARIANTS[n]))
                 for n in args.variant]
        for i, (what, tree) in enumerate(runs):
            res = run_in(tree, what, RUN, args.dtype, str(int(args.check)),
                         str(int(args.plans)), timeout=900)
            print(json.dumps({"run": i, "tree": what, "dtype": args.dtype,
                              **res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()

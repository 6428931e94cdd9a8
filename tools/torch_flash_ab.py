#!/usr/bin/env python3
"""Time the flash kernels of several checkouts, or of variants of this
one's sources, in turns, on one card.

    python3 tools/torch_flash_ab.py TREE [TREE ...] [--variant NAME ...]
                                    [--dtype float32] [--check]

Each TREE is a checkout of this repository (for a parent-against-change
comparison: the parent commit unpacked by ``git archive`` into a
git-ignored directory, and ``.``), timed in the order given (parent,
change, change, parent). Each ``--variant`` is a design alternative of the
f32 backward (``VARIANTS`` of tools/torch_flash_faults.py, whose helpers
make the edited copy), timed after the trees. Every run is a process of
its own that imports its tree's ``mxnet_tpu_torch`` and ``chip_smoke.py``
and builds its ``csrc/flash_attention.cu``. Per run it times the flash
forward (with lse), dK/dV and dQ at chip_smoke.py's training shapes (B=4,
H=16, D=64, causal; T=1024 and T=2048) on the same seeded inputs, as
device time by CUDA graph replay (chip_smoke's ``graph_time_ms``); with
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
torch.backends.cuda.matmul.allow_tf32 = False
dtype = getattr(torch, sys.argv[1])
cuda_common.build(["flash_attention"])
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
res["device_us"] = {k: v * 1e3 for k, v in rows.items()}
print("RESULT " + json.dumps(res))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(t, Path(t).resolve()) for t in args.trees]
        runs += [(f"variant {n}", edited_tree(Path(tmp) / n, n, *VARIANTS[n]))
                 for n in args.variant]
        for i, (what, tree) in enumerate(runs):
            res = run_in(tree, what, RUN, args.dtype, str(int(args.check)),
                         timeout=900)
            print(json.dumps({"run": i, "tree": what, "dtype": args.dtype,
                              **res}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Show that chip_smoke.py's checks of the bf16 flash kernels and of the
split-key paged read see a wrong kernel.

    python3 tools/torch_flash_faults.py

Needs one H100. Copies the port and chip_smoke.py into a temporary
directory, plants each fault below in the copy's ``csrc/flash_attention.cu``
(the bf16 tensor-core kernels) or ``csrc/paged_attention.cu`` (the checkout
is not touched), builds the copy and runs chip_smoke's checks of that
kernel there: the bf16 flash checks (``phase_flash_kernels``, every case of
FLASH_CASES at head dims 64 and 128) or the paged checks
(``phase_paged_kernels``, every case of PAGED_CASES), collecting every
failing check instead of stopping at the first. The unmodified copy runs
both first. Prints one JSON line per variant: the largest error of each
check and how many checks failed, by check and output. Exits non-zero if
the unmodified kernels fail a check or a planted fault passes a check that
it must fail.
"""
from __future__ import annotations

import collections
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name -> (source, [(check, outputs)] of which each must fail at least once,
#          [(original text, planted text)])
FAULTS = {
    # backward: ds = p * dp, the "- di" term dropped, in both kernels
    "bwd_no_di": ("flash_attention", [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("dp[j][e] = p * (dp[j][e] - dis[c]);", "dp[j][e] = p * dp[j][e];"),
        ("dp[j][e] = p * (dp[j][e] - di_r[h]);", "dp[j][e] = p * dp[j][e];"),
    ]),
    # backward: the element mask of the tiles on the causal frontier lets
    # one more key through
    "bwd_mask_shift": ("flash_attention", [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("(causal && key > row + off)", "(causal && key > row + off + 1)"),
        ("(causal && col > row + off)) p = 0.f;",
         "(causal && col > row + off + 1)) p = 0.f;"),
    ]),
    # forward: the O accumulator is not rescaled when the row max moves
    "fwd_no_corr": ("flash_attention", [
        ("flash_fwd", ("out",)), ("flash_fwd_rounded", ("out",))], [
        ("acc[j][e] *= corr[e >> 1];", "acc[j][e] *= 1.f;"),
    ]),
    # forward: the causal mask lets one more key through
    "fwd_mask_shift": ("flash_attention", [
        ("flash_fwd", ("out", "lse")), ("flash_fwd_rounded", ("out", "lse"))], [
        ("(causal && col > row + off)) x = -INFINITY;",
         "(causal && col > row + off + 1)) x = -INFINITY;"),
    ]),
    # paged: the combine merges every live split but the last
    "paged_no_last_split": ("paged_attention", [("paged_attention", None)], [
        ("for (int sp = 0; sp < n_live; ++sp) {",
         "for (int sp = 0; sp < n_live - 1; ++sp) {"),
    ]),
    # paged: the live splits counted one key off, so a frontier on the first
    # key of a split leaves that split out
    "paged_split_off": ("paged_attention", [("paged_attention", None)], [
        ("const int n_live = last_key / split_keys + 1;",
         "const int n_live = (last_key - 1) / split_keys + 1;"),
    ]),
}

RUN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mxnet_tpu_torch.ops import cuda_common
torch.backends.cuda.matmul.allow_tf32 = False
sources = sys.argv[1].split(",")
cuda_common.build(sources)
errs, fails = {}, []
if "flash_attention" in sources:
    cs.phase_flash_kernels(errs, dtypes=(torch.bfloat16,), failures=fails)
if "paged_attention" in sources:
    cs.phase_paged_kernels(errs, failures=fails)
print("RESULT " + json.dumps({"errs": errs, "failures": fails}))
"""


def run_variant(src: Path, name: str, sources, edits) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        dst = Path(tmp)
        shutil.copytree(src / "mxnet_tpu_torch", dst / "mxnet_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(src / "chip_smoke.py", dst / "chip_smoke.py")
        for source in sources:
            cu = dst / "mxnet_tpu_torch" / "csrc" / f"{source}.cu"
            text = cu.read_text()
            for old, new in edits:
                if old in text:
                    if text.count(old) != 1:
                        raise SystemExit(f"{name}: '{old}' is in {source}.cu "
                                         f"more than once")
                    text = text.replace(old, new)
                    edits = [e for e in edits if e[0] != old]
            cu.write_text(text)
        if edits:
            raise SystemExit(f"{name}: {[e[0] for e in edits]} not in the "
                             f"sources")
        out = subprocess.run([sys.executable, "-c", RUN, ",".join(sources)],
                             cwd=dst, capture_output=True, text=True,
                             timeout=1200)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"{name}: run failed ({out.returncode})\n"
                         f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def summary(name, res):
    """Failed checks counted by "<check> <output>" (check_close's message
    starts with the check's name, then the output: dk, dv, dq, out, lse, or
    the dtype for the paged read)."""
    fails = res["failures"]
    by = collections.Counter(" ".join(m.split()[:2]) for m in fails)
    return {"variant": name, "failed_checks": len(fails),
            "failed_by_check": dict(by), "max_abs_err": res["errs"],
            "first_failures": fails[:4]}


def main():
    bad = []
    variants = [("unmodified", ("flash_attention", "paged_attention"), [],
                 [])]
    variants += [(n, (src,), must, edits)
                 for n, (src, must, edits) in FAULTS.items()]
    for name, sources, must, edits in variants:
        row = summary(name, run_variant(ROOT, name, sources, edits))
        print(json.dumps(row), flush=True)
        if name == "unmodified" and row["failed_checks"]:
            bad.append("the unmodified kernels fail a check")
        by = row["failed_by_check"]
        for check, outputs in must:
            n = sum(c for key, c in by.items() if key.split()[0] == check
                    and (outputs is None or key.split()[1] in outputs))
            if not n:
                bad.append(f"{name}: passes the {check} check of "
                           f"{outputs or 'every output'}")
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()

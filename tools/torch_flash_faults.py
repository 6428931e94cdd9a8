#!/usr/bin/env python3
"""Show that chip_smoke.py's checks of the tensor-core flash kernels (bf16,
and f32 in 3xTF32) and of the split-key paged read see a wrong kernel.

    python3 tools/torch_flash_faults.py [--only NAME ...]

Needs one H100. Copies the port and chip_smoke.py into a temporary
directory, plants each fault below in the copy's ``csrc/`` (the checkout is
not touched), builds the copy and runs chip_smoke's checks of that kernel
there: the flash checks (``phase_flash_kernels``, every case of FLASH_CASES
at head dims 64 and 128, in the fault's dtype) or the paged checks
(``phase_paged_kernels``, every case of PAGED_CASES and PAGED_DTYPES),
collecting every failing check instead of stopping at the first. The
unmodified copy runs all of them first. Prints one JSON line per variant:
the largest error of each check and how many checks failed, by check and
output. Exits non-zero if the unmodified kernels fail a check or a planted
fault passes a check that it must fail.

The copy-edit-run helpers (``edited_tree``, ``run_in``) and the design
alternatives of the f32 backward (VARIANTS, which are correct kernels and
fail no check) serve tools/torch_flash_ab.py too, which times them.
"""
from __future__ import annotations

import argparse
import collections
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BF16, F32 = "bfloat16", "float32"

# name -> (file under csrc/, checks: "flash" or "paged", flash dtypes,
#          [(check, outputs)] of which each must fail at least once,
#          [(original text, planted text)])
FAULTS = {
    # bf16 backward: ds = p * dp, the "- di" term dropped, in both kernels
    "bwd_no_di": ("flash_attention.cu", "flash", (BF16,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("dp[j][e] = p * (dp[j][e] - dis[c]);", "dp[j][e] = p * dp[j][e];"),
        ("dp[j][e] = p * (dp[j][e] - di_r[h]);", "dp[j][e] = p * dp[j][e];"),
    ]),
    # bf16 backward: the element mask of the tiles on the causal frontier
    # lets one more key through
    "bwd_mask_shift": ("flash_attention.cu", "flash", (BF16,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("(causal && key > row + off)", "(causal && key > row + off + 1)"),
        ("(causal && col > row + off)) p = 0.f;",
         "(causal && col > row + off + 1)) p = 0.f;"),
    ]),
    # bf16 forward: the O accumulator is not rescaled when the row max moves
    "fwd_no_corr": ("flash_attention.cu", "flash", (BF16,), [
        ("flash_fwd", ("out",)), ("flash_fwd_rounded", ("out",))], [
        ("acc[j][e] *= corr[e >> 1];", "acc[j][e] *= 1.f;"),
    ]),
    # bf16 forward: the causal mask lets one more key through
    "fwd_mask_shift": ("flash_attention.cu", "flash", (BF16,), [
        ("flash_fwd", ("out", "lse")), ("flash_fwd_rounded", ("out", "lse"))], [
        ("(causal && col > row + off)) x = -INFINITY;",
         "(causal && col > row + off + 1)) x = -INFINITY;"),
    ]),
    # f32 backward (3xTF32): the "- di" term dropped, in both kernels
    "f32_bwd_no_di": ("flash_attention.cu", "flash", (F32,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd", ("dq",))], [
        ("dst[j][e] = p * (dst[j][e] - di_t[c]);", "dst[j][e] = p * dst[j][e];"),
        ("ds[j][e] = p * (ds[j][e] - di_q[h]);", "ds[j][e] = p * ds[j][e];"),
    ]),
    # f32 backward: one TF32 product instead of three (the lo terms
    # dropped), which only the tight check can see
    "f32_bwd_1xtf32": ("mma_sm90.cuh", "flash", (F32,), [
        ("flash_bwd_tight", ("dk", "dv")), ("flash_bwd_tight", ("dq",))], [
        ("  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);\n",
         ""),
    ]),
    # f32 backward: the second B row of the accumulating products read in
    # mma order (k-slot t + 4) instead of the C fragment's (row 2t + 1)
    "f32_bwd_b_unpermuted": ("flash_attention.cu", "flash", (F32,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd", ("dq",))], [
        ("const float* b_row1 = b_row0 + LD;",
         "const float* b_row1 = tile + (t + 4) * LD + g;"),
    ]),
    # paged: the combine merges every live split but the last
    "paged_no_last_split": ("paged_attention.cu", "paged", (), [
        ("paged_attention", None)], [
        ("for (int sp = 0; sp < n_live; ++sp) {",
         "for (int sp = 0; sp < n_live - 1; ++sp) {"),
    ]),
    # paged: the live splits counted one key off, so a frontier on the first
    # key of a split leaves that split out
    "paged_split_off": ("paged_attention.cu", "paged", (), [
        ("paged_attention", None)], [
        ("const int n_live = last_key / split_keys + 1;",
         "const int n_live = (last_key - 1) / split_keys + 1;"),
    ]),
}

_SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;  "
          "// add half an ulp, truncate\n")
_PASSES = ("#pragma unroll\n"
           "  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);\n"
           "#pragma unroll\n"
           "  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);\n"
           "#pragma unroll\n"
           "  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_hi[j][0], b_hi[j][1]);\n")

# Design alternatives of the f32 backward that PERF.md reports, as edits of
# this checkout: name -> (file under csrc/, [(original text, variant text)])
VARIANTS = {
    # the 3xTF32 split with cvt.rna.tf32.f32 for hi and for lo
    "cvt_split": ("mma_sm90.cuh", [(
        _SPLIT + "  lo = __float_as_uint(x - __uint_as_float(hi));\n",
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
        "  const float rest = x - __uint_as_float(hi);\n"
        '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));\n')]),
    # hi truncated to TF32 instead of rounded (|lo| up to a whole TF32 ulp)
    "truncated_hi": ("mma_sm90.cuh", [(
        _SPLIT, "  hi = __float_as_uint(x) & 0xffffe000u;\n")]),
    # the three passes of each n-tile back to back on one accumulator
    "dependent_passes": ("mma_sm90.cuh", [(
        _PASSES,
        "#pragma unroll\n"
        "  for (int j = 0; j < JC; ++j) {\n"
        "    mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);\n"
        "    mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);\n"
        "    mma_tf32(c[j], a_hi, b_hi[j][0], b_hi[j][1]);\n"
        "  }\n")]),
}

RUN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mxnet_tpu_torch.ops import cuda_common
torch.backends.cuda.matmul.allow_tf32 = False
checks, dtypes = sys.argv[1].split(","), sys.argv[2].split(",")
cuda_common.build([c + "_attention" for c in checks])
errs, fails = {}, []
if "flash" in checks:
    cs.phase_flash_kernels(errs, dtypes=[getattr(torch, d) for d in dtypes],
                           failures=fails)
if "paged" in checks:
    cs.phase_paged_kernels(errs, failures=fails)
print("RESULT " + json.dumps({"errs": errs, "failures": fails}))
"""


def edited_tree(dst: Path, name: str, fname=None, edits=()) -> Path:
    """A copy of this checkout's port and chip_smoke.py in ``dst`` with
    each (original, new) text of ``edits`` replaced in ``csrc/<fname>``;
    each original must be there exactly once."""
    shutil.copytree(ROOT / "mxnet_tpu_torch", dst / "mxnet_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if fname is not None:
        path = dst / "mxnet_tpu_torch" / "csrc" / fname
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: '{old}' is in {fname} "
                                 f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def run_in(tree: Path, name: str, code: str, *args, timeout=1200) -> dict:
    """Run ``code`` with ``args`` in ``tree`` as a process of its own and
    return the JSON of its last ``RESULT`` line."""
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=tree,
                         capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"{name}: run failed ({out.returncode})\n"
                         f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def run_variant(name: str, fname, checks, dtypes, edits) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        tree = edited_tree(Path(tmp), name, fname, edits)
        return run_in(tree, name, RUN, ",".join(checks), ",".join(dtypes))


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=sorted(FAULTS),
                    help="plant only these faults (the unmodified copy "
                         "runs first all the same)")
    args = ap.parse_args()
    bad = []
    variants = [("unmodified", None, ("flash", "paged"), (F32, BF16), [], [])]
    variants += [(n, fname, (checks,), dtypes, must, edits)
                 for n, (fname, checks, dtypes, must, edits) in FAULTS.items()
                 if args.only is None or n in args.only]
    for name, fname, checks, dtypes, must, edits in variants:
        row = summary(name, run_variant(name, fname, checks, dtypes, edits))
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

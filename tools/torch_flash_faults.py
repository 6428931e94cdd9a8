#!/usr/bin/env python3
"""Show that chip_smoke.py's checks of the bf16 flash backward see a wrong
kernel.

    python3 tools/torch_flash_faults.py

Needs one H100. Copies the port and chip_smoke.py into a temporary
directory, plants each fault below in the copy's
``csrc/flash_attention.cu`` (the bf16 tensor-core kernels only; the
checkout is not touched), builds the copy and runs chip_smoke's bf16 flash
checks there (``phase_flash_kernels``, every case of FLASH_CASES at head
dims 64 and 128), collecting every failing check instead of stopping at
the first. The unmodified copy runs first. Prints one JSON line per
variant: the largest error of each check against the exact and the
rounded plain version, and how many checks failed. Exits non-zero if the
unmodified kernels fail a check or a planted fault passes both checks of
a kernel it changes.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# name -> (kernels it changes, [(original text, planted text)])
FAULTS = {
    # ds = p * dp: the "- di" term dropped, in both kernels
    "no_di": (("flash_bwd_dkv", "flash_bwd_dq"), [
        ("dp[j][e] = p * (dp[j][e] - dis[c]);", "dp[j][e] = p * dp[j][e];"),
        ("dp[j][e] = p * (dp[j][e] - di_r[h]);", "dp[j][e] = p * dp[j][e];"),
    ]),
    # the element mask of the tiles on the causal frontier lets one more key
    # through
    "mask_shift": (("flash_bwd_dkv", "flash_bwd_dq"), [
        ("(causal && key > row + off)", "(causal && key > row + off + 1)"),
        ("(causal && col > row + off)", "(causal && col > row + off + 1)"),
    ]),
}

RUN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mxnet_tpu_torch.ops import cuda_common
torch.backends.cuda.matmul.allow_tf32 = False
cuda_common.build(["flash_attention"])
errs, fails = {}, []
cs.phase_flash_kernels(errs, dtypes=(torch.bfloat16,), failures=fails)
print("RESULT " + json.dumps({"errs": errs, "failures": fails}))
"""


def run_variant(src: Path, name: str, edits) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        dst = Path(tmp)
        shutil.copytree(src / "mxnet_tpu_torch", dst / "mxnet_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(src / "chip_smoke.py", dst / "chip_smoke.py")
        cu = dst / "mxnet_tpu_torch" / "csrc" / "flash_attention.cu"
        text = cu.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: '{old}' is not in the source once")
            text = text.replace(old, new)
        cu.write_text(text)
        out = subprocess.run([sys.executable, "-c", RUN], cwd=dst,
                             capture_output=True, text=True, timeout=1200)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    if out.returncode != 0 or not lines:
        raise SystemExit(f"{name}: run failed ({out.returncode})\n"
                         f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def summary(name, res):
    errs, fails = res["errs"], res["failures"]
    row = {"variant": name, "failed_checks": len(fails)}
    for kern in ("flash_bwd_dkv", "flash_bwd_dq"):
        for check, key in (("exact", ""), ("rounded", "_rounded")):
            row[f"{kern}_{check}_max_abs_err"] = errs.get(kern + "_bf16" + key)
            grads = ("dk", "dv") if kern == "flash_bwd_dkv" else ("dq",)
            prefix = "flash_bwd_rounded " if key else "flash_bwd "
            row[f"{kern}_{check}_failed"] = sum(
                m.startswith(prefix) and m.split()[1] in grads for m in fails)
    row["first_failures"] = fails[:4]
    return row


def main():
    bad = []
    for name, (kernels, edits) in [("unmodified", ((), []))] + list(FAULTS.items()):
        row = summary(name, run_variant(ROOT, name, edits))
        print(json.dumps(row), flush=True)
        if name == "unmodified" and row["failed_checks"]:
            bad.append("the unmodified kernels fail a check")
        for kern in kernels:
            for check in ("exact", "rounded"):
                if not row[f"{kern}_{check}_failed"]:
                    bad.append(f"{name}: {kern} passes the {check} check")
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()

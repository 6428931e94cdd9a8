#!/usr/bin/env python3
"""Show that chip_smoke.py's checks of the tensor-core flash kernels (bf16,
and f32 in 3xTF32) and of the paged read (split-key decode, 3xTF32
prefill) see a wrong kernel.

    python3 tools/torch_flash_faults.py [--only NAME ...]

Needs one H100. Copies the port and chip_smoke.py into a temporary
directory, plants each fault below in the copy's ``csrc/`` (the checkout is
not touched), builds the copy and runs chip_smoke's checks of that kernel
there: the flash checks (``phase_flash_kernels``, every case of FLASH_CASES
at head dims 64 and 128, in the fault's dtype), the paged checks
(``phase_paged_kernels``, every case of PAGED_CASES and PAGED_DTYPES), or
both where the fault sits in code that both kernels share (tf32x3.cuh,
mma_sm90.cuh), collecting every failing check instead of stopping at the
first. The
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

# name -> (file under csrc/, checks: of "flash" and "paged", flash dtypes,
#          [(check, outputs)] of which each must fail at least once,
#          [(original text, planted text)]); a check's outputs are dk, dv,
#          dq, out or lse for flash, the (q, pool) dtypes for paged, None
#          for any
FAULTS = {
    # bf16 backward: ds = p * dp, the "- di" term dropped, in both kernels
    "bwd_no_di": ("flash_attention.cu", ("flash",), (BF16,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("dp[j][e] = p * (dp[j][e] - dis[c]);", "dp[j][e] = p * dp[j][e];"),
        ("dp[j][e] = p * (dp[j][e] - di_r[h]);", "dp[j][e] = p * dp[j][e];"),
    ]),
    # bf16 backward: the element mask of the tiles on the causal frontier
    # lets one more key through
    "bwd_mask_shift": ("flash_attention.cu", ("flash",), (BF16,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd_rounded", ("dk", "dv")),
        ("flash_bwd", ("dq",)), ("flash_bwd_rounded", ("dq",))], [
        ("(causal && key > row + off)", "(causal && key > row + off + 1)"),
        ("(causal && col > row + off)) p = 0.f;",
         "(causal && col > row + off + 1)) p = 0.f;"),
    ]),
    # bf16 forward: the O accumulator is not rescaled when the row max moves
    "fwd_no_corr": ("flash_attention.cu", ("flash",), (BF16,), [
        ("flash_fwd", ("out",)), ("flash_fwd_rounded", ("out",))], [
        ("acc[j][e] *= corr[e >> 1];", "acc[j][e] *= 1.f;"),
    ]),
    # bf16 forward: the causal mask lets one more key through
    "fwd_mask_shift": ("flash_attention.cu", ("flash",), (BF16,), [
        ("flash_fwd", ("out", "lse")), ("flash_fwd_rounded", ("out", "lse"))], [
        ("(causal && col > row + off)) x = -INFINITY;",
         "(causal && col > row + off + 1)) x = -INFINITY;"),
    ]),
    # f32 backward (3xTF32): the "- di" term dropped, in both kernels
    "f32_bwd_no_di": ("flash_attention.cu", ("flash",), (F32,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd", ("dq",))], [
        ("dst[j][e] = p * (dst[j][e] - di_t[c]);", "dst[j][e] = p * dst[j][e];"),
        ("ds[j][e] = p * (ds[j][e] - di_q[h]);", "ds[j][e] = p * ds[j][e];"),
    ]),
    # f32 flash and paged prefill: one TF32 product instead of three (the lo
    # terms dropped), which only the tight checks of the flash kernels can
    # see, and the paged prefill's f32 check
    "f32_1xtf32": ("mma_sm90.cuh", ("flash", "paged"), (F32,), [
        ("flash_bwd_tight", ("dk", "dv")), ("flash_bwd_tight", ("dq",)),
        ("flash_fwd_tight", ("out",)),
        ("paged_attention_prefill", ("float32",))], [
        ("  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_lo, b_hi[j][0], b_hi[j][1]);\n"
         "#pragma unroll\n"
         "  for (int j = 0; j < JC; ++j) mma_tf32(c[j], a_hi, b_lo[j][0], b_lo[j][1]);\n",
         ""),
    ]),
    # f32 flash and paged prefill: the second B row of the accumulating
    # products read in mma order (k-slot t + 4) instead of the C fragment's
    # (row 2t + 1)
    "f32_b_unpermuted": ("tf32x3.cuh", ("flash", "paged"), (F32,), [
        ("flash_bwd", ("dk", "dv")), ("flash_bwd", ("dq",)),
        ("flash_fwd", ("out",)), ("paged_attention_prefill", None)], [
        ("const TB* b_row1 = b_row0 + LDB;",
         "const TB* b_row1 = tile + (t + 4) * LDB + g;"),
    ]),
    # f32 forward and paged prefill (their shared online softmax): the O
    # accumulator is not rescaled when a row's max moves
    "f32_fwd_no_corr": ("tf32x3.cuh", ("flash", "paged"), (F32,), [
        ("flash_fwd", ("out",)), ("paged_attention_prefill", None)], [
        ("acc[j][e] = fmaf(acc[j][e], corr[e >> 1], pv[j][e]);",
         "acc[j][e] += pv[j][e];"),
    ]),
    # paged decode: the combine merges every live split but the last
    "paged_no_last_split": ("paged_attention.cu", ("paged",), (), [
        ("paged_attention", None)], [
        ("for (int sp = 0; sp < n_live; ++sp) {",
         "for (int sp = 0; sp < n_live - 1; ++sp) {"),
    ]),
    # paged decode: the live splits counted one key off, so a frontier on
    # the first key of a split leaves that split out
    "paged_split_off": ("paged_attention.cu", ("paged",), (), [
        ("paged_attention", None)], [
        ("const int n_live = last_key / split_keys + 1;",
         "const int n_live = (last_key - 1) / split_keys + 1;"),
    ]),
    # paged prefill: each query's frontier one key too far
    "paged_prefill_frontier": ("paged_attention.cu", ("paged",), (), [
        ("paged_attention_prefill", None)], [
        ("fr[hh] = r < nq ? min(pos + q0 + r, cap - 1) : -1;",
         "fr[hh] = r < nq ? min(pos + q0 + r + 1, cap - 1) : -1;"),
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

# The prefill read split over the key range, as the decode read is: the
# design alternative that tools/torch_flash_ab.py --plans times against one
# split. Each live split of a (row, head, query tile) writes its partial
# (m, l, o) to `part`; the last to arrive merges them in split order. Its
# arrival counters are bh * ceil(Tq / 64): the wrapper's cached buffer
# (1024 counters at least) holds those of --plans' shapes.
_PREFILL_MERGE = r"""  if (n_live == 1) {
    tf32x3::store_rows<CH>(out + q_base, acc, warp * 16, nq, lane, inv);
    return;
  }
  const int n_splits = gridDim.z;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= nq) continue;
    float* rec = part + ((static_cast<size_t>(bh) * Tq + q0 + r) * n_splits + split) * (CH + 2);
    if (t == 0) {
      rec[0] = m[hh];
      rec[1] = l[hh];
    }
#pragma unroll
    for (int j = 0; j < CH / 8; ++j)
      tf32x3::store2(rec + 2 + 8 * j + 2 * t, acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* slot = arrivals + static_cast<size_t>(bh) * gridDim.y + blockIdx.y;
    is_last = atomicAdd(slot, 1) == n_live - 1;
    if (is_last) *slot = 0;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  constexpr int CPL = (CH + 31) / 32;
  for (int qi = warp; qi < nq; qi += PW) {
    const float* recs = part + (static_cast<size_t>(bh) * Tq + q0 + qi) * n_splits * (CH + 2);
    float mx = -INFINITY;
    for (int sp = 0; sp < n_live; ++sp) mx = fmaxf(mx, __ldcg(recs + sp * (CH + 2)));
    float den = 0.f, o[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) o[c] = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {
      const float* rec = recs + sp * (CH + 2);
      const float f = __ldcg(rec) == -INFINITY ? 0.f : exp2f(__ldcg(rec) - mx);
      den = fmaf(__ldcg(rec + 1), f, den);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int ch = lane + 32 * c;
        if (ch < CH) o[c] = fmaf(__ldcg(rec + 2 + ch), f, o[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int ch = lane + 32 * c;
      if (ch < CH) out[q_base + qi * CH + ch] = from_f32<TQ>(den > 0.f ? o[c] / den : 0.f);
    }
  }
"""
_PREFILL_SPLIT = [
    ("const int* __restrict__ position, TQ* __restrict__ out, int H, int Tq,\n"
     "                        int ps, int n_pages, int n_pool, float scale) {",
     "const int* __restrict__ position, TQ* __restrict__ out,\n"
     "                        float* __restrict__ part, int* __restrict__ arrivals, int H,\n"
     "                        int Tq, int ps, int n_pages, int n_pool, int split_keys,\n"
     "                        float scale) {\n  __shared__ int is_last;"),
    ("const int q0 = (gridDim.y - 1 - blockIdx.y) * PQ;",
     "const int q0 = (gridDim.y - 1 - blockIdx.y) * PQ, split = blockIdx.z;"),
    ("  const int n_tiles = last_key / PK + 1;\n",
     "  const int n_live = last_key / split_keys + 1;\n"
     "  if (split >= n_live) return;\n"
     "  const int k_begin = split * split_keys;\n"
     "  const int n_tiles = (min(k_begin + split_keys, last_key + 1) - k_begin + PK - 1) / PK;\n"),
    ("  load_kv_tile(0, 0);", "  load_kv_tile(k_begin, 0);"),
    ("const int k0 = it * PK, st = it & 1;",
     "const int k0 = k_begin + it * PK, st = it & 1;"),
    ("  tf32x3::store_rows<CH>(out + q_base, acc, warp * 16, nq, lane, inv);\n",
     _PREFILL_MERGE),
    ("    dim3 grid(a.B * a.H, (a.Tq + PQ - 1) / PQ);",
     "    dim3 grid(a.B * a.H, (a.Tq + PQ - 1) / PQ, a.n_splits);"),
    ("static_cast<TQ*>(a.out), a.H, a.Tq, a.ps,\n        a.n_pages, a.n_pool, scale);",
     "static_cast<TQ*>(a.out),\n        static_cast<float*>(a.part), static_cast<int*>(a.arrivals), "
     "a.H, a.Tq, a.ps,\n        a.n_pages, a.n_pool, a.split_keys, scale);"),
    ("(n_splits > 1 && (Tq > 1 || part == nullptr", "(n_splits > 1 && (part == nullptr"),
]

# Design alternatives that PERF.md reports, as edits of this checkout: name
# -> (file under csrc/, [(original text, variant text)]); the f32 backward's
# and the paged prefill's
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
    # the paged prefill read split over the key range (see _PREFILL_SPLIT)
    "prefill_split": ("paged_attention.cu", _PREFILL_SPLIT),
    # the paged prefill read with 32 queries a block (2 warps) for 64
    "prefill_rows32": ("paged_attention.cu", [
        ("constexpr int PW = 4;", "constexpr int PW = 2;")]),
    # the f32 forward with each key tile's P V summed straight into the O
    # accumulator (rescaled first) instead of apart and added by add_tile
    "one_accumulator": ("flash_attention.cu", [(
        "    accumulate<D, BK, LD>(pv, s, vt, lane);  // this tile's p v\n"
        "    add_tile<D>(acc, corr, pv);               // o = o corr + p v\n",
        "    add_tile<D>(acc, corr, pv);  // pv is 0: o = o corr\n"
        "    accumulate<D, BK, LD>(acc, s, vt, lane);\n")]),
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
    variants += [(n, fname, checks, dtypes, must, edits)
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

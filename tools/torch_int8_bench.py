#!/usr/bin/env python3
"""The INT8 kernels of ``mxnet_tpu_torch/csrc/int8_gemm.cu`` on one card at
resnet50_v1's shapes at B=32 and its Dense: the im2col from the f32
activation and the s8 x s8 -> s32 product with its requantisation, each
design held against the plain versions and timed, beside ``torch._int_mm``.

    python3 tools/torch_int8_bench.py [--source NAME=FILE.cu ...]
                                      [--plans BN,SPLITS ...]

Designs: the tree's, through the package's wrappers (the im2col quantises
the f32 activation itself; the product takes ``gemm_plan``'s route), and
each ``--source``, built as the package builds its kernels: one with the
tree's C entry points (``mx_int8_gemm_wgmma`` among them) runs through the
same wrappers with its library in the tree's place; one with the earlier
entry points (``mx_int8_im2col`` on an int8 activation, ``mx_int8_gemm``)
is called directly, its im2col timed with the quantisation passes it needs
before it (``_quantize``: divide, round, clamp, cast), as the main path ran
them. Every design's patches and f32 NCHW output are checked against
``int8_im2col_plain`` and ``int8_gemm_plain`` (exactly: it fails on any
difference); then each is timed by CUDA graph replay (``chip_smoke.graph_time_ms``) in turns (the
designs in order, then in reverse), with ``torch._int_mm`` on the same
zero-padded operands as the library yardstick (the port never calls it).
``--plans`` also times the tree's ``wgmma`` route at other tile widths and
K splits. Bounds (µs): the product's bytes (patches, weight, f32 output)
at 3.35 TB/s or its operations at 1,979 int8 TOPS, the larger; the
im2col's f32 input read once and patches written once. Prints the card's
name and power limit, what ``ptxas`` said of each design, then one JSON
line per shape. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# (name, B, C, H, W, O, kernel, stride, pad) at resnet50_v1's B=32; the
# Dense as a 1x1 convolution of a 1x1 image
SHAPES = (("res4 3x3", 32, 256, 14, 14, 256, 3, 1, 1),
          ("res5 3x3", 32, 512, 7, 7, 512, 3, 1, 1),
          ("stem", 32, 3, 224, 224, 64, 7, 2, 3),
          ("res2 3x3", 32, 64, 56, 56, 64, 3, 1, 1),
          ("res3 1x1", 32, 512, 28, 28, 128, 1, 1, 0),
          ("dense", 32, 2048, 1, 1, 1000, 1, 1, 0))
HBM, INT8_OPS = 3.35e12, 1979e12
# the earlier C entry points: (x, out), B, C, H, W, G, KH, KW, stride, pad,
# dilate, OH, OW, K_pad, stream; the product's as the tree's mx_int8_gemm
OLD_IM2COL = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 16 + [ctypes.c_void_p]


def _build(name, source):
    """The design's library, whether it has the tree's entry points, and
    what ptxas said of it."""
    from mxnet_tpu_torch.ops import cuda_common as cc

    cc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cc.BUILD_DIR / f"libint8_gemm-{name}-variant.so"
    log = subprocess.run([cc._nvcc(), *cc.NVCC_FLAGS, "-I", str(cc.CSRC),
                          "-o", str(out), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True, timeout=600).stdout
    lib = ctypes.CDLL(str(out))
    like_tree = hasattr(lib, "mx_int8_gemm_wgmma")
    for fn, types in cc._ARGTYPES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
    if not like_tree:
        lib.mx_int8_im2col.argtypes = OLD_IM2COL
    lib.mx_error_string.argtypes = [ctypes.c_int]
    lib.mx_error_string.restype = ctypes.c_char_p
    return lib, like_tree, [line for line in log.splitlines()
                            if "registers" in line or "Performance" in line]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=FILE.cu")
    ap.add_argument("--plans", nargs="*", default=[], metavar="BN,SPLITS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_int8_bench: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mxnet_tpu_torch.contrib import quantization as Q
    from mxnet_tpu_torch.ops import cuda_common as cc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tree = cc.build(["int8_gemm"])["int8_gemm"]
    print("[tree] " + "; ".join(
        line for line in tree.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "Performance" in line), flush=True)
    old, variants = {}, {}
    for spec in args.source:
        name, src = spec.split("=", 1)
        lib, like_tree, ptxas = _build(name, pathlib.Path(src))
        (variants if like_tree else old)[name] = lib
        print(f"[{name}] {src}: " + "; ".join(ptxas), flush=True)
    tree_lib = cc.load("int8_gemm")

    @contextlib.contextmanager
    def library(n):
        """The wrappers launch design n's kernels inside."""
        cc._libs["int8_gemm"] = variants.get(n, tree_lib)
        try:
            yield
        finally:
            cc._libs["int8_gemm"] = tree_lib
    plans = [tuple(int(v) for v in p.split(",")) for p in args.plans]
    gen = torch.Generator(device="cuda").manual_seed(3)

    for name, b, c, h, w, o, k, s, p in SHAPES:
        x = torch.randn((b, c, h, w), device="cuda", generator=gen)
        ds = x.abs().amax() / 127.0 + 1e-12
        wt = torch.randint(-127, 128, (o, c, k, k), generator=gen,
                           device="cuda", dtype=torch.int8)
        kk = wt[0].numel()
        kp, oh = Q.k_padded(kk), (h + 2 * p - k) // s + 1
        m = b * oh * oh
        geo = ((k, k), (s, s), (p, p), (1, 1), 1)
        w2 = torch.zeros((o, kp), dtype=torch.int8, device="cuda")
        w2[:, :kk] = wt.reshape(o, kk)
        ws = torch.rand(o, device="cuda", generator=gen) * 1e-2
        want_cols = Q.int8_im2col_plain(Q._quantize(x, ds), *geo, kp)
        want = Q.int8_gemm_plain(want_cols, w2, kk, ds, ws, None, "float32",
                                 1, oh * oh).reshape(b, o, oh * oh)
        plan = Q.gemm_plan(m, o, kk, 1, kp, kp, True, Q._sm_count(x.device))
        cols = {}
        outs = {}

        def im2col(n):
            if n == "tree" or n in variants:
                def run():
                    with library(n):
                        cols[n] = Q.int8_im2col(x, *geo, kp, ds)
                return run
            cols[n] = torch.empty((1, m, kp), dtype=torch.int8,
                                  device="cuda")

            def run():
                xq = Q._quantize(x, ds)
                old[n].mx_int8_im2col(xq.data_ptr(), cols[n].data_ptr(), b,
                                      c, h, w, 1, k, k, s, s, p, p, 1, 1,
                                      oh, oh, kp, _stream())
            return run

        def gemm(n, pl=None):
            if n == "tree" or n in variants:
                def run():
                    with library(n):
                        outs[n] = Q._int8_gemm(cols[n], w2, kk, ds, ws, None,
                                               "float32", 1, oh * oh, pl)
                return run
            outs[n] = torch.empty((b, o, oh * oh), device="cuda")
            return lambda: old[n].mx_int8_gemm(
                cols[n].data_ptr(), w2.data_ptr(), outs[n].data_ptr(),
                ds.data_ptr(), ws.data_ptr(), None, m, o, kk, kp, kp, m * kp,
                o * kp, 1, oh * oh, 0, _stream())

        names = ["tree"] + list(variants) + list(old)
        runs = {n: (im2col(n), gemm(n)) for n in names}
        for n in names:
            runs[n][0]()
            runs[n][1]()
        torch.cuda.synchronize()
        for n in names:
            got = outs[n].reshape(b, o, oh * oh)
            if not (torch.equal(cols[n], want_cols) and torch.equal(got, want)):
                raise SystemExit(f"{n}: differs from the plain versions at "
                                 f"{name}")
        times = {n: {"im2col_us": [], "gemm_us": []} for n in names}
        for n in names + names[::-1]:
            times[n]["im2col_us"].append(cs.graph_time_ms(runs[n][0]) * 1e3)
            times[n]["gemm_us"].append(cs.graph_time_ms(runs[n][1]) * 1e3)
        plan_us = {}
        for bn, splits in plans:
            if splits <= -(-kk // Q.GEMM_BK):
                alt = ("wgmma", bn, splits)
                gemm("tree", alt)()
                torch.cuda.synchronize()
                if not torch.equal(outs["tree"].reshape(b, o, oh * oh), want):
                    raise SystemExit(f"plan {alt} differs at {name}")
                plan_us[f"{bn},{splits}"] = cs.graph_time_ms(
                    gemm("tree", alt)) * 1e3
        mma_us = cs.graph_time_ms(gemm("tree", ("mma", 0, 1))) * 1e3
        xq = Q._quantize(x, ds)
        int8_in_us = cs.graph_time_ms(
            lambda: Q.int8_im2col(xq, *geo, kp)) * 1e3
        lib_us = cs.graph_time_ms(lambda: torch._int_mm(want_cols[0],
                                                        w2.t())) * 1e3
        gemm_bound = max((m * kp + o * kp + 4 * m * o) / HBM,
                         2 * m * o * kk / INT8_OPS) * 1e6
        im2col_bound = (4 * x.numel() + m * kp) / HBM * 1e6
        print(json.dumps({"shape": name, "M": m, "K": kk, "K_pad": kp,
                          "N": o, "plan": plan, "designs": times,
                          "tree_mma_route_us": mma_us, "plans_us": plan_us,
                          "tree_im2col_int8_input_us": int8_in_us,
                          "int_mm_us": lib_us, "gemm_bound_us": gemm_bound,
                          "im2col_bound_us": im2col_bound, "exact": True}),
              flush=True)


if __name__ == "__main__":
    main()

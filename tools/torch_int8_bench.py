#!/usr/bin/env python3
"""The INT8 kernels of ``mxnet_tpu_torch/csrc/int8_gemm.cu`` (the im2col and
the s8 x s8 -> s32 product with its requantisation) on one card, at
resnet50_v1's shapes at B=32 and its Dense, each design held against the
plain versions and timed, beside ``torch._int_mm``.

    python3 tools/torch_int8_bench.py [--source NAME=FILE.cu ...]

Builds the tree's source and each ``--source`` (a design alternative with
the same C entry points, ``mx_int8_im2col`` and ``mx_int8_gemm``) as the
package builds its kernels, calls the entry points directly, checks every
design's patches and f32 NCHW output against ``int8_im2col_plain`` and
``int8_gemm_plain`` (exactly: it fails on any difference), then times
each by CUDA graph replay (``chip_smoke.graph_time_ms``) in turns (the
designs in order, then in reverse), with ``torch._int_mm`` on the same
zero-padded operands as the library yardstick (the port never calls it).
Prints the card's name and power limit, what ``ptxas`` said of each
design (registers, shared memory), then one JSON line per shape. Needs
CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
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


def _build(name, source):
    from mxnet_tpu_torch.ops import cuda_common as cc

    cc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cc.BUILD_DIR / f"libint8_gemm-{name}-variant.so"
    log = subprocess.run([cc._nvcc(), *cc.NVCC_FLAGS, "-I", str(cc.CSRC),
                          "-o", str(out), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True, timeout=600).stdout
    lib = ctypes.CDLL(str(out))
    for fn in ("mx_int8_im2col", "mx_int8_gemm"):
        getattr(lib, fn).argtypes = cc._ARGTYPES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, [line for line in log.splitlines() if "registers" in line]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=FILE.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_int8_bench: CUDA is not available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from mxnet_tpu_torch.contrib import quantization as Q

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sources = [("tree", ROOT / "mxnet_tpu_torch/csrc/int8_gemm.cu")] + \
        [(s.split("=", 1)[0], pathlib.Path(s.split("=", 1)[1]))
         for s in args.source]
    libs = {}
    for name, src in sources:
        libs[name], ptxas = _build(name, src)
        print(f"[{name}] {src}: " + "; ".join(ptxas), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)

    def q(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    for name, b, c, h, w, o, k, s, p in SHAPES:
        x, wt = q(b, c, h, w), q(o, c, k, k)
        kk = wt[0].numel()
        kp, oh = Q.k_padded(kk), (h + 2 * p - k) // s + 1
        m = b * oh * oh
        w2 = torch.zeros((o, kp), dtype=torch.int8, device="cuda")
        w2[:, :kk] = wt.reshape(o, kk)
        ws = torch.rand(o, device="cuda", generator=gen) * 1e-2
        ds = torch.full((), 0.0123, device="cuda")
        cols = {n: torch.empty((1, m, kp), dtype=torch.int8, device="cuda")
                for n in libs}
        outs = {n: torch.empty((b, o, oh * oh), device="cuda") for n in libs}

        def im2col(n):
            return lambda: libs[n].mx_int8_im2col(
                x.data_ptr(), cols[n].data_ptr(), b, c, h, w, 1, k, k, s, s,
                p, p, 1, 1, oh, oh, kp, _stream())

        def gemm(n):
            return lambda: libs[n].mx_int8_gemm(
                cols[n].data_ptr(), w2.data_ptr(), outs[n].data_ptr(),
                ds.data_ptr(), ws.data_ptr(), None, m, o, kk, kp, kp, m * kp,
                o * kp, 1, oh * oh, 0, _stream())

        want_cols = Q.int8_im2col_plain(x, (k, k), (s, s), (p, p), (1, 1), 1,
                                        kp)
        want = Q.int8_gemm_plain(want_cols, w2, kk, ds, ws, None, "float32", 1,
                                 oh * oh).reshape(b, o, oh * oh)
        for n in libs:
            if im2col(n)() or gemm(n)():
                raise SystemExit(f"{n}: a launch failed at {name}")
        torch.cuda.synchronize()
        for n in libs:
            if not (torch.equal(cols[n], want_cols)
                    and torch.equal(outs[n], want)):
                raise SystemExit(f"{n}: differs from the plain versions at "
                                 f"{name}")
        names = list(libs)
        times = {n: {"im2col_us": [], "gemm_us": []} for n in names}
        for n in names + names[::-1]:
            times[n]["im2col_us"].append(cs.graph_time_ms(im2col(n)) * 1e3)
            times[n]["gemm_us"].append(cs.graph_time_ms(gemm(n)) * 1e3)
        lib_us = cs.graph_time_ms(lambda: torch._int_mm(cols[names[0]][0],
                                                        w2.t())) * 1e3
        print(json.dumps({"shape": name, "M": m, "K": kk, "K_pad": kp,
                          "N": o, "designs": times, "int_mm_us": lib_us,
                          "exact": True}), flush=True)


if __name__ == "__main__":
    main()

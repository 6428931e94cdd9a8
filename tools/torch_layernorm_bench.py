#!/usr/bin/env python3
"""LayerNorm's kernel design choices on one card: the rows (warps) a block
of the forward's warp route, the widest row that route takes, and the
backward's warps a block and grid, each held against the plain versions
and timed.

    python3 tools/torch_layernorm_bench.py [--source FILE.cu] [--only DIR]

Calls the C entry points of ``mxnet_tpu_torch/csrc/layernorm.cu``
(``mx_layernorm``, ``mx_layernorm_bwd``) directly with each choice, at the
paths' shapes (8, 512 and 4096 rows of 1024 in f32, 4096 rows in bf16) and
at d = 2048: each variant's output against ``layer_norm_plain`` or
``layer_norm_bwd`` at chip_smoke.py's tolerances (it fails on a
violation), then its device time by CUDA graph replay
(``chip_smoke.graph_time_ms``) beside the byte bound and the plain
version's time. ``warps`` 0 is the
block route (one block of 256 threads a row). Prints the card's name and
power limit, what ``ptxas`` said of each kernel (registers, spills),
then one JSON line per variant. The port's choices are ``FWD_WARPS``,
``FWD_WARP_MAX_BYTES``, ``BWD_WARPS`` and ``BWD_BLOCKS_PER_SM`` in
``mxnet_tpu_torch/ops/layernorm.py``. With ``--source`` it builds and times
another version of the source instead (a design alternative with the same
C entry points), so that two designs can be compared in one call. Needs
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

FWD_SHAPES = ((8, 1024, torch.float32), (512, 1024, torch.float32),
              (4096, 1024, torch.float32), (4096, 1024, torch.bfloat16),
              (512, 2048, torch.float32), (4096, 2048, torch.float32),
              (4096, 2048, torch.bfloat16))
FWD_WARPS = (0, 1, 2, 4, 8)
BWD_SHAPES = ((512, 1024, torch.float32), (4096, 1024, torch.float32),
              (4096, 1024, torch.bfloat16))
BWD_WARPS = (0, 2, 4, 8)
BWD_BLOCKS_PER_SM = (1, 2, 3, 4)


def _build(source):
    """Build ``source`` as the package builds its kernels; returns the
    loaded library and what ptxas said."""
    from mxnet_tpu_torch.ops import cuda_common as cc

    cc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = cc.BUILD_DIR / f"lib{source.stem}-variant.so"
    log = subprocess.run([cc._nvcc(), *cc.NVCC_FLAGS, "-I", str(cc.CSRC),
                          "-o", str(out), str(source)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, check=True, timeout=600).stdout
    lib = ctypes.CDLL(str(out))
    for fn in ("mx_layernorm", "mx_layernorm_bwd"):
        getattr(lib, fn).argtypes = cc._ARGTYPES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.mx_error_string.argtypes = [ctypes.c_int]
    lib.mx_error_string.restype = ctypes.c_char_p
    return lib, log


def _ptxas(log):
    """(kernel, registers, spill stores) from ptxas -v's output."""
    fn = spill = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip().split(", ")[1]
        elif "registers" in line and fn is not None:
            yield fn, line.split("Used ")[1].split(",")[0], spill


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=pathlib.Path, default=None,
                    help="time this version of csrc/layernorm.cu instead")
    ap.add_argument("--only", choices=("forward", "backward"), default=None,
                    help="time one direction only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_layernorm_bench: CUDA is not available")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import cuda_common as cc
    from mxnet_tpu_torch.ops import layernorm as ln

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    if args.source is None:
        lib = cc.load("layernorm")
        log = cc.build(["layernorm"])["layernorm"].with_suffix(".log") \
            .read_text()
    else:
        lib, log = _build(args.source.resolve())
    source = str(args.source or "mxnet_tpu_torch/csrc/layernorm.cu")
    for fn, regs, spill in _ptxas(log):
        print(f"[ptxas] {source}: {fn}: {regs}, {spill}", flush=True)
    sms = ln._sm_count(dev)
    gen = torch.Generator().manual_seed(3)

    def fwd(x, g, b, warps):
        rows, d = x.shape
        out = torch.empty_like(x)
        rc = lib.mx_layernorm(x.data_ptr(), g.data_ptr(), b.data_ptr(),
                              out.data_ptr(), rows, d, 1e-5,
                              cc.dtype_code(x.dtype), cc.dtype_code(g.dtype),
                              warps, cc.stream_ptr(dev))
        cc.check_launch(lib, rc, f"layer_norm warps={warps}")
        return out

    def bwd(x, g, cot, warps, blocks):
        rows, d = x.shape
        dx = torch.empty_like(x)
        dgamma, dbeta = torch.empty_like(g), torch.empty_like(g)
        partial = torch.empty((blocks, 2 * d), dtype=torch.float32,
                              device=dev)
        rc = lib.mx_layernorm_bwd(
            x.data_ptr(), g.data_ptr(), cot.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr(), partial.data_ptr(), rows, d,
            1e-5, cc.dtype_code(x.dtype), cc.dtype_code(g.dtype), warps,
            blocks, cc.stream_ptr(dev))
        cc.check_launch(lib, rc, f"layer_norm backward warps={warps}")
        return dx, dgamma, dbeta

    for rows, d, dtype in FWD_SHAPES if args.only != "backward" else ():
        x, g, b, _ = cs._ln_case(gen, rows, d, 0, dtype, dtype, dev)
        size = x.element_size()
        bound = size * 2 * (x.numel() + d) / cs.HBM_BYTES_PER_S * 1e3
        want = ln.layer_norm_plain(x, g, b)
        shape = f"({rows}, {d}) {str(dtype)[6:]}"
        print(json.dumps({"kernel": "forward plain", "shape": shape,
                          "us": cs.graph_time_ms(
                              lambda: ln.layer_norm_plain(x, g, b)) * 1e3,
                          "bound_us": bound * 1e3}), flush=True)
        for warps in FWD_WARPS:
            try:
                got = fwd(x, g, b, warps)
            except MXNetError as e:  # a route this source does not take
                print(json.dumps({"kernel": "forward", "source": source,
                                  "shape": shape, "warps": warps,
                                  "refused": str(e)}), flush=True)
                continue
            torch.cuda.synchronize()
            err = cs.check_close("layernorm", dtype, got, want,
                                 f"forward {shape} warps={warps}")
            ms = cs.graph_time_ms(lambda: fwd(x, g, b, warps))
            print(json.dumps({"kernel": "forward", "source": source,
                              "shape": shape, "warps": warps, "us": ms * 1e3,
                              "bound_us": bound * 1e3,
                              "max_abs_err": err}), flush=True)
        del x, g, b, want
    for rows, d, dtype in BWD_SHAPES if args.only != "forward" else ():
        x, g, _, cot = cs._ln_case(gen, rows, d, 0, dtype, dtype, dev)
        size = x.element_size()
        bound = size * 3 * (x.numel() + d) / cs.HBM_BYTES_PER_S * 1e3
        wants = ln.layer_norm_bwd(x, g, cot, 1e-5)
        shape = f"({rows}, {d}) {str(dtype)[6:]}"
        print(json.dumps({"kernel": "backward plain", "shape": shape,
                          "us": cs.graph_time_ms(
                              lambda: ln.layer_norm_bwd(x, g, cot, 1e-5))
                          * 1e3, "bound_us": bound * 1e3}), flush=True)
        for warps in BWD_WARPS:
            for per_sm in BWD_BLOCKS_PER_SM:
                blocks = min(-(-rows // max(warps, 1)), per_sm * sms)
                try:
                    grads = bwd(x, g, cot, warps, blocks)
                except MXNetError as e:
                    print(json.dumps({"kernel": "backward", "source": source,
                                      "shape": shape, "warps": warps,
                                      "refused": str(e)}), flush=True)
                    break
                torch.cuda.synchronize()
                err = max(cs.check_close(
                    "layernorm_grad", a.dtype, a, r,
                    f"backward {name} {shape} warps={warps} "
                    f"blocks={blocks}")
                    for a, r, name in zip(grads, wants,
                                          ("dx", "dgamma", "dbeta")))
                ms = cs.graph_time_ms(lambda: bwd(x, g, cot, warps, blocks))
                print(json.dumps({"kernel": "backward", "source": source,
                                  "shape": shape, "warps": warps, "blocks_per_sm": per_sm,
                                  "blocks": blocks, "us": ms * 1e3,
                                  "bound_us": bound * 1e3,
                                  "max_abs_err": err}), flush=True)
        del x, g, cot, wants
    print(card)


if __name__ == "__main__":
    main()

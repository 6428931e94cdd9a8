#!/usr/bin/env python3
"""What a failed step-graph capture does to PyTorch's caching allocator,
with and without the port's clean-up, on one card.

    python3 tools/torch_graph_faults.py

In a child process each, with the clean-up (``cuda_graph._abandon_pool``)
and with it planted out (a no-op), for a private pool (``TrainStep``'s)
and for a shared ``GraphPool`` (an engine's) that already holds a live
graph: a step graph whose step syncs with the host is called three times
(the warm-up, then two captures, which must fail), a good graph is
captured on the same pool afterwards, and a probe runs: a 256 MiB block
used on a second stream is freed and the cache emptied. Prints what each
call raised, the bytes the probe leaves reserved (0 when the allocator is
sound) and whether the graphs made before and after the failures replay
right. Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import gc
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _release():
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _probe():
    """Bytes that a freed block used on two streams leaves reserved."""
    _release()
    before = torch.cuda.memory_reserved()
    t = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    t.record_stream(torch.cuda.Stream())
    del t
    _release()
    return torch.cuda.memory_reserved() - before


def _child(mode):
    sys.path.insert(0, str(ROOT))
    from mxnet_tpu_torch.ops import cuda_graph as cg

    if mode == "unrepaired":
        cg._abandon_pool = lambda device, pool: None

    class Owner:
        pass

    owner, dev = Owner(), torch.device("cuda", 0)
    stream = cg.capture_stream(owner, dev)
    x = torch.randn(2048, 2048, device=dev)

    def good():
        return ((x @ x).sum(),)

    def syncing():
        z = (x @ x).sum()
        float(z)  # a host sync: the capture fails
        return (z,)

    want = float(good()[0])
    print(f"[{mode}] probe before any capture leaves {_probe()} bytes",
          flush=True)
    for kind in ("private", "shared"):
        pool = cg.GraphPool() if kind == "shared" else None
        ok = True
        graphs = []
        for sig, fn in (("before", good), ("syncing", syncing),
                        ("after", good)):
            g = cg.StepGraph(fn, (sig,), dev, stream=stream, pool=pool)
            for call in range(3):
                try:
                    out = float(g()[0])
                    ok &= sig == "syncing" and call == 0 or out == want
                except Exception as e:  # reported
                    ok &= sig == "syncing" and call > 0 and \
                        type(e).__name__ == "MXNetError"
                    print(f"[{mode}] {kind} pool, graph {sig!r}, call "
                          f"{call}: {type(e).__name__}: "
                          f"{' '.join(str(e).split())[:90]}", flush=True)
            graphs.append(g)
        replays = [float(g()[0]) == want for g in graphs
                   if g.graph is not None]
        print(f"[{mode}] {kind} pool: calls as expected {bool(ok)}, "
              f"{len(replays)} captured graphs replay right "
              f"{all(replays)}; probe leaves {_probe()} bytes", flush=True)
        del graphs, g


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
        return
    if not torch.cuda.is_available():
        sys.exit("torch_graph_faults: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    for mode in ("repaired", "unrepaired"):
        subprocess.run([sys.executable, __file__, "--child", mode],
                       timeout=300, check=False)


if __name__ == "__main__":
    main()

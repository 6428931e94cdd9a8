#!/usr/bin/env python3
"""Where the time of one PyTorch/CUDA training or decode step goes, on one
card.

    python3 tools/torch_train_profile.py [--layers 24] [--steps 3] [--amp bfloat16]
    python3 tools/torch_train_profile.py --decode [--steps 20]
    python3 tools/torch_train_profile.py ... --engine-type naive graph graph naive

Trains gpt2_345m (``mxnet_tpu_torch``, B=4, T=1024, seeded random weights
and batch, as ``chip_smoke.py``) for two warm-up steps: in f32 with
``lm_loss`` and Adam 1e-4 (the ``train`` phase), or with ``--amp bfloat16``
through ``TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(lr_scheduler=...),
amp="bfloat16")`` on chip_smoke.py's warm-up schedule (the ``train_amp``
phase). With ``--decode`` it instead fills chip_smoke.py's serving engine
(gpt2_345m f32, batch 8, page size 16) with 8 prompts of 500 tokens and
takes decode steps (``GenerationEngine.decode_step``, B=8, 500-560 cached
keys a row). It then times ``--steps`` steps untraced and ``--steps`` more
traced by ``torch.profiler``, and prints the card's name and power limit,
the wall time per step of each, the device time per step summed over
kernels (one stream, so kernels do not overlap), the idle share (1 -
device time / wall time) against each wall time (the profiler adds host
time to every op) and the device time per kernel group and per kernel.
``--engine-type`` runs the steps as the port's captured step graphs
("graph", the default) or eagerly ("naive"); given several values, it
profiles each in turn in the same process, on the same net (a new engine
or TrainStep for each), so that the two can be compared on one card.

    python3 tools/torch_train_profile.py --memory [--amp bfloat16] ...

With ``--memory`` it profiles nothing: after each of the first ``--steps``
calls it prints the bytes allocated and reserved, their peaks in that call,
and the reserved bytes by memory pool (the ordinary pool, or a graph's
private pool) and stream, from ``torch.cuda.memory_snapshot()``. Under
"graph" it records the allocator's history through the first two calls
(the warm-up and the capture) and prints what it did: new segments, the
frees whose memory came back late, and the blocks still allocated on a
side stream, with where they were allocated.
Needs CUDA; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("flash forward", ("flash_fwd_",)),  # the f32 and the bf16 kernel
    ("paged attention", ("paged_attention_kernel", "paged_prefill_tc_kernel")),
    ("flash dK/dV", ("flash_bwd_dkv_",)),  # the f32 and the bf16 kernel
    ("flash dQ", ("flash_bwd_dq_",)),
    ("adam", ("adam_kernel",)),
    ("softmax xent forward", ("xent_fwd_kernel",)),
    ("softmax xent backward", ("xent_bwd_kernel",)),
    ("layernorm forward", ("layernorm_fwd_",)),  # warp and block routes
    # the backward kernels (row kernel, merge of the column sums); the
    # plain backward's chain falls in the groups below
    ("layernorm backward", ("layernorm_bwd_",)),
    ("matmul", ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "splitK",
                "nvjet")),
    ("softmax / log-softmax", ("softmax", "Softmax")),
    ("reduction", ("reduce", "Reduce")),
    ("copy / cast / fill", ("copy", "Copy", "fill", "Fill", "Memcpy",
                            "Memset")),
)


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--amp", choices=("bfloat16",), default=None)
    ap.add_argument("--decode", action="store_true",
                    help="profile serving decode steps instead of training")
    ap.add_argument("--memory", action="store_true",
                    help="report memory per call instead of profiling")
    ap.add_argument("--engine-type", nargs="+", default=["graph"],
                    choices=("naive", "graph"),
                    help="step graphs or eager steps; several: in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: CUDA is not available")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from mxnet_tpu_torch.models import get_gpt2

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0,
                   num_layers=args.layers)
    for engine_type in args.engine_type:
        (_memory if args.memory else _profile)(args, net, engine_type, card)
        torch.cuda.empty_cache()


def _profile(args, net, engine_type, card):
    step, what = _step(args, net, engine_type)
    # under "graph" the first call warms up and the second captures
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    # the same steps untraced: the profiler adds host time to every op, so
    # the idle share is read against this wall time too
    t = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / args.steps
    _report(card, what, args.steps, prof, wall, plain_wall)


GIB = float(2 ** 30)


def _memory(args, net, engine_type, card):
    step, what = _step(args, net, engine_type)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(card)
    print(f"[memory] {what}: before the first call allocated "
          f"{torch.cuda.memory_allocated() / GIB:.4f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / GIB:.4f}")
    for i in range(args.steps):
        torch.cuda.reset_peak_memory_stats()
        history = engine_type == "graph" and i == 1
        if engine_type == "graph" and i == 0:  # through the capture
            torch.cuda.memory._record_memory_history(
                max_entries=1_000_000, context="alloc", stacks="python")
        step()
        torch.cuda.synchronize()
        if history:
            snap = torch.cuda.memory._snapshot()
            _live_side_blocks(snap)
            torch.cuda.memory._record_memory_history(enabled=None)
        print(f"[memory] call {i}: allocated "
              f"{torch.cuda.memory_allocated() / GIB:.4f} GiB (peak "
              f"{torch.cuda.max_memory_allocated() / GIB:.4f}), reserved "
              f"{torch.cuda.memory_reserved() / GIB:.4f} (peak "
              f"{torch.cuda.max_memory_reserved() / GIB:.4f})")
        _pools()
        if history:
            _history(snap)


def _pools():
    """Reserved and allocated bytes by (memory pool, stream)."""
    pools = collections.defaultdict(lambda: [0, 0, 0])
    for seg in torch.cuda.memory_snapshot():
        key = (tuple(seg.get("segment_pool_id", (0, 0))), seg["stream"])
        pools[key][0] += seg["total_size"]
        pools[key][1] += seg["allocated_size"]
        pools[key][2] += 1
    for (pool, stream), (total, used, n) in sorted(pools.items()):
        kind = "ordinary" if pool == (0, 0) else f"graph {pool}"
        print(f"    pool {kind}, stream {stream:#x}: reserved "
              f"{total / GIB:.4f} GiB in {n} segments, allocated "
              f"{used / GIB:.4f}")


def _live_side_blocks(snap):
    """The blocks still allocated in the ordinary pool on a side stream,
    with where they were allocated."""
    for seg in snap["segments"]:
        if seg["stream"] == 0 or tuple(seg.get("segment_pool_id",
                                                 (0, 0))) != (0, 0):
            continue
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            where = " < ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                               f"{f['name']}"
                               for f in (blk.get("frames") or [])[:5])
            print(f"      live {blk['size'] / 2**20:.2f} MiB in a "
                  f"{seg['total_size'] / 2**20:.1f} MiB segment, stream "
                  f"{seg['stream']:#x}: {where or '(no frames)'}")


def _history(snap):
    """What the allocator did since the history began (the warm-up and the
    capture): new and released segments
    by pool, and frees whose memory came back only later (a block used on
    a second stream: freed for reuse only once no capture runs)."""
    segs = collections.Counter()
    pending, late, frames = {}, [], {}
    for trace in snap["device_traces"]:
        for k, ev in enumerate(trace):
            act, addr = ev["action"], ev.get("addr")
            if act in ("segment_alloc", "segment_free", "segment_map",
                       "segment_unmap"):
                segs[act] += ev["size"]
            elif act == "alloc":
                frames[addr] = ev.get("frames") or []
            elif act == "free_requested":
                pending[addr] = (k, ev["size"], ev["stream"])
            elif act == "free_completed" and addr in pending:
                k0, size, stream = pending.pop(addr)
                if k > k0 + 1:
                    late.append((size, stream, frames.get(addr, [])))
    print(f"    history of the warm-up and the capture: "
          f"{ {a: round(b / GIB, 4) for a, b in segs.items()} } GiB; "
          f"{len(late)} frees completed late, "
          f"{sum(x[0] for x in late) / GIB:.4f} GiB; "
          f"{len(pending)} never completed, "
          f"{sum(x[1] for x in pending.values()) / GIB:.4f} GiB")
    for size, stream, fr in sorted(late, key=lambda x: -x[0])[:8]:
        where = " < ".join(f"{f['filename'].split('/')[-1]}:{f['line']} "
                           f"{f['name']}" for f in fr[:4])
        print(f"      {size / 2**20:.1f} MiB, stream {stream:#x}: {where}")


def _step(args, net, engine_type):
    """The step to run, as a closure, and its description."""
    rs = np.random.RandomState(0)
    if args.decode:
        from mxnet_tpu_torch.inference import GenerationEngine

        eng = GenerationEngine(net, batch_size=8, max_length=1024, paged=True,
                               page_size=16, eos_id=None, device="cuda",
                               engine_type=engine_type)
        for slot in range(8):
            eng.prefill(rs.randint(0, 50257, 500), slot)
        step = eng.decode_step
        what = (f"gpt2_345m layers={args.layers} f32 decode B=8, paged "
                f"(ps 16), 500 prompt tokens a row, engine_type "
                f"{engine_type}")
    else:
        step = _train_step(args, net, rs, engine_type)
        what = (f"gpt2_345m layers={args.layers} B=4 T=1024 "
                f"{args.amp or 'f32'}, engine_type {engine_type}")
    return step, what


def _train_step(args, net, rs, engine_type):
    """One TrainStep call on chip_smoke.py's fixed batch, as a closure."""
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    from mxnet_tpu_torch.models import lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    if args.amp is None:
        ts = TrainStep(net, lm_loss, Adam(learning_rate=1e-4), amp=None,
                       engine_type=engine_type)
    else:  # chip_smoke.py's amp_schedule()
        ts = TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(
            learning_rate=1e-4, lr_scheduler=CosineScheduler(
                max_update=1000, base_lr=1e-4, warmup_steps=4,
                warmup_begin_lr=1e-5)),
            amp=args.amp, engine_type=engine_type)
    ids_np = rs.randint(0, 50257, (4, 1024))
    ids = torch.from_numpy(ids_np.astype(np.int32)).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, 1).astype(np.int32)).cuda()
    return lambda: ts(ids, labels)


def _report(card, what, steps, prof, wall, plain_wall):
    kernels = collections.Counter()
    calls = collections.Counter()
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += us / steps
            calls[evt.key] += evt.count / steps
    busy = sum(kernels.values()) / 1e3
    print(card)
    print(f"{what}, {steps} traced steps under the profiler")
    print(f"wall {wall * 1e3:.2f} ms/step traced, {plain_wall * 1e3:.2f} "
          f"untraced; device {busy:.2f} ms/step; idle share "
          f"{1 - busy / (wall * 1e3):.3f} traced, "
          f"{1 - busy / (plain_wall * 1e3):.3f} untraced")
    if not kernels:
        print("the profiler recorded no device time: not measured")
        return
    groups = collections.Counter()
    for name, us in kernels.items():
        group = next((g for g, keys in GROUPS
                      if any(k in name for k in keys)), "other elementwise")
        groups[group] += us
    print("device ms per step by group:")
    for g, us in groups.most_common():
        print(f"  {us / 1e3:9.3f}  {100 * us / 1e3 / busy:5.1f}%  {g}")
    print("top kernels (device ms per step, launches per step):")
    for name, us in kernels.most_common(25):
        print(f"  {us / 1e3:9.3f}  {calls[name]:7.1f}  {name[:110]}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of one PyTorch/CUDA training step goes, on one card.

    python3 tools/torch_train_profile.py [--layers 24] [--steps 3] [--amp bfloat16]

Trains gpt2_345m (``mxnet_tpu_torch``, B=4, T=1024, seeded random weights
and batch, as ``chip_smoke.py``) for two warm-up steps: in f32 with
``lm_loss`` and Adam 1e-4 (the ``train`` phase), or with ``--amp bfloat16``
through ``TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(lr_scheduler=...),
amp="bfloat16")`` on chip_smoke.py's warm-up schedule (the ``train_amp``
phase). It then times ``--steps`` steps untraced and ``--steps`` more
traced by ``torch.profiler``, and prints the card's name and power limit,
the wall time per step of each, the device time per step summed over
kernels (one stream, so kernels do not overlap), the idle share (1 -
device time / wall time) against each wall time (the profiler adds host
time to every op) and the device time per kernel group and per kernel.
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
    ("flash forward", ("flash_fwd_kernel",)),
    ("flash dK/dV", ("flash_bwd_dkv_",)),  # the f32 and the bf16 kernel
    ("flash dQ", ("flash_bwd_dq_",)),
    ("adam", ("adam_kernel",)),
    ("softmax xent forward", ("xent_fwd_kernel",)),
    ("softmax xent backward", ("xent_bwd_kernel",)),
    ("layernorm forward", ("layernorm_kernel",)),
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_train_profile: CUDA is not available")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from mxnet_tpu_torch import TrainStep
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    from mxnet_tpu_torch.models import get_gpt2, lm_loss
    from mxnet_tpu_torch.optimizer import Adam

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    net = get_gpt2("gpt2_345m", dropout=0.0, device="cuda", seed=0,
                   num_layers=args.layers)
    if args.amp is None:
        ts = TrainStep(net, lm_loss, Adam(learning_rate=1e-4), amp=None)
    else:  # chip_smoke.py's amp_schedule()
        ts = TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(
            learning_rate=1e-4, lr_scheduler=CosineScheduler(
                max_update=1000, base_lr=1e-4, warmup_steps=4,
                warmup_begin_lr=1e-5)),
            amp=args.amp)
    rs = np.random.RandomState(0)
    ids_np = rs.randint(0, 50257, (4, 1024))
    ids = torch.from_numpy(ids_np.astype(np.int32)).cuda()
    labels = torch.from_numpy(np.roll(ids_np, -1, 1).astype(np.int32)).cuda()
    for _ in range(2):
        ts(ids, labels)
    torch.cuda.synchronize()
    # the same steps untraced: the profiler adds host time to every op, so
    # the idle share is read against this wall time too
    t = time.perf_counter()
    for _ in range(args.steps):
        ts(ids, labels)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t) / args.steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            ts(ids, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / args.steps
    kernels = collections.Counter()
    calls = collections.Counter()
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] += us / args.steps
            calls[evt.key] += evt.count / args.steps
    busy = sum(kernels.values()) / 1e3
    print(card)
    print(f"gpt2_345m layers={args.layers} B=4 T=1024 {args.amp or 'f32'}, "
          f"{args.steps} traced steps under the profiler")
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

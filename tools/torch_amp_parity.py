#!/usr/bin/env python3
"""Spread of chip_smoke.py's bf16 training-parity check over seeds, on one
card.

    python3 tools/torch_amp_parity.py [--seeds 1 2 3 4 5 6]

For each seed s (the weights' seed; the batch's is s - 1, so that seed 1 is
chip_smoke.py's own run), runs chip_smoke.py's
``phase_train_parity(amp="bfloat16")`` without its limits: 3 steps of a
2-layer GPT-2 at gpt2_345m width (B=4, T=1024) through
``TrainStep(net, SoftmaxCrossEntropyLoss(), Adam(lr_scheduler=...),
amp="bfloat16")`` on the kernels and then on their plain versions. Prints
the card's name and power limit, per seed the relative loss gap of each
step and of the loss's fall over the steps, the largest weight difference
against Adam's sign-flip bound and the share of weights beyond 1e-2 * lr,
then the maxima over the seeds, from which chip_smoke.py's AMP_LOSS_RTOL,
AMP_DROP_RTOL and AMP_FAR_SHARE are set. Needs CUDA; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_amp_parity: CUDA is not available")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build()
    runs = []
    for seed in args.seeds:
        runs.append(cs.phase_train_parity(amp="bfloat16", seed=seed,
                                          batch_seed=seed - 1, check=False))
        torch.cuda.empty_cache()
    summary = {
        "seeds": args.seeds,
        "max_loss_rel_gap": max(max(r["loss_rel_gaps"]) for r in runs),
        "max_loss_drop_rel_gap": max(r["loss_drop_rel_gap"] for r in runs),
        "max_weight_diff": max(r["max_weight_diff"] for r in runs),
        "min_weight_bound": min(r["weight_bound"] for r in runs),
        "max_share_beyond_1e-2_lr": max(r["share_beyond_1e-2_lr"]
                                        for r in runs),
        "runs": runs}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

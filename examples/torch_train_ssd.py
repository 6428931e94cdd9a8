#!/usr/bin/env python
"""SSD detection training through the PyTorch/CUDA port, ``mxnet_tpu_torch``:
the counterpart of ``examples/train_ssd.py`` (reference shape:
``example/ssd/train.py``), with the same flags. It runs on the card.

Trains the small SSD in ``mxnet_tpu_torch/models/ssd.py`` on a synthetic
shapes dataset (bright rectangles, class = aspect bucket; no files) by one
``autograd.record()`` / ``backward()`` / ``trainer.step`` a batch (Adam),
with the targets from ``MultiBoxTarget`` inside the recorded step, then
counts the detections whose best box overlaps the ground truth
(IoU > 0.4) on a fresh batch:

    python examples/torch_train_ssd.py
    python examples/torch_train_ssd.py --batch-size 32 --steps 400

``train(args, ctx=, net=, on_step=)`` is the same run for a caller that
names the device, brings its own initialized net or watches each step.
"""
import argparse
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.models.ssd import get_ssd, ssd_loss, ssd_train_targets


def synthetic_batch(rs, n, size, ctx=None):
    """One bright rectangle per image; class 0 = wide, 1 = tall."""
    imgs = np.zeros((n, 3, size, size), np.float32)
    labels = np.full((n, 1, 5), -1.0, np.float32)
    for i in range(n):
        if rs.rand() < 0.5:
            w, h = rs.randint(12, 20), rs.randint(6, 10)
            cls = 0.0
        else:
            w, h = rs.randint(6, 10), rs.randint(12, 20)
            cls = 1.0
        y = rs.randint(0, size - h)
        x = rs.randint(0, size - w)
        imgs[i, :, y:y + h, x:x + w] = rs.uniform(0.6, 1.0)
        labels[i, 0] = [cls, x / size, y / size, (x + w) / size, (y + h) / size]
    return nd.array(imgs, ctx=ctx), nd.array(labels, ctx=ctx)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--log-interval", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def detection_hits(out, labels):
    """Images whose best-scoring kept detection overlaps the ground truth
    with IoU > 0.4 (``out``: (N, A, 6) host rows, ``labels``: (N, 1, 5))."""
    hits = 0
    for i in range(out.shape[0]):
        rows = out[i][out[i][:, 0] >= 0]
        if not len(rows):
            continue
        best = rows[np.argmax(rows[:, 1])]
        gt = labels[i, 0, 1:]
        tl = np.maximum(best[2:4], gt[:2])
        br = np.minimum(best[4:6], gt[2:])
        wh = np.clip(br - tl, 0, None)
        inter = wh[0] * wh[1]

        def area(r):
            return max((r[2] - r[0]) * (r[3] - r[1]), 1e-9)

        if inter / (area(best[2:]) + area(gt) - inter) > 0.4:
            hits += 1
    return hits


def train(args, ctx=None, net=None, on_step=None):
    """Train ``args.steps`` steps on ``ctx`` (default: the card), then
    detect on a fresh batch. ``net`` replaces the seeded model (initialized,
    on ``ctx``); ``on_step(step, loss)`` is called after each
    ``trainer.step`` with the step's loss as a float (without it only the
    logged steps read their loss). Returns ``{"losses", "hits",
    "detections"}``: (step, loss) of each step read, the hit count, and
    the detections as host rows."""
    if args.size < 24:
        raise ValueError("--size must be >= 24 (rectangles are up to 19px "
                         "+ margin)")
    ctx = ctx or mx.gpu()
    mx.random.seed(args.seed)
    rs = np.random.RandomState(args.seed)
    with ctx:
        if net is None:
            net = get_ssd(num_classes=2)
            net.initialize(ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": args.lr})
        losses = []
        t0 = time.time()
        for step in range(1, args.steps + 1):
            imgs, labels = synthetic_batch(rs, args.batch_size, args.size, ctx)
            with autograd.record():
                anchors, cls_preds, box_preds = net(imgs)
                loc_t, loc_m, cls_t = ssd_train_targets(anchors, labels,
                                                        cls_preds)
                loss = ssd_loss(cls_preds, box_preds, cls_t, loc_t, loc_m)
            loss.backward()
            trainer.step(args.batch_size)
            logged = step % args.log_interval == 0
            if on_step is None and not logged:
                continue  # the loss stays on the device
            value = float(loss.asnumpy())
            losses.append((step, value))
            if on_step is not None:
                on_step(step, value)
            if logged:
                ips = step * args.batch_size / (time.time() - t0)
                print(f"step {step} loss {value:.4f} img/s {ips:.1f}",
                      flush=True)
        # eval: detection IoU against ground truth on a fresh batch
        imgs, labels = synthetic_batch(rs, args.batch_size, args.size, ctx)
        out = net.detect(imgs, threshold=0.3).asnumpy()
    hits = detection_hits(out, labels.asnumpy())
    print(f"detection hits {hits}/{args.batch_size} (IoU>0.4)")
    return {"losses": losses, "hits": hits, "detections": out}


if __name__ == "__main__":
    train(build_parser().parse_args())

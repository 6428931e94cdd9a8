#!/usr/bin/env python
"""ResNet training on ImageNet-shaped data through the PyTorch/CUDA port,
``mxnet_tpu_torch``: the counterpart of ``examples/train_imagenet_resnet.py``
(the reference's ``example/image-classification/train_imagenet.py``), with
its flags plus ``--device`` (``gpu``, the default, or ``cpu``).

``get_resnet(1, --layers)`` with MSRAPrelu weights, trained through
``TrainStep`` (one CUDA graph a step on the card) with
``SoftmaxCrossEntropyLoss`` and ``SGD(0.1, momentum 0.9, wd 1e-4)``, on
synthetic batches or, with ``--rec``, an im2rec ``.rec`` pack decoded by
``io.ImageRecordIter`` (random crop and mirror, ImageNet mean and std).
The port runs on one device: ``--dp 0`` means every visible card, and a
degree above 1 (data parallelism, ROADMAP item 4) raises before any work.

    python examples/torch_train_imagenet_resnet.py --device cpu \\
        --layers 18 --image-size 32 --batch-size 4 --steps 3
"""
import argparse
import time

import numpy as np
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd, optimizer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
from mxnet_tpu_torch.parallel import TrainStep


def synthetic_batches(batch, steps, shape=(3, 224, 224), classes=1000,
                      ctx=None):
    rs = np.random.RandomState(0)
    for _ in range(steps):
        yield (nd.array(rs.rand(batch, *shape).astype(np.float32), ctx=ctx),
               nd.array(rs.randint(0, classes, batch), ctx=ctx))


def record_batches(rec_path, batch, steps, size, threads, ctx=None,
                   stats=None):
    """Real data: the threaded JPEG-decode pipeline (``ImageRecordIter``
    over an im2rec .rec pack), ImageNet mean/std, random crop and mirror;
    prints the decode throughput (and stores it in ``stats``)."""
    from mxnet_tpu_torch.io import ImageRecordIter

    it = ImageRecordIter(
        path_imgrec=rec_path, data_shape=(3, size, size), batch_size=batch,
        shuffle=True, rand_crop=True, rand_mirror=True, resize=size * 256 // 224,
        mean_r=123.68, mean_g=116.78, mean_b=103.94,
        std_r=58.393, std_g=57.12, std_b=57.375,
        preprocess_threads=threads)
    done = 0
    t0 = time.time()
    while done < steps:
        for b in it:
            yield (nd.array(b.data[0], ctx=ctx),
                   nd.array(b.label[0].astype("int32"), ctx=ctx))
            done += 1
            if done >= steps:
                break
        it.reset()
    dt = time.time() - t0
    rate = done * batch / dt
    if stats is not None:
        stats["decode_img_per_s"] = rate
    print(f"input pipeline: {rate:.1f} img/s decoded+augmented "
          f"({threads} threads)")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--layers", type=int, default=50)
    ap.add_argument("--dp", type=int, default=0, help="data-parallel degree "
                    "(0 = all devices)")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--rec", default=None,
                    help="path to an im2rec .rec pack; omitted = synthetic data")
    ap.add_argument("--data-threads", type=int, default=4)
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return ap


def train(args, net=None):
    """Train; print and return img/s and the last loss (with every loss).
    ``net`` replaces the ResNet the flags describe (initialized, on the
    device)."""
    cpu = args.device == "cpu"
    n = args.dp or (1 if cpu else torch.cuda.device_count())
    if n > 1:
        raise MXNetError(f"--dp {n}: data parallelism across cards is not "
                         f"ported yet (ROADMAP item 4, multi-GPU); the port "
                         f"trains on one device (--dp 1)")
    ctx = mx.cpu() if cpu else mx.gpu()
    shape = (3, args.image_size, args.image_size)
    with ctx:
        if net is None:
            net = get_resnet(1, args.layers, classes=1000)
            net.initialize(mx.init.MSRAPrelu(), ctx=ctx)
            x0, _ = next(synthetic_batches(args.batch_size, 1, shape,
                                           ctx=ctx))
            _ = net(x0)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        step = TrainStep(net, lambda out, y: loss_fn(out, y),
                         optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                       wd=1e-4))
        stats = {}
        batches = (record_batches(args.rec, args.batch_size, args.steps,
                                  args.image_size, args.data_threads, ctx,
                                  stats)
                   if args.rec else
                   synthetic_batches(args.batch_size, args.steps, shape,
                                     ctx=ctx))
        # the rate skips the first step (eager) and the second, which
        # captures the step's CUDA graph, as the JAX example skips its
        # compile
        warm = 2 if args.steps > 2 else 1
        t0, seen, losses = time.time(), 0, []
        for i, (x, y) in enumerate(batches):
            losses.append(step(x, y))
            seen += args.batch_size
            if i + 1 == warm:
                if not cpu:
                    torch.cuda.synchronize()
                t0, seen = time.time(), 0
        losses = [float(v) for v in losses]
        dt = time.time() - t0
    rate = seen / dt if seen else float("nan")
    print(f"resnet{args.layers} dp={n}: {rate:.1f} img/s "
          f"(loss={losses[-1]:.3f})")
    return dict(img_per_s=rate, loss=losses[-1], losses=losses, **stats)


if __name__ == "__main__":
    train(build_parser().parse_args())

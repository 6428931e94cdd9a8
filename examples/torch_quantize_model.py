#!/usr/bin/env python
"""Post-training INT8 quantization through the PyTorch/CUDA port,
``mxnet_tpu_torch``: the counterpart of ``examples/quantize_model.py`` (the
reference's ``example/quantization/imagenet_gen_qsym.py`` flow), with its
flags plus ``--device`` (``gpu``, the default, or ``cpu``).

Trains a zoo model briefly in f32, calibrates activation scales on a few
batches (minmax or KL-divergence entropy), converts Dense AND Conv2D
blocks to s8 x s8 -> s32 execution (on the card the port's int8 kernels:
an im2col launch a convolution and one tensor-core product a layer), and
reports the accuracy delta against the f32 net on a held-out set.
Synthetic data, so the script needs no files.

    python examples/torch_quantize_model.py --device cpu --epochs 1
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.contrib import quantization


def make_data(n, classes, size=32, chans=3, seed=0):
    """Strongly-separable synthetic images: each class brightens a vertical
    band at a class-specific position (works at any channel count)."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, chans, size, size).astype(np.float32)
    y = rs.randint(0, classes, (n,))
    band = max(size // classes, 1)
    for i in range(n):
        c0 = (y[i] * band) % size
        x[i, y[i] % chans, :, c0:c0 + band] += 1.5
    return x, y


def accuracy(net, x, y, batch=32, ctx=None):
    correct = 0
    for i in range(0, len(x), batch):
        out = net(nd.array(x[i:i + batch], ctx=ctx)).asnumpy()
        correct += int((out.argmax(1) == y[i:i + batch]).sum())
    return correct / len(x)


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lenet")
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--calib-mode", choices=("minmax", "entropy"),
                    default="minmax")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return ap


def main(argv=None):
    """Train, convert, print; return ``(fp32_acc, int8_acc)``."""
    args = build_parser().parse_args(argv)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()

    chans = 1 if args.model == "lenet" else 3
    size = 28 if args.model == "lenet" else 32
    x, y = make_data(512, args.classes, size, chans=chans)
    x_train, y_train = x[:384], y[:384]
    x_test, y_test = x[384:], y[384:]

    with ctx:
        # quick fp32 training so quantization has real weights to work with
        mx.random.seed(0)
        net = gluon.model_zoo.get_model(args.model, classes=args.classes)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 2e-3})
        lf = gluon.loss.SoftmaxCrossEntropyLoss()

        for _ in range(args.epochs):
            for i in range(0, len(x_train), 32):
                xb = nd.array(x_train[i:i + 32], ctx=ctx)
                yb = nd.array(y_train[i:i + 32], dtype="int32", ctx=ctx)
                with autograd.record():
                    loss = lf(net(xb), yb)
                loss.backward()
                tr.step(32)

        fp32_acc = accuracy(net, x_test, y_test, ctx=ctx)

        calib = [nd.array(x_train[i * 32:(i + 1) * 32], ctx=ctx)
                 for i in range(args.calib_batches)]
        qnet, scales = quantization.convert_to_int8(net, calib_data=calib,
                                                    calib_mode=args.calib_mode)
        int8_acc = accuracy(qnet, x_test, y_test, ctx=ctx)

    print(f"fp32 accuracy:  {fp32_acc:.4f}")
    print(f"int8 accuracy:  {int8_acc:.4f}  (delta {int8_acc - fp32_acc:+.4f})")
    print(f"quantized layers: {sorted(scales)}")
    return fp32_acc, int8_acc


if __name__ == "__main__":
    main()

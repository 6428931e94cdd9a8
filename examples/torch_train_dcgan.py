#!/usr/bin/env python
"""DCGAN through the PyTorch/CUDA port, ``mxnet_tpu_torch``: the
counterpart of ``examples/train_dcgan.py`` (the reference's
``example/gluon/dcgan.py``), with its flags plus ``--device`` (``gpu``,
the default, or ``cpu``).

Generator: latent z -> Conv2DTranspose stack -> tanh image.
Discriminator: Conv2D stack -> one logit. Non-saturating GAN losses by
``SigmoidBinaryCrossEntropyLoss``, alternating D and G steps, each one
``autograd.record()`` / ``backward()`` / ``Trainer("adam", beta1=0.5)``
step (on the card the Adam update is the port's fused kernel). With no
real dataset it trains on synthetic Gaussian blobs, so it runs with no
files; ``--dataset mnist`` reads ``gluon.data.vision.MNIST``.

    python examples/torch_train_dcgan.py --device cpu --epochs 1 \\
        --n-samples 64
"""
import argparse

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.gluon import nn


def build_generator(ngf=32, nc=1):
    net = nn.HybridSequential(prefix="gen_")
    with net.name_scope():
        # z (N, nz, 1, 1) -> 4x4
        net.add(nn.Conv2DTranspose(ngf * 4, 4, 1, 0, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        # 4x4 -> 8x8
        net.add(nn.Conv2DTranspose(ngf * 2, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        # 8x8 -> 16x16
        net.add(nn.Conv2DTranspose(ngf, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.Activation("relu"))
        # 16x16 -> 32x32
        net.add(nn.Conv2DTranspose(nc, 4, 2, 1, use_bias=False))
        net.add(nn.Activation("tanh"))
    return net


def build_discriminator(ndf=32):
    net = nn.HybridSequential(prefix="disc_")
    with net.name_scope():
        net.add(nn.Conv2D(ndf, 4, 2, 1, use_bias=False))
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(ndf * 2, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(ndf * 4, 4, 2, 1, use_bias=False))
        net.add(nn.BatchNorm())
        net.add(nn.LeakyReLU(0.2))
        net.add(nn.Conv2D(1, 4, 1, 0, use_bias=False))  # 4x4 -> 1x1 logit
    return net


def synthetic_blobs(n, size=32, seed=0):
    """Gaussian blobs at random positions: enough structure for the GAN
    losses to move in a short run."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    imgs = np.empty((n, 1, size, size), np.float32)
    for i in range(n):
        cx, cy = rs.uniform(8, size - 8, 2)
        s = rs.uniform(2, 5)
        imgs[i, 0] = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return imgs * 2.0 - 1.0  # tanh range


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--n-samples", type=int, default=256)
    ap.add_argument("--dataset", choices=("synthetic", "mnist"),
                    default="synthetic")
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    return ap


def load_data(dataset, n_samples):
    if dataset == "mnist":
        from mxnet_tpu_torch.gluon.data.vision import MNIST

        ds = MNIST(train=True)
        raw = np.stack([np.asarray(ds[i][0]) for i in range(n_samples)])
        return (np.pad(raw.reshape(-1, 1, 28, 28).astype(np.float32) / 255.0,
                       ((0, 0), (0, 0), (2, 2), (2, 2))) * 2 - 1)
    return synthetic_blobs(n_samples)


def train(args, gen=None, disc=None, log=print, on_step=None):
    """Train; return ``(d_losses, g_losses, gen, disc)``. ``gen`` and
    ``disc`` replace the nets the example builds (initialized, on the
    device), and ``on_step(i)`` is called after each D/G iteration."""
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()
    data = load_data(args.dataset, args.n_samples)
    batch_size, nz = args.batch_size, args.nz
    with ctx:
        if gen is None:
            mx.random.seed(0)
            gen = build_generator()
            disc = build_discriminator()
            gen.initialize(mx.init.Normal(0.02), ctx=ctx)
            disc.initialize(mx.init.Normal(0.02), ctx=ctx)
        g_tr = gluon.Trainer(gen.collect_params(), "adam",
                             {"learning_rate": args.lr, "beta1": 0.5})
        d_tr = gluon.Trainer(disc.collect_params(), "adam",
                             {"learning_rate": args.lr, "beta1": 0.5})
        loss_fn = gluon.loss.SigmoidBinaryCrossEntropyLoss()

        rs = np.random.RandomState(1)
        d_losses, g_losses = [], []
        for epoch in range(args.epochs):
            for i in range(0, len(data) - batch_size + 1, batch_size):
                real = nd.array(data[i:i + batch_size], ctx=ctx)
                z = nd.array(rs.randn(batch_size, nz, 1, 1)
                             .astype(np.float32), ctx=ctx)
                ones = nd.ones((batch_size,), ctx=ctx)
                zeros = nd.zeros((batch_size,), ctx=ctx)
                # -- D step: real -> 1, fake -> 0
                fake = gen(z)
                with autograd.record():
                    out_real = disc(real).reshape(-1)
                    out_fake = disc(fake.detach()).reshape(-1)
                    d_loss = loss_fn(out_real, ones) + loss_fn(out_fake, zeros)
                d_loss.backward()
                d_tr.step(batch_size)
                # -- G step: fool D (non-saturating)
                z = nd.array(rs.randn(batch_size, nz, 1, 1)
                             .astype(np.float32), ctx=ctx)
                with autograd.record():
                    out = disc(gen(z)).reshape(-1)
                    g_loss = loss_fn(out, ones)
                g_loss.backward()
                g_tr.step(batch_size)
                d_losses.append(float(d_loss.mean().asnumpy()))
                g_losses.append(float(g_loss.mean().asnumpy()))
                if on_step is not None:
                    on_step(len(d_losses))
            log(f"epoch {epoch}: D {np.mean(d_losses[-8:]):.4f} "
                f"G {np.mean(g_losses[-8:]):.4f}")
    return d_losses, g_losses, gen, disc


if __name__ == "__main__":
    train(build_parser().parse_args())

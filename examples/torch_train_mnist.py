#!/usr/bin/env python
"""LeNet on MNIST through the PyTorch/CUDA port, ``mxnet_tpu_torch``: the
counterpart of ``examples/train_mnist.py`` (the reference's
``example/gluon/mnist.py``), with ``--device`` (``gpu``, the default, or
``cpu``).

``gluon.data.vision.MNIST`` (the seeded synthetic set when the IDX files
are absent) -> ``DataLoader`` -> the zoo's LeNet -> ``Trainer("adam")``
-> ``metric.Accuracy``, one ``autograd.record()`` / ``backward()`` /
``trainer.step`` a batch.

    python examples/torch_train_mnist.py --device cpu --epochs 1
"""
import argparse
import time

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.gluon.data.vision import MNIST


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--export", default="",
                    help="export the trained net to <export>-symbol.json "
                         "and <export>-0000.params")
    return ap


def _scaled(d):
    return d.astype("float32") / 255.0


def data_loaders(batch_size, shuffle=True):
    """(train, validation) DataLoaders of [0, 1]-scaled MNIST."""
    train_data = gluon.data.DataLoader(
        MNIST(train=True).transform_first(_scaled),
        batch_size=batch_size, shuffle=shuffle)
    val_data = gluon.data.DataLoader(
        MNIST(train=False).transform_first(_scaled), batch_size=batch_size)
    return train_data, val_data


def step(net, trainer, loss_fn, data, label, metric=None):
    """One NHWC batch: record, backward, ``trainer.step``; the loss."""
    x = data.transpose((0, 3, 1, 2))
    with autograd.record():
        out = net(x)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(x.shape[0])
    if metric is not None:
        metric.update(label, out)
    return loss


def train(args, on_step=None):
    """Train; return one dict an epoch (train and validation accuracy,
    the last loss, the steps, and the seconds spent waiting on the
    DataLoader and in the steps). ``on_step(step, loss)`` is called after
    each ``trainer.step`` with the loss NDArray (not synced)."""
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu()
    mx.random.seed(args.seed)
    train_data, val_data = data_loaders(args.batch_size)
    with ctx:
        net = gluon.model_zoo.get_model("lenet", ctx=ctx)
        net.initialize(mx.init.Xavier(), ctx=ctx)
        if not args.no_hybridize:
            net.hybridize()
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": args.lr})
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        history = []
        n = 0
        for epoch in range(args.epochs):
            metric = mx.metric.Accuracy()
            wait = busy = 0.0
            batches = iter(train_data)
            while True:
                t0 = time.perf_counter()
                try:
                    data, label = next(batches)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                loss = step(net, trainer, loss_fn, data, label, metric)
                n += 1
                if on_step is not None:
                    on_step(n, loss)
                wait += t1 - t0
                busy += time.perf_counter() - t1
            name, acc = metric.get()
            val = mx.metric.Accuracy()
            for data, label in val_data:
                val.update(label, net(data.transpose((0, 3, 1, 2))))
            last = float(loss.mean().asnumpy())
            history.append(dict(train_acc=acc, val_acc=val.get()[1],
                                loss=last, steps=n, wait_s=wait,
                                step_s=busy))
            print(f"epoch {epoch}: train {name}={acc:.4f} "
                  f"val={val.get()[1]:.4f} loss={last:.4f}", flush=True)
    if args.export:
        net.export(args.export)
    return history


if __name__ == "__main__":
    train(build_parser().parse_args())

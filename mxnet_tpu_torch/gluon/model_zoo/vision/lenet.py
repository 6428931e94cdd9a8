"""LeNet-5: the port of ``mxnet_tpu/gluon/model_zoo/vision/lenet.py``
(BASELINE.md config #1: a Gluon ``HybridSequential`` on MNIST's shapes)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Conv2D, Dense, Flatten, HybridSequential, MaxPool2D

__all__ = ["LeNet", "lenet"]


class LeNet(HybridBlock):
    def __init__(self, classes=10, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(channels=6, kernel_size=5, padding=2, activation="tanh"))
            self.features.add(MaxPool2D(pool_size=2, strides=2))
            self.features.add(Conv2D(channels=16, kernel_size=5, activation="tanh"))
            self.features.add(MaxPool2D(pool_size=2, strides=2))
            self.features.add(Flatten())
            self.features.add(Dense(120, activation="tanh"))
            self.features.add(Dense(84, activation="tanh"))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def lenet(**kwargs):
    return LeNet(**kwargs)

"""AlexNet: the port of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``,
the same blocks and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ._common import _no_pretrained, _on
from ...nn import Conv2D, Dense, Dropout, Flatten, HybridSequential, MaxPool2D

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(64, 11, 4, 2, activation="relu"))
            self.features.add(MaxPool2D(3, 2))
            self.features.add(Conv2D(192, 5, padding=2, activation="relu"))
            self.features.add(MaxPool2D(3, 2))
            self.features.add(Conv2D(384, 3, padding=1, activation="relu"))
            self.features.add(Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(Conv2D(256, 3, padding=1, activation="relu"))
            self.features.add(MaxPool2D(3, 2))
            self.features.add(Flatten())
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, **kwargs):
    _no_pretrained(pretrained)
    with _on(ctx):
        return AlexNet(**kwargs)

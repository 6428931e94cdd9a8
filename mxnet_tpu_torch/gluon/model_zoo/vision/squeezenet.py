"""SqueezeNet 1.0/1.1: the port of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``,
the same blocks and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Activation, AvgPool2D, Conv2D, Dropout, Flatten, \
    GlobalAvgPool2D, HybridSequential, MaxPool2D

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze, expand1x1, expand3x3, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.squeeze = Conv2D(squeeze, 1, activation="relu")
            self.expand1 = Conv2D(expand1x1, 1, activation="relu")
            self.expand3 = Conv2D(expand3x3, 3, padding=1, activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.expand1(x), self.expand3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if version == "1.0":
                self.features.add(Conv2D(96, 7, 2, activation="relu"))
                self.features.add(MaxPool2D(3, 2))
                for s, e in [(16, 64), (16, 64), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(MaxPool2D(3, 2))
                for s, e in [(32, 128), (48, 192), (48, 192), (64, 256)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(MaxPool2D(3, 2))
                self.features.add(_Fire(64, 256, 256))
            else:
                self.features.add(Conv2D(64, 3, 2, activation="relu"))
                self.features.add(MaxPool2D(3, 2))
                for s, e in [(16, 64), (16, 64)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(MaxPool2D(3, 2))
                for s, e in [(32, 128), (32, 128)]:
                    self.features.add(_Fire(s, e, e))
                self.features.add(MaxPool2D(3, 2))
                for s, e in [(48, 192), (48, 192), (64, 256), (64, 256)]:
                    self.features.add(_Fire(s, e, e))
            self.features.add(Dropout(0.5))
            self.output = HybridSequential(prefix="")
            self.output.add(Conv2D(classes, 1, activation="relu"))
            self.output.add(GlobalAvgPool2D())
            self.output.add(Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw): return SqueezeNet("1.0", **kw)
def squeezenet1_1(**kw): return SqueezeNet("1.1", **kw)

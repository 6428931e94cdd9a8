"""DenseNet 121/161/169/201: the port of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``,
the same blocks and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Flatten, \
    GlobalAvgPool2D, HybridSequential, MaxPool2D

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169", "densenet201"]

densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = HybridSequential(prefix="")
            self.body.add(BatchNorm())
            self.body.add(Activation("relu"))
            self.body.add(Conv2D(bn_size * growth_rate, 1, use_bias=False))
            self.body.add(BatchNorm())
            self.body.add(Activation("relu"))
            self.body.add(Conv2D(growth_rate, 3, padding=1, use_bias=False))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _transition(channels):
    out = HybridSequential(prefix="")
    out.add(BatchNorm())
    out.add(Activation("relu"))
    out.add(Conv2D(channels, 1, use_bias=False))
    out.add(AvgPool2D(2, 2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(num_init_features, 7, 2, 3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
            channels = num_init_features
            for i, num_layers in enumerate(block_config):
                for _ in range(num_layers):
                    self.features.add(_DenseLayer(growth_rate, 4))
                channels += num_layers * growth_rate
                if i != len(block_config) - 1:
                    channels //= 2
                    self.features.add(_transition(channels))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def densenet121(**kw): return DenseNet(*densenet_spec[121], **kw)
def densenet161(**kw): return DenseNet(*densenet_spec[161], **kw)
def densenet169(**kw): return DenseNet(*densenet_spec[169], **kw)
def densenet201(**kw): return DenseNet(*densenet_spec[201], **kw)

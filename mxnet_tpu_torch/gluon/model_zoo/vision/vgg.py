"""VGG 11/13/16/19 (+BN): the port of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``,
the same blocks and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Activation, BatchNorm, Conv2D, Dense, Dropout, Flatten, \
    HybridSequential, MaxPool2D

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            for i, num in enumerate(layers):
                for _ in range(num):
                    self.features.add(Conv2D(filters[i], 3, padding=1))
                    if batch_norm:
                        self.features.add(BatchNorm())
                    self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(2, 2))
            self.features.add(Flatten())
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.features.add(Dense(4096, activation="relu"))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, batch_norm=False, **kwargs):
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, batch_norm=batch_norm, **kwargs)


def vgg11(**kw): return get_vgg(11, **kw)
def vgg13(**kw): return get_vgg(13, **kw)
def vgg16(**kw): return get_vgg(16, **kw)
def vgg19(**kw): return get_vgg(19, **kw)
def vgg11_bn(**kw): return get_vgg(11, batch_norm=True, **kw)
def vgg13_bn(**kw): return get_vgg(13, batch_norm=True, **kw)
def vgg16_bn(**kw): return get_vgg(16, batch_norm=True, **kw)
def vgg19_bn(**kw): return get_vgg(19, batch_norm=True, **kw)

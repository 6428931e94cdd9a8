"""ResNeXt and SE-ResNeXt (reference: GluonCV model_zoo resnext.py —
Aggregated Residual Transformations, Xie et al.; SE from Hu et al.).

The port of ``mxnet_tpu/gluon/model_zoo/vision/resnext.py``: the grouped
3x3 is one ``Conv2D(groups=cardinality)``.
"""
from __future__ import annotations

import math

from ...block import HybridBlock
from ...nn import (Activation, BatchNorm, Conv2D, Dense, GlobalAvgPool2D,
                   HybridSequential, MaxPool2D)

__all__ = ["ResNext", "Block", "get_resnext", "resnext50_32x4d",
           "resnext101_32x4d", "se_resnext50_32x4d", "se_resnext101_32x4d"]


class Block(HybridBlock):
    r"""ResNeXt bottleneck: 1x1 reduce -> grouped 3x3 -> 1x1 expand, with an
    optional squeeze-excitation gate on the residual branch."""

    def __init__(self, channels, cardinality, bottleneck_width, stride,
                 downsample=False, use_se=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        D = int(math.floor(channels * (bottleneck_width / 64)))
        group_width = cardinality * D

        self.body = HybridSequential(prefix="")
        self.body.add(Conv2D(group_width, kernel_size=1, use_bias=False))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(group_width, kernel_size=3, strides=stride,
                             padding=1, groups=cardinality, use_bias=False))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels * 4, kernel_size=1, use_bias=False))
        self.body.add(BatchNorm())

        if use_se:
            # biased layers to match the GluonCV SE block's 1x1 convs
            # (bias=True there), keeping param structure/count aligned with
            # reference checkpoints
            self.se = HybridSequential(prefix="")
            self.se.add(Dense(channels // 4, use_bias=True))
            self.se.add(Activation("relu"))
            self.se.add(Dense(channels * 4, use_bias=True))
            self.se.add(Activation("sigmoid"))
        else:
            self.se = None

        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels * 4, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels))
            self.downsample.add(BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.se is not None:
            w = F.Pooling(x, global_pool=True, pool_type="avg")
            # shape-free reshape codes (0 = copy dim) keep the SE branch
            # exportable: Symbols have no .shape to read
            w = self.se(F.reshape(w, shape=(0, -1)))
            x = F.broadcast_mul(x, F.reshape(w, shape=(0, -1, 1, 1)))
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


resnext_spec = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3]}


class ResNext(HybridBlock):
    def __init__(self, layers, cardinality, bottleneck_width, classes=1000,
                 use_se=False, **kwargs):
        super().__init__(**kwargs)
        self._cardinality = cardinality
        self._bottleneck_width = bottleneck_width
        self._use_se = use_se
        channels = 64
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(Conv2D(channels, 7, 2, 3, use_bias=False))
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(channels, num_layer,
                                                   stride, i + 1))
                channels *= 2
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes)

    def _make_layer(self, channels, num_layers, stride, stage_index):
        layer = HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(Block(channels, self._cardinality,
                            self._bottleneck_width, stride, True,
                            use_se=self._use_se, prefix=""))
            for _ in range(num_layers - 1):
                layer.add(Block(channels, self._cardinality,
                                self._bottleneck_width, 1, False,
                                use_se=self._use_se, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def get_resnext(num_layers, cardinality=32, bottleneck_width=4,
                use_se=False, **kwargs):
    if num_layers not in resnext_spec:
        raise ValueError(f"invalid resnext depth {num_layers}; "
                         f"options: {sorted(resnext_spec)}")
    return ResNext(resnext_spec[num_layers], cardinality, bottleneck_width,
                   use_se=use_se, **kwargs)


def resnext50_32x4d(**kw): return get_resnext(50, 32, 4, use_se=False, **kw)
def resnext101_32x4d(**kw): return get_resnext(101, 32, 4, use_se=False, **kw)
def se_resnext50_32x4d(**kw): return get_resnext(50, 32, 4, use_se=True, **kw)
def se_resnext101_32x4d(**kw): return get_resnext(101, 32, 4, use_se=True, **kw)

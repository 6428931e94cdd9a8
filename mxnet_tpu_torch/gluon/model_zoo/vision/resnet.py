"""ResNet v1/v2, every depth: the port of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (BASELINE.md config #2),
NCHW, with the JAX package's parameter names (``resnetv10_conv2d0_weight``,
``resnetv10_stage1_batchnorm0_running_mean``, ...), so ``.params`` files
move between the packages.
"""
from __future__ import annotations

from ...block import HybridBlock
from ._common import _no_pretrained, _on
from ...nn import (Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Flatten,
                   GlobalAvgPool2D, HybridSequential, MaxPool2D)

__all__ = ["ResNetV1", "ResNetV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2"]


def _conv3x3(channels, stride, in_channels):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(BatchNorm())
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1, strides=stride,
                                       use_bias=False, in_channels=in_channels))
            self.downsample.add(BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(residual + x, act_type="relu")


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self.body = HybridSequential(prefix="")
        self.body.add(Conv2D(channels // 4, kernel_size=1, strides=stride))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(BatchNorm())
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1))
        self.body.add(BatchNorm())
        if downsample:
            self.downsample = HybridSequential(prefix="")
            self.downsample.add(Conv2D(channels, kernel_size=1, strides=stride,
                                       use_bias=False, in_channels=in_channels))
            self.downsample.add(BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = self.body(x)
        if self.downsample:
            residual = self.downsample(residual)
        return F.Activation(x + residual, act_type="relu")


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.ds = (Conv2D(channels, 1, stride, use_bias=False, in_channels=in_channels)
                   if downsample else None)

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.ds:
            residual = self.ds(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self.bn1 = BatchNorm()
        self.conv1 = Conv2D(channels // 4, 1, 1, use_bias=False)
        self.bn2 = BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = BatchNorm()
        self.conv3 = Conv2D(channels, 1, 1, use_bias=False)
        self.ds = (Conv2D(channels, 1, stride, use_bias=False, in_channels=in_channels)
                   if downsample else None)

    def hybrid_forward(self, F, x):
        residual = x
        x = F.Activation(self.bn1(x), act_type="relu")
        if self.ds:
            residual = self.ds(x)
        x = self.conv1(x)
        x = F.Activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.Activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False))
                self.features.add(BatchNorm())
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(block, num_layer, channels[i + 1],
                                                   stride, i + 1, channels[i]))
            self.features.add(GlobalAvgPool2D())
            self.output = Dense(classes, in_units=channels[-1])

    def _make_layer(self, block, layers, channels, stride, stage_index, in_channels=0):
        layer = HybridSequential(prefix=f"stage{stage_index}_")
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels, prefix=""))
        return layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(BatchNorm(scale=False, center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0))
            else:
                self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False))
                self.features.add(BatchNorm())
                self.features.add(Activation("relu"))
                self.features.add(MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(block, num_layer, channels[i + 1],
                                                   stride, i + 1, in_channels))
                in_channels = channels[i + 1]
            self.features.add(BatchNorm())
            self.features.add(Activation("relu"))
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes, in_units=in_channels)

    _make_layer = ResNetV1._make_layer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


_blocks_v1 = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}
_blocks_v2 = {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """ResNet ``version`` (1 or 2) of ``num_layers``, its parameters on
    ``ctx`` (default: the current context)."""
    _no_pretrained(pretrained)
    block_type, layers, channels = resnet_spec[num_layers]
    with _on(ctx):
        if version == 1:
            return ResNetV1(_blocks_v1[block_type], layers, channels,
                            **kwargs)
        return ResNetV2(_blocks_v2[block_type], layers, channels, **kwargs)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)

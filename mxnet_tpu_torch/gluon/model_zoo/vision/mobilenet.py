"""MobileNet v1/v2: the port of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``,
the same blocks and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Activation, BatchNorm, Conv2D, Dense, Flatten, \
    GlobalAvgPool2D, HybridSequential

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_5",
           "mobilenet0_25", "mobilenet_v2_1_0", "mobilenet_v2_0_5"]


def _conv_block(out, channels, kernel=1, stride=1, pad=0, groups=1, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=groups, use_bias=False))
    out.add(BatchNorm())
    out.add(Activation("relu"))


def _dw_block(out, dw_channels, channels, stride):
    _conv_block(out, dw_channels, 3, stride, 1, groups=dw_channels)
    _conv_block(out, channels)


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _conv_block(self.features, int(32 * multiplier), 3, 2, 1)
            dw_channels = [int(x * multiplier) for x in
                           [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
            channels = [int(x * multiplier) for x in
                        [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
            strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
            for dwc, c, s in zip(dw_channels, channels, strides):
                _dw_block(self.features, dwc, c, s)
            self.features.add(GlobalAvgPool2D())
            self.features.add(Flatten())
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class _LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = HybridSequential()
            _conv_block(self.out, in_channels * t, relu6=True)
            _conv_block(self.out, in_channels * t, 3, stride, 1,
                        groups=in_channels * t, relu6=True)
            self.out.add(Conv2D(channels, 1, use_bias=False))
            self.out.add(BatchNorm())

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        m = multiplier
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            _conv_block(self.features, int(32 * m), 3, 2, 1, relu6=True)
            in_c = [int(x * m) for x in [32, 16, 24, 24, 32, 32, 32, 64, 64, 64,
                                         64, 96, 96, 96, 160, 160, 160]]
            ch = [int(x * m) for x in [16, 24, 24, 32, 32, 32, 64, 64, 64, 64,
                                       96, 96, 96, 160, 160, 160, 320]]
            ts = [1] + [6] * 16
            strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
            for ic, c, t, s in zip(in_c, ch, ts, strides):
                self.features.add(_LinearBottleneck(ic, c, t, s))
            last = int(1280 * m) if m > 1.0 else 1280
            _conv_block(self.features, last, relu6=True)
            self.features.add(GlobalAvgPool2D())
            self.out = Conv2D(classes, 1, use_bias=False, prefix="pred_")
            self.flat = Flatten()

    def hybrid_forward(self, F, x):
        return self.flat(self.out(self.features(x)))


def mobilenet1_0(**kw): return MobileNet(1.0, **kw)
def mobilenet0_5(**kw): return MobileNet(0.5, **kw)
def mobilenet0_25(**kw): return MobileNet(0.25, **kw)
def mobilenet_v2_1_0(**kw): return MobileNetV2(1.0, **kw)
def mobilenet_v2_0_5(**kw): return MobileNetV2(0.5, **kw)

"""Inception V3: the port of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``
(A/B/C/D/E mixed blocks of conv + BatchNorm + relu triples, 299x299 input),
the same blocks and parameter names.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Activation, AvgPool2D, BatchNorm, Conv2D, Dense, Dropout, \
    HybridSequential, MaxPool2D

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel, stride=1, padding=0):
    out = HybridSequential(prefix="")
    out.add(Conv2D(channels, kernel, stride, padding, use_bias=False))
    out.add(BatchNorm(epsilon=0.001))
    out.add(Activation("relu"))
    return out


def _branch(*layers):
    out = HybridSequential(prefix="")
    for l in layers:
        out.add(l)
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channels (gluon.contrib.Concurrent)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._branches = []

    def add(self, block):
        self._branches.append(block)
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._branches], dim=1)


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_conv(64, 1))
    out.add(_branch(_conv(48, 1), _conv(64, 5, padding=2)))
    out.add(_branch(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, padding=1)))
    out.add(_branch(AvgPool2D(3, 1, 1), _conv(pool_features, 1)))
    return out


def _make_B():
    out = _Concurrent()
    out.add(_conv(384, 3, 2))
    out.add(_branch(_conv(64, 1), _conv(96, 3, padding=1), _conv(96, 3, 2)))
    out.add(_branch(MaxPool2D(3, 2)))
    return out


def _make_C(channels_7x7):
    out = _Concurrent()
    out.add(_conv(192, 1))
    out.add(_branch(_conv(channels_7x7, 1),
                    _conv(channels_7x7, (1, 7), padding=(0, 3)),
                    _conv(192, (7, 1), padding=(3, 0))))
    out.add(_branch(_conv(channels_7x7, 1),
                    _conv(channels_7x7, (7, 1), padding=(3, 0)),
                    _conv(channels_7x7, (1, 7), padding=(0, 3)),
                    _conv(channels_7x7, (7, 1), padding=(3, 0)),
                    _conv(192, (1, 7), padding=(0, 3))))
    out.add(_branch(AvgPool2D(3, 1, 1), _conv(192, 1)))
    return out


def _make_D():
    out = _Concurrent()
    out.add(_branch(_conv(192, 1), _conv(320, 3, 2)))
    out.add(_branch(_conv(192, 1),
                    _conv(192, (1, 7), padding=(0, 3)),
                    _conv(192, (7, 1), padding=(3, 0)),
                    _conv(192, 3, 2)))
    out.add(_branch(MaxPool2D(3, 2)))
    return out


class _SplitConcat(HybridBlock):
    """stem -> two parallel convs -> concat (the 3x3 split inside E blocks)."""

    def __init__(self, stem, left, right, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stem, self.left, self.right = stem, left, right
            for b in (stem, left, right):
                self.register_child(b)

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        return F.concat(self.left(x), self.right(x), dim=1)


def _make_E():
    out = _Concurrent()
    out.add(_conv(320, 1))
    out.add(_SplitConcat(_conv(384, 1),
                         _conv(384, (1, 3), padding=(0, 1)),
                         _conv(384, (3, 1), padding=(1, 0))))
    out.add(_SplitConcat(_branch(_conv(448, 1), _conv(384, 3, padding=1)),
                         _conv(384, (1, 3), padding=(0, 1)),
                         _conv(384, (3, 1), padding=(1, 0))))
    out.add(_branch(AvgPool2D(3, 1, 1), _conv(192, 1)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = HybridSequential(prefix="")
            self.features.add(_conv(32, 3, 2))
            self.features.add(_conv(32, 3))
            self.features.add(_conv(64, 3, padding=1))
            self.features.add(MaxPool2D(3, 2))
            self.features.add(_conv(80, 1))
            self.features.add(_conv(192, 3))
            self.features.add(MaxPool2D(3, 2))
            self.features.add(_make_A(32))
            self.features.add(_make_A(64))
            self.features.add(_make_A(64))
            self.features.add(_make_B())
            self.features.add(_make_C(128))
            self.features.add(_make_C(160))
            self.features.add(_make_C(160))
            self.features.add(_make_C(192))
            self.features.add(_make_D())
            self.features.add(_make_E())
            self.features.add(_make_E())
            self.features.add(AvgPool2D(8))
            self.features.add(Dropout(0.5))
            self.output = Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = F.flatten(x)
        return self.output(x)


def inception_v3(classes=1000, **kwargs):
    return Inception3(classes=classes, **kwargs)

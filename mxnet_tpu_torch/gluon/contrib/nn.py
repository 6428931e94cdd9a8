"""``gluon.contrib.nn``: Concurrent / HybridConcurrent, Identity,
SyncBatchNorm, SparseEmbedding, PixelShuffle2D.

Counterpart of ``mxnet_tpu/gluon/contrib/nn.py``. ``SyncBatchNorm`` is
``BatchNorm`` on the one device the port trains on; ``SparseEmbedding``
is a dense ``Embedding`` under its own prefix (the port has no row-sparse
gradients), as the JAX alias is in effect.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..nn import BatchNorm, Embedding, HybridSequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]


class HybridConcurrent(HybridSequential):
    """Feed the input to every child and concatenate the outputs on
    ``axis``."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x, *args):
        from ... import ndarray as nd

        return nd.concat(*[block(x) for block in self._modules.values()],
                         dim=self.axis)


class Concurrent(HybridConcurrent):
    """The imperative name of :class:`HybridConcurrent`."""


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(HybridBlock):
    """An ``Embedding`` child; its gradient is dense here."""

    def __init__(self, input_dim, output_dim, dtype="float32", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.embedding = Embedding(input_dim, output_dim, dtype=dtype)

    def hybrid_forward(self, F, x):
        return self.embedding(x)


class SyncBatchNorm(BatchNorm):
    """BatchNorm whose statistics would be synchronized across devices; on
    one device it is BatchNorm. ``num_devices`` is taken and unused."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)


class PixelShuffle2D(HybridBlock):
    """(N, C·f1·f2, H, W) -> (N, C, H·f1, W·f2) sub-pixel upsampling."""

    def __init__(self, factor, **kwargs):
        super().__init__(**kwargs)
        self._factors = ((int(factor),) * 2
                         if not isinstance(factor, (list, tuple))
                         else tuple(int(f) for f in factor))

    def hybrid_forward(self, F, x):
        f1, f2 = self._factors
        n, c_in, h, w = x.shape
        c = c_in // (f1 * f2)
        x = x.reshape(n, c, f1, f2, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c, h * f1, w * f2)

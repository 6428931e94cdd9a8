"""Vision transforms: counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``
(``python/mxnet/gluon/data/vision/transforms.py``).

Each transform is a Gluon block over HWC (or NHWC) images: called on an
NDArray it gives an NDArray, on a tensor a tensor. A float result cast
back to an integer dtype saturates, as JAX's ``astype`` does. ``Resize``
is ``jax.image.resize(..., "linear")``, which antialiases when it
shrinks: ``F.interpolate(mode="bilinear", align_corners=False,
antialias=True)``. The random transforms draw from ``rng`` (a
``numpy.random.RandomState``); the default is numpy's global state, which
the JAX package's transforms draw from.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ....base import dtype_torch
from ....image import PCA_EIGVAL, PCA_EIGVEC, _cast, _gray, \
    hue_rotation_matrix
from ...block import Block, HybridBlock
from ...nn.basic_layers import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "Resize", "CenterCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


class Compose(HybridSequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return _cast(x, dtype_torch(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""

    def hybrid_forward(self, F, x):
        x = _cast(x, torch.float32) / 255.0
        if x.dim() == 3:
            return x.permute(2, 0, 1)
        return x.permute(0, 3, 1, 2)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean, self._std = mean, std

    def hybrid_forward(self, F, x):
        mean = torch.as_tensor(self._mean, dtype=torch.float32,
                               device=x.device).reshape(-1, 1, 1)
        std = torch.as_tensor(self._std, dtype=torch.float32,
                              device=x.device).reshape(-1, 1, 1)
        return (x - mean) / std


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        h, w = self._size
        batch = x if x.dim() == 4 else x[None]
        y = F.interpolate(batch.float().permute(0, 3, 1, 2), size=(h, w),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        y = y if x.dim() == 4 else y[0]
        return _cast(y.contiguous(), x.dtype)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        ch, cw = self._size
        h, w = x.shape[-3], x.shape[-2]
        y0, x0 = (h - ch) // 2, (w - cw) // 2
        return x[..., y0:y0 + ch, x0:x0 + cw, :]


class _Random(Block):
    def __init__(self, rng=None, **kwargs):
        super().__init__(**kwargs)
        self._rng = np.random if rng is None else rng


class RandomResizedCrop(_Random):
    """A crop of U(h/2, h) x U(w/2, w) at a uniform offset, resized to
    ``size`` (the JAX transform's rule; ``scale`` and ``ratio`` are taken
    and not used, as there)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1, rng=None):
        super().__init__(rng=rng)
        self._resize = Resize(size)

    def forward(self, x):
        h, w = x.shape[-3], x.shape[-2]
        rng = self._rng
        ch = rng.randint(h // 2, h + 1)
        cw = rng.randint(w // 2, w + 1)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        return self._resize(x[..., y0:y0 + ch, x0:x0 + cw, :])


class RandomFlipLeftRight(_Random):
    def forward(self, x):
        if self._rng.rand() < 0.5:
            return torch.flip(x, dims=(x.dim() - 2,))
        return x


class RandomFlipTopBottom(_Random):
    def forward(self, x):
        if self._rng.rand() < 0.5:
            return torch.flip(x, dims=(x.dim() - 3,))
        return x


def _blend(a, b, alpha):
    return a * alpha + b * (1.0 - alpha)


class RandomBrightness(_Random):
    """Scale pixel values by U(1-b, 1+b)."""

    def __init__(self, brightness, rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        self._b = float(brightness)

    def forward(self, x):
        alpha = 1.0 + self._rng.uniform(-self._b, self._b)
        return x * alpha


class RandomContrast(_Random):
    def __init__(self, contrast, rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        self._c = float(contrast)

    def forward(self, x):
        alpha = 1.0 + self._rng.uniform(-self._c, self._c)
        d = x.float()
        return _cast(_blend(d, _gray(d, True).mean(), alpha), x.dtype)


class RandomSaturation(_Random):
    def __init__(self, saturation, rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        self._s = float(saturation)

    def forward(self, x):
        alpha = 1.0 + self._rng.uniform(-self._s, self._s)
        d = x.float()
        return _cast(_blend(d, _gray(d, True), alpha), x.dtype)


class RandomHue(_Random):
    """Rotate hue by U(-h, h) via the YIQ approximation of the reference's
    image_aug."""

    def __init__(self, hue, rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        self._h = float(hue)

    def forward(self, x):
        alpha = self._rng.uniform(-self._h, self._h)
        m = torch.from_numpy(np.asarray(hue_rotation_matrix(alpha),
                                        np.float32)).to(x.device)
        return _cast(x.float() @ m.T, x.dtype)


class RandomColorJitter(_Random):
    """Brightness, contrast, saturation and hue jitter in one transform,
    applied in a random order each call."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        ts = []
        if brightness:
            ts.append(RandomBrightness(brightness, rng=rng))
        if contrast:
            ts.append(RandomContrast(contrast, rng=rng))
        if saturation:
            ts.append(RandomSaturation(saturation, rng=rng))
        if hue:
            ts.append(RandomHue(hue, rng=rng))
        self._ts = ts

    def forward(self, x):
        for i in self._rng.permutation(len(self._ts)):
            x = self._ts[i](x)
        return x


class RandomLighting(_Random):
    """AlexNet-style PCA lighting noise."""

    def __init__(self, alpha, rng=None, **kwargs):
        super().__init__(rng=rng, **kwargs)
        self._a = float(alpha)

    def forward(self, x):
        a = self._rng.normal(0, self._a, size=(3,)).astype(np.float32)
        rgb = (np.asarray(PCA_EIGVEC, np.float32) * a
               * np.asarray(PCA_EIGVAL, np.float32)).sum(axis=1)
        # the offsets take x's dtype by numpy's cast (the JAX transform's
        # jnp.asarray of a host array)
        np_dtype = np.float32 if x.dtype == torch.bfloat16 else \
            torch.empty(0, dtype=x.dtype).numpy().dtype
        return x + torch.from_numpy(rgb.astype(np_dtype)).to(
            device=x.device, dtype=x.dtype)

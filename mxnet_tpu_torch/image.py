"""Image decoding and the augmenter pipeline.

Counterpart of ``mxnet_tpu/image.py`` (``python/mxnet/image/image.py``).
Decoded images are HWC uint8 NDArrays on the host, as MXNet's
``mx.image.imdecode`` gives them; a pipeline moves its batches to the card
once they are stacked. JPEG decodes through the shared C++ decoder
(``native/src/jpeg.cc``, loaded by :mod:`mxnet_tpu_torch.native`), so the
pixels equal the JAX package's; npy payloads load directly, and other
formats through PIL.

``imresize`` takes the native uint8 kernel for a host uint8 numpy image
and ``F.interpolate(mode="bilinear", align_corners=False,
antialias=False)`` for anything else, ``jax.image.resize(..., "linear",
antialias=False)``'s coordinates. A float result cast back to an integer
dtype saturates, as JAX's ``astype`` does.

The random augmenters draw from ``rng`` (a ``numpy.random.RandomState``, or
anything with its ``rand``/``randint``/``uniform``/``normal``/
``permutation``); the default is numpy's global state, which the JAX
package's augmenters draw from, so the same seed gives the same draws.
"""
from __future__ import annotations

import io as _io

import numpy as np
import torch
import torch.nn.functional as F

from .base import dtype_torch
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["imdecode", "imresize", "resize_short", "center_crop",
           "random_crop", "color_normalize", "batchify_images",
           "Augmenter", "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "RandomCropAug", "CenterCropAug", "ResizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug",
           "CreateAugmenter"]

# shared color-jitter constants (BT.601 luma, YIQ transform, AlexNet PCA),
# read by the augmenters here and the gluon vision transforms
GRAY_COEF = np.array([0.299, 0.587, 0.114], np.float32)
TYIQ = np.array([[0.299, 0.587, 0.114],
                 [0.596, -0.274, -0.321],
                 [0.211, -0.523, 0.311]], np.float32)
PCA_EIGVAL = [55.46, 4.794, 1.148]
PCA_EIGVEC = [[-0.5675, 0.7192, 0.4009],
              [-0.5808, -0.0045, -0.8140],
              [-0.5836, -0.6948, 0.4203]]


def _host(a):
    return array(a, ctx=cpu())


def imdecode(buf, to_rgb=1, flag=1):
    """Compressed image bytes -> HWC uint8 NDArray on the host. ``to_rgb=0``
    gives BGR (the reference's cv2 order); ``flag=0`` gives one channel of
    BT.601 luma."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    buf = bytes(buf)
    if buf[:2] == b"\xff\xd8":
        from .native import jpeg_decode

        img = jpeg_decode(buf)
    elif buf[:6] == b"\x93NUMPY":
        img = np.load(_io.BytesIO(buf))
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
    else:
        import PIL.Image

        img = np.asarray(PIL.Image.open(_io.BytesIO(buf)).convert("RGB"))
    if not to_rgb:
        img = img[:, :, ::-1]
    if flag == 0 and img.ndim == 3 and img.shape[-1] == 3:
        img = (img.astype(np.float32) @ GRAY_COEF)[..., None].astype(
            img.dtype)
    return _host(np.ascontiguousarray(img))


def _raw(x):
    """A tensor of ``x`` (NDArray, tensor or host array)."""
    if isinstance(x, NDArray):
        return x._data
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(np.asarray(x))


def _cast(t, dtype):
    """``t.astype(dtype)`` as JAX casts: a float cast to an integer dtype
    saturates to the dtype's range, then truncates toward zero."""
    if t.dtype == dtype:
        return t
    if t.is_floating_point() and not dtype.is_floating_point \
            and dtype != torch.bool:
        info = torch.iinfo(dtype)
        t = t.clamp(info.min, info.max)
    return t.to(dtype)


def imresize(src, w, h, interp=1):
    """Resize a HWC image to (h, w), bilinear."""
    from . import native as _native

    if isinstance(src, np.ndarray) and src.dtype == np.uint8 \
            and src.ndim == 3:
        return _host(_native.image_resize(src, h, w))
    x = _raw(src)
    y = F.interpolate(x.float().permute(2, 0, 1)[None], size=(int(h), int(w)),
                      mode="bilinear", align_corners=False, antialias=False)
    return NDArray(_cast(y[0].permute(1, 2, 0).contiguous(), x.dtype))


def resize_short(src, size, interp=1):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(src, new_w, new_h, interp)


def center_crop(src, size, interp=1):
    h, w = src.shape[:2]
    cw, ch = size
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return src[y0:y0 + ch, x0:x0 + cw], (x0, y0, cw, ch)


def random_crop(src, size, interp=1, rng=None):
    rng = np.random if rng is None else rng
    h, w = src.shape[:2]
    cw, ch = size
    x0 = rng.randint(0, w - cw + 1)
    y0 = rng.randint(0, h - ch + 1)
    return src[y0:y0 + ch, x0:x0 + cw], (x0, y0, cw, ch)


def batchify_images(batch, mean=None, std=None, nthreads=4):
    """Host batch staging: (N, H, W, C) uint8 -> (N, C, H, W) float32 with
    per-channel ``(x - mean) / std``, through the threaded C++ kernel; the
    NDArray is on the host."""
    from . import native as _native

    arr = np.asarray(batch)
    if arr.dtype == np.uint8 and arr.ndim == 4:
        return _host(_native.batch_to_chw_float(arr, mean=mean, std=std,
                                                nthreads=nthreads))
    out = arr.astype(np.float32)
    if mean is not None:
        out = out - np.asarray(mean, np.float32)
    if std is not None:
        out = out / np.asarray(std, np.float32)
    return _host(np.ascontiguousarray(out.transpose(0, 3, 1, 2)))


def color_normalize(src, mean, std=None):
    x = _raw(src)
    out = x.float() - _raw(mean).to(x.device)
    if std is not None:
        out = out / _raw(std).to(x.device)
    return NDArray(out)


def hue_rotation_matrix(alpha):
    """RGB-space hue rotation by ``alpha`` (a fraction of pi) via YIQ."""
    u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
    rot = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], np.float32)
    return np.linalg.inv(TYIQ) @ rot @ TYIQ


def _gray(d, keepdims):
    return (d * torch.from_numpy(GRAY_COEF).to(d.device)).sum(
        dim=-1, keepdim=keepdims)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs
        self.rng = kwargs.pop("rng", None) or np.random

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1, rng=None):
        super().__init__(size=size, rng=rng)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size, rng=self.rng)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5, rng=None):
        super().__init__(p=p, rng=rng)
        self.p = p

    def __call__(self, src):
        if self.rng.rand() < self.p:
            return NDArray(torch.flip(_raw(src), dims=(1,)))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return NDArray(_cast(_raw(src), dtype_torch(self.typ)))


class BrightnessJitterAug(Augmenter):
    """Scale values by U(1-b, 1+b)."""

    def __init__(self, brightness, rng=None):
        super().__init__(brightness=brightness, rng=rng)
        self.brightness = float(brightness)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.brightness, self.brightness)
        return NDArray(_raw(src) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast, rng=None):
        super().__init__(contrast=contrast, rng=rng)
        self.contrast = float(contrast)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.contrast, self.contrast)
        d = _raw(src).float()
        return NDArray(d * alpha + _gray(d, False).mean() * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation, rng=None):
        super().__init__(saturation=saturation, rng=rng)
        self.saturation = float(saturation)

    def __call__(self, src):
        alpha = 1.0 + self.rng.uniform(-self.saturation, self.saturation)
        d = _raw(src).float()
        return NDArray(d * alpha + _gray(d, True) * (1.0 - alpha))


class HueJitterAug(Augmenter):
    def __init__(self, hue, rng=None):
        super().__init__(hue=hue, rng=rng)
        self.hue = float(hue)

    def __call__(self, src):
        alpha = self.rng.uniform(-self.hue, self.hue)
        d = _raw(src).float()
        m = torch.from_numpy(
            np.asarray(hue_rotation_matrix(alpha), np.float32)).to(d.device)
        return NDArray(d @ m.T)


class ColorJitterAug(Augmenter):
    """Brightness, contrast and saturation jitter, in a random order each
    call (the reference's RandomOrderAug)."""

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0,
                 rng=None):
        super().__init__(rng=rng)
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness, rng=rng))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast, rng=rng))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation, rng=rng))

    def __call__(self, src):
        for i in self.rng.permutation(len(self.augs)):
            src = self.augs[i](src)
        return src


class LightingAug(Augmenter):
    """PCA-based lighting noise."""

    def __init__(self, alphastd, eigval, eigvec, rng=None):
        super().__init__(rng=rng)
        self.alphastd = float(alphastd)
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = self.rng.normal(0, self.alphastd, size=(3,)).astype(
            np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        x = _raw(src)
        return NDArray(x + torch.from_numpy(rgb).to(x.device))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = torch.as_tensor(np.asarray(mean, np.float32))
        self.std = torch.as_tensor(np.asarray(std, np.float32))

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_mirror=False,
                    mean=None, std=None, brightness=0, contrast=0,
                    saturation=0, hue=0, pca_noise=0, rng=None, **kwargs):
    """The augmenter list of ``data_shape`` (C, H, W) and the options, in
    the JAX package's order; the random ones draw from ``rng``."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    auglist.append(RandomCropAug(crop_size, rng=rng) if rand_crop
                   else CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5, rng=rng))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation,
                                      rng=rng))
    if hue:
        auglist.append(HueJitterAug(hue, rng=rng))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, PCA_EIGVAL, PCA_EIGVEC,
                                   rng=rng))
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std if std is not None
                                         else 1.0))
    return auglist

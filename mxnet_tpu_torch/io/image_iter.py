"""ImageRecordIter, the ImageNet input pipeline: counterpart of
``mxnet_tpu/io/image_iter.py`` (the reference's
``src/io/iter_image_recordio_2.cc`` and ``src/io/image_aug_default.cc``).

  - record IO: one offset scan of the ``.rec`` file (or its ``.idx``);
  - JPEG decode: the shared C++ decoder (``native/src/jpeg.cc``, through
    :mod:`mxnet_tpu_torch.native`), called from a thread pool; the C call
    releases the GIL, so ``preprocess_threads`` decode in parallel;
  - augment: the short-edge resize in the C++ uint8 kernel, the center or
    random crop and the random mirror as numpy views (exact);
  - batchify: one threaded C++ pass to NCHW float32 with mean/std.

Batches are NDArrays on ``ctx``, the host by default, as the reference's
iterator gives them; ``io.DevicePrefetcher`` (and ``TrainStep.run``)
takes the iterator as it takes ``NDArrayIter`` and copies each group to
the card off the training loop. The draws for crops and mirrors come
from ``numpy.random.RandomState(seed)`` in the JAX package's order, so
both packages give the same batches.

Sharding: ``num_parts``/``part_index`` slice the record set per worker, the
contract of ``ImageRecordIter(kvstore='dist_sync')``.
"""
from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..ndarray import array
from .io import DataBatch, DataDesc, DataIter
from .recordio import _KMAGIC, unpack

__all__ = ["ImageRecordIter", "imdecode_record"]


def _scan_offsets(path):
    """Walk a .rec file once, returning every record's byte offset."""
    offsets = []
    with open(path, "rb") as f:
        data = f.read()
    pos, n = 0, len(data)
    while pos + 8 <= n:
        magic, lrec = struct.unpack_from("<II", data, pos)
        if magic != _KMAGIC:
            raise MXNetError(f"{path}: bad record magic at offset {pos}")
        length = lrec & ((1 << 29) - 1)
        offsets.append(pos)
        pos += 8 + length + (-length % 4)
    return offsets


def _read_idx(path_imgidx):
    offsets = []
    with open(path_imgidx) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) >= 2:
                offsets.append(int(parts[1]))
    return offsets


def imdecode_record(payload):
    """Decode one packed record payload into (header, HWC uint8 image).
    JPEG bytes go through the shared C++ decoder; ``.npy`` payloads
    (``pack_img``'s lossless format) load directly."""
    header, img_bytes = unpack(payload)
    if img_bytes[:2] == b"\xff\xd8":
        from ..native import jpeg_decode

        return header, jpeg_decode(bytes(img_bytes))
    if img_bytes[:6] == b"\x93NUMPY":
        import io as _io

        img = np.load(_io.BytesIO(bytes(img_bytes)))
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        return header, img
    raise MXNetError("record payload is neither JPEG nor npy")


class ImageRecordIter(DataIter):
    """Threaded decode -> augment -> batchify over an im2rec ``.rec`` pack.

    Parameters mirror the reference's ``mx.io.ImageRecordIter``:
    ``data_shape=(C,H,W)``, ``batch_size``, ``shuffle``, ``rand_crop``,
    ``rand_mirror``, ``mean_r/g/b``, ``std_r/g/b``, ``resize`` (short edge),
    ``label_width``, ``preprocess_threads``, ``num_parts``/``part_index``,
    ``round_batch``; ``ctx`` places the batches (default: the host).
    """

    def __init__(self, path_imgrec, data_shape, batch_size, path_imgidx=None,
                 shuffle=False, rand_crop=False, rand_mirror=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0,
                 resize=-1, label_width=1, preprocess_threads=4,
                 num_parts=1, part_index=0, round_batch=True, seed=0,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 ctx=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        self._path = path_imgrec
        self._shape = tuple(int(s) for s in data_shape)
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._mean = [mean_r, mean_g, mean_b]
        self._std = [std_r, std_g, std_b]
        self._resize = resize
        self._label_width = int(label_width)
        self._threads = max(1, int(preprocess_threads))
        self._round_batch = round_batch
        self._rng = np.random.RandomState(seed)
        self._data_name, self._label_name = data_name, label_name
        self._dtype = dtype
        self._ctx = cpu() if ctx is None else ctx

        offsets = (_read_idx(path_imgidx) if path_imgidx
                   else _scan_offsets(path_imgrec))
        if num_parts > 1:  # worker sharding, reference num_parts semantics
            offsets = offsets[part_index::num_parts]
        if not offsets:
            raise MXNetError(f"{path_imgrec}: no records (part {part_index}/{num_parts})")
        self._offsets = offsets
        self._file = open(path_imgrec, "rb")
        self._pool = ThreadPoolExecutor(max_workers=self._threads)
        self._order = None
        self._cursor = 0
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size,) + self._shape,
                         self._dtype, "NCHW")]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self._label_width == 1
                 else (self.batch_size, self._label_width))
        return [DataDesc(self._label_name, shape, "float32", "N")]

    def reset(self):
        self._order = np.arange(len(self._offsets))
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _read_record(self, offset):
        self._file.seek(offset)
        head = self._file.read(8)
        magic, lrec = struct.unpack("<II", head)
        length = lrec & ((1 << 29) - 1)
        return self._file.read(length)

    def _process_one(self, payload, crop_xy, mirror):
        from .. import native as _nat

        header, img = imdecode_record(payload)
        c, th, tw = self._shape
        h, w = img.shape[:2]
        if self._resize > 0:  # short-edge resize
            scale = self._resize / min(h, w)
            nh, nw = max(th, int(round(h * scale))), max(tw, int(round(w * scale)))
            img = _nat.image_resize(img, nh, nw)
            h, w = nh, nw
        if h < th or w < tw:  # upscale tiny images to cover the crop
            img = _nat.image_resize(img, max(h, th), max(w, tw))
            h, w = img.shape[:2]
        y0, x0 = ((int(crop_xy[0] * (h - th)), int(crop_xy[1] * (w - tw)))
                  if self._rand_crop else ((h - th) // 2, (w - tw) // 2))
        img = img[y0:y0 + th, x0:x0 + tw]
        if mirror:
            img = img[:, ::-1]
        img = np.ascontiguousarray(img)
        if self._label_width == 1:
            label = float(header.label if np.isscalar(header.label)
                          else np.asarray(header.label).ravel()[0])
            return img, label
        lab = np.zeros(self._label_width, np.float32)
        arr = np.asarray(header.label, np.float32).ravel()
        lab[:min(len(arr), self._label_width)] = arr[:self._label_width]
        return img, lab

    def next(self):
        n = len(self._order)
        if self._cursor >= n:
            raise StopIteration
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        pad = 0
        if len(idx) < self.batch_size:
            if not self._round_batch:
                raise StopIteration
            pad = self.batch_size - len(idx)
            idx = np.concatenate([idx, self._order[:pad]])
        self._cursor += self.batch_size

        payloads = [self._read_record(self._offsets[i]) for i in idx]
        crops = self._rng.rand(len(payloads), 2)
        mirrors = (self._rng.rand(len(payloads)) < 0.5) if self._rand_mirror \
            else np.zeros(len(payloads), bool)
        results = list(self._pool.map(self._process_one, payloads, crops, mirrors))
        imgs = np.stack([r[0] for r in results])  # (N,H,W,C)
        labels = np.stack([r[1] for r in results])

        from ..native import batch_to_chw_float

        batch = batch_to_chw_float(imgs, mean=self._mean, std=self._std,
                                   nthreads=self._threads)
        data = array(batch, ctx=self._ctx, dtype=self._dtype)
        return DataBatch(data=[data],
                         label=[array(labels.astype(np.float32),
                                      ctx=self._ctx)],
                         pad=pad, index=idx.copy())

    def close(self):
        """Release the decode pool and the file. Not to be called while
        another thread is inside ``next()``."""
        self._pool.shutdown(wait=True)
        self._file.close()

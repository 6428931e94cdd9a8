"""Vision datasets: counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``
(``python/mxnet/gluon/data/vision/datasets.py``).

Nothing is downloaded: a dataset reads its local files when they are there
(the standard IDX and CIFAR binary formats) and otherwise makes the JAX
package's seeded synthetic set of the same shape, byte for byte. A sample
is ``(HWC uint8 NDArray on the host, int32 label)``, as MXNet's datasets
give it; the ``DataLoader`` moves each stacked batch to the current
context.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..dataset import ArrayDataset, Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageRecordDataset"]


def _host(a):
    from ....context import cpu
    from ....ndarray import array

    return array(a, ctx=cpu())


def _synthetic(n, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    # make labels weakly learnable: bias pixel intensity by class
    data = np.clip(data.astype(np.int32) + (label * 13 % 64)[:, None, None, None], 0, 255
                   ).astype(np.uint8)
    return data, label


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        d = _host(self._data[idx])
        l = self._label[idx]
        if self._transform is not None:
            return self._transform(d, l)
        return d, l

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/mnist", train=True, transform=None):
        self._base = "train" if train else "t10k"
        super().__init__(root, train, transform)

    def _get_data(self):
        img = os.path.join(self._root, f"{self._base}-images-idx3-ubyte.gz")
        lab = os.path.join(self._root, f"{self._base}-labels-idx1-ubyte.gz")
        if os.path.exists(img) and os.path.exists(lab):
            with gzip.open(lab, "rb") as f:
                struct.unpack(">II", f.read(8))
                label = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(img, "rb") as f:
                _, n, r, c = struct.unpack(">IIII", f.read(16))
                data = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, r, c, 1)
        else:
            n = 60000 if self._train else 10000
            data, label = _synthetic(min(n, 8192), (28, 28, 1), 10, 42 if self._train else 43)
        self._data, self._label = data, label


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True, transform=None):
        super().__init__(root, train, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if self._train
                 else ["test_batch.bin"])
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = [], []
            for p in paths:
                raw = np.fromfile(p, dtype=np.uint8).reshape(-1, 3073)
                label.append(raw[:, 0].astype(np.int32))
                data.append(raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
            self._data = np.concatenate(data)
            self._label = np.concatenate(label)
        else:
            n = 4096 if self._train else 1024
            self._data, self._label = _synthetic(n, (32, 32, 3), 10, 44 if self._train else 45)


class CIFAR100(CIFAR10):
    def __init__(self, root="~/.mxnet/datasets/cifar100", train=True,
                 fine_label=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        n = 4096 if self._train else 1024
        self._data, self._label = _synthetic(n, (32, 32, 3), 100 if self._fine else 20,
                                             46 if self._train else 47)


class ImageRecordDataset(Dataset):
    """Images packed in a RecordIO file (reference: image record in
    ``src/io``); JPEG payloads decode through the shared C++ decoder."""

    def __init__(self, filename, flag=1, transform=None):
        from ....io.recordio import IndexedRecordIO, unpack_img

        idx = filename[:-4] + ".idx" if filename.endswith(".rec") else filename + ".idx"
        self._record = IndexedRecordIO(idx, filename, "r")
        self._transform = transform
        self._unpack = unpack_img

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack(record)
        label = header.label
        if self._transform is not None:
            return self._transform(_host(img), label)
        return _host(img), label

    def __len__(self):
        return len(self._record.keys)


class ImageFolderDataset(Dataset):
    """A dataset of images in class-per-subdirectory layout (reference:
    ``gluon/data/vision/datasets.py ImageFolderDataset``): ``root/cat/x.jpg``
    -> label = index of sorted('cat', ...). JPEG decodes through the shared
    C++ decoder; ``.npy`` payloads load directly."""

    def __init__(self, root, flag=1, transform=None):
        import os as _os

        self._root = _os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        exts = (".jpg", ".jpeg", ".png", ".npy")
        for folder in sorted(_os.listdir(self._root)):
            path = _os.path.join(self._root, folder)
            if not _os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(_os.listdir(path)):
                if fname.lower().endswith(exts):
                    self.items.append((_os.path.join(path, fname), label))
        if not self.items:
            raise ValueError(f"no images under {self._root} "
                             f"(extensions: {exts})")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from ....image import imdecode

        path, label = self.items[idx]
        with open(path, "rb") as f:
            # imdecode reads the magic bytes (JPEG / npy / PIL), not the
            # extension, and honors flag=0 (grayscale)
            data = imdecode(f.read(), flag=self._flag)
        if self._transform is not None:
            return self._transform(data, label)
        return data, label


__all__ += ["ImageFolderDataset"]

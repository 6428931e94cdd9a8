"""Datasets: a copy of ``mxnet_tpu/gluon/data/dataset.py``."""
from __future__ import annotations

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        return _LazyTransformDataset(self, fn)

    def transform_first(self, fn, lazy=True):
        return self.transform(_first_tf(fn), lazy)


def _first_tf(fn):
    def tf(*sample):
        if len(sample) == 1:
            return fn(sample[0])
        return (fn(sample[0]),) + sample[1:]

    return tf


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data, self._fn = data, fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    def __init__(self, *args):
        assert args, "needs at least 1 array"
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, \
                "all arrays must have the same length"
            self._data.append(a)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class RecordFileDataset(Dataset):
    """The raw records of a RecordIO file (and its ``.idx``)."""

    def __init__(self, filename):
        from ...io.recordio import IndexedRecordIO

        if filename.endswith(".idx"):
            idx, rec = filename, filename[:-4]
        else:
            idx, rec = filename + ".idx", filename
        self._record = IndexedRecordIO(idx, rec, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)

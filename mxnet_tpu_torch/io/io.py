"""DataIter API: a copy of ``mxnet_tpu/io/io.py`` over the port's NDArray.

``NDArrayIter`` and the iterator protocol (provide_data/provide_label,
reset/next with DataBatch) keep the JAX package's (and MXNet's) iteration,
padding and ``last_batch_handle`` semantics. Batches are NDArrays on the
current context (the card unless the caller names the CPU, ``with
mx.cpu():``).
"""
from __future__ import annotations

import queue
import threading
from collections import namedtuple

import numpy as np

from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray, array

__all__ = ["DataIter", "DataBatch", "DataDesc", "NDArrayIter", "ResizeIter",
           "PrefetchingIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype="float32", layout="NCHW"):
        return super().__new__(cls, name, shape, dtype, layout)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    def prefetch_to_device(self, train_step=None, window=1, accum=1,
                           depth=2, device=None):
        """A :class:`~mxnet_tpu_torch.io.prefetch.DevicePrefetcher` over
        this iterator: a background thread flattens data+label of each
        ``DataBatch``, stacks ``window`` steps (of ``accum`` microbatches)
        and copies them to the device; feed it to ``TrainStep.run``."""
        from .prefetch import DevicePrefetcher

        return DevicePrefetcher(self, train_step=train_step, window=window,
                                accum=accum, depth=depth, device=device)


class NDArrayIter(DataIter):
    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._order = np.arange(self.num_data)
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor < self.num_data
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        out = []
        for _name, arr in arrays:
            idx = self._order[self.cursor:self.cursor + self.batch_size]
            if len(idx) < self.batch_size and self.last_batch_handle == "pad":
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, self._order[:pad]])
            out.append(array(arr[idx]))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        if not allow_empty:
            raise MXNetError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = {default_name: data}
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}_{i}" if i else default_name: d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        out.append((k, v.asnumpy() if isinstance(v, NDArray)
                    else np.asarray(v)))
    return out


class ResizeIter(DataIter):
    """Wraps an iterator to a fixed number of batches per epoch."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Double-buffering via a background thread (MXNet's PrefetcherIter).
    The thread makes its batches in the context current where the
    iterator was created (a context scope is per thread)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        self.iters = iters if isinstance(iters, list) else [iters]
        super().__init__(self.iters[0].batch_size)
        self._queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = None
        self._start()

    def _start(self):
        ctx = current_context()

        def run():
            try:
                with ctx:
                    for batch in self.iters[0]:
                        if self._stop.is_set():
                            return
                        self._queue.put(batch)
            finally:
                self._queue.put(None)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _stop_and_join(self):
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)

    def reset(self):
        self._stop_and_join()
        self._stop.clear()
        self.iters[0].reset()
        self._start()

    def next(self):
        if getattr(self, "_closed", False):
            raise StopIteration
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        return batch

    def iter_next(self):
        try:
            self.current_batch = self.next()
            return True
        except StopIteration:
            return False

    def close(self):
        """Stop the prefetch thread, then close the wrapped iterator
        (join first: the wrapped iterator may still be in ``next()``)."""
        self._stop_and_join()
        self._closed = True  # later next() raises StopIteration, never hangs
        inner = self.iters[0]
        if hasattr(inner, "close"):
            inner.close()

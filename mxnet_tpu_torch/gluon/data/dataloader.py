"""DataLoader: counterpart of ``mxnet_tpu/gluon/data/dataloader.py``.

Workers produce **numpy** batches; iterating the loader moves each batch
to the current context as NDArrays (one batch ahead), and
:meth:`DataLoader.prefetch_to_device` feeds a ``TrainStep`` through a
:class:`~mxnet_tpu_torch.io.prefetch.DevicePrefetcher` over
:meth:`DataLoader.host_batches`, whose thread does the stacking and the
copy to the card off the training loop.

One divergence: ``num_workers > 0`` runs a pool of worker *threads*
(the JAX package's ``thread_pool=True``); it never forks, since a forked
child of a process that holds a CUDA context cannot use the card.
``thread_pool`` and ``pin_memory`` are accepted for MXNet's signature
(the prefetcher pins what it copies). Each batch fetch is the fault
site ``data.batch``, retried.
"""
from __future__ import annotations

import collections
import time
from multiprocessing.pool import ThreadPool

import numpy as np

from ... import observability as _obs
from ...ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples -> one numpy batch (nested tuples preserved)."""
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    first = data[0]
    if isinstance(first, NDArray):
        return np.stack([d.asnumpy() for d in data])
    return np.stack([np.asarray(d) for d in data])


def _to_device(batch):
    if isinstance(batch, tuple):
        return tuple(_to_device(b) for b in batch)
    return array(batch)


_retry_policy = None


def _fetch_batch(dataset, samples, batchify_fn):
    """One batch fetch+batchify — fault site ``data.batch`` under the retry
    policy (built once per process)."""
    global _retry_policy
    from ...resilience import faults, retry

    if _retry_policy is None:
        _retry_policy = retry.RetryPolicy()

    def _fetch():
        faults.fire("data.batch")
        return batchify_fn([dataset[i] for i in samples])

    return retry.retry_call(_fetch, site="data.batch", policy=_retry_policy)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=True):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with explicit "
                                 "sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._pool = ThreadPool(self._num_workers) \
            if self._num_workers > 0 else None

    def __len__(self):
        return len(self._batch_sampler)

    def host_batches(self):
        """Host-side (numpy) batch stream, no device placement — the feed
        of :meth:`prefetch_to_device`."""
        if self._pool is None:
            for samples in self._batch_sampler:
                yield _fetch_batch(self._dataset, samples, self._batchify_fn)
            return
        # pool pipeline with bounded in-flight requests
        pending = collections.deque()
        it = iter(self._batch_sampler)

        def issue():
            try:
                samples = next(it)
            except StopIteration:
                return False
            pending.append(self._pool.apply_async(
                _fetch_batch, (self._dataset, samples, self._batchify_fn)))
            return True

        for _ in range(self._prefetch or 1):
            if not issue():
                break
        while pending:
            batch = pending.popleft().get()
            issue()
            yield batch

    def __iter__(self):
        # input-pipeline telemetry: "wait" is the time this generator spends
        # producing a ready device batch, "compute" the time the consumer
        # holds between yields; a stall is an iteration that waited longer
        # than the step took
        obs_on = _obs.enabled()

        def _note(wait, compute):
            _obs.histogram("data_batch_wait_seconds",
                           "time the step loop waited on the input pipeline",
                           unit="s").observe(wait)
            if compute is not None:
                _obs.histogram("data_compute_seconds",
                               "consumer time between batches",
                               unit="s").observe(compute)
                if wait > compute:
                    _obs.counter("data_stalls_total",
                                 "iterations where batch-wait exceeded "
                                 "consumer compute").inc()
                    _obs.emit("data_stall", wait_seconds=round(wait, 6),
                              compute_seconds=round(compute, 6))

        prev = None  # one batch ahead: overlap the copy with consumption
        compute = None
        src = self.host_batches()
        while True:
            t0 = time.perf_counter() if obs_on else 0.0
            try:
                batch = next(src)
            except StopIteration:
                break
            cur = _to_device(batch)
            if obs_on:
                _note(time.perf_counter() - t0, compute)
            if prev is not None:
                y0 = time.perf_counter() if obs_on else 0.0
                yield prev
                compute = time.perf_counter() - y0 if obs_on else None
            prev = cur
        if prev is not None:
            yield prev

    def prefetch_to_device(self, train_step=None, window=1, accum=1,
                           depth=2, device=None):
        """A :class:`~mxnet_tpu_torch.io.prefetch.DevicePrefetcher` over
        :meth:`host_batches`: its thread stacks ``window`` steps (of
        ``accum`` microbatches) and copies them to the device, for
        ``TrainStep.run`` / ``Trainer.run``."""
        from ...io.prefetch import DevicePrefetcher

        return DevicePrefetcher(self.host_batches(), train_step=train_step,
                                window=window, accum=accum, depth=depth,
                                device=device)

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()

"""Async device prefetch: feed the training step off the hot path.

Counterpart of ``mxnet_tpu/io/prefetch.py``. :class:`DevicePrefetcher`
moves the per-batch host work of a training loop onto a background thread
with a small bounded queue: flattening each batch, stacking ``window ×
accum`` of them for ``TrainStep.run``'s window program, and the copy to
the card, so that the copies overlap the card's compute.

On the card, each group is stacked into pinned host memory and copied to
the device on the prefetcher's own CUDA stream, which then records an
event. The consumer (:meth:`DevicePrefetcher.next_group`) makes its
current stream wait on that event and marks the tensors as used there
(``record_stream``); the host never waits for a copy. A pinned staging
buffer goes back to PyTorch's pinned-memory cache when its group is
placed, and the cache hands it out again only after the copy's event
completed. On the CPU the groups are CPU tensors.

Sources: any iterable of batches — tuples/lists of arrays, tensors or
``NDArray``s, ``DataBatch`` (data+label flattened in order), or a
host-batch stream like ``DataLoader.host_batches()``. Host arrays follow
the NDArray dtype rules (float64 becomes float32, int64 int32).

Queue items are tagged groups: ``("window", stacked_batches, k)`` for a
full window of ``k`` steps (each component ``[k, B, ...]``, or
``[k, accum, B, ...]`` with gradient accumulation), or
``("single", batch, 1)`` for a trailing partial window, consumed by
``TrainStep.run`` as individual steps. A batch whose shapes differ from
the group's (a ragged tail) ends the group. Under ``accum > 1`` a partial
window is emitted as a smaller window of whole accumulation groups, and a
remainder short of one group is dropped and counted in
``prefetch_dropped_batches_total``.

Telemetry: ``prefetch_queue_depth`` gauge, ``prefetch_stalls_total``
counter + ``prefetch_wait_seconds`` histogram when the consumer blocks on
an empty queue, ``prefetch_batches_total`` counter.
"""
from __future__ import annotations

import queue as _queuelib
import threading
import time

import torch

from .. import observability as _obs
from ..base import resolve_device
from ..context import current_context
from ..ndarray import NDArray, _from_host

__all__ = ["DevicePrefetcher"]

_SENTINEL = object()


def _flatten_batch(item):
    """One source item as a flat tuple of CPU tensors."""
    from .io import DataBatch

    if isinstance(item, DataBatch):
        parts = list(item.data or []) + list(item.label or [])
    else:
        parts = [item]
    flat = []

    def rec(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                rec(y)
        else:
            flat.append(x)

    rec(parts)
    out = []
    for p in flat:
        if isinstance(p, NDArray):
            p = p._data
        out.append(p.detach().cpu() if torch.is_tensor(p) else _from_host(p))
    return tuple(out)


class DevicePrefetcher:
    """Background-thread device prefetch queue (see module docstring).

    Parameters
    ----------
    source : iterable of batches (see module docstring for accepted forms).
    train_step : a ``parallel.TrainStep`` or None: its device is the
        target, and the prefetcher attaches itself to it.
    window : stack this many consecutive steps into one tensor per input
        (the k of the window program).
    accum : microbatches per step — each window element consumes
        ``accum`` source batches, stacked as a second leading dim.
    depth : max ready groups in the queue (2 = double buffering).
    device : the target without a ``train_step``; default the card.
    """

    def __init__(self, source, train_step=None, window=1, accum=1, depth=2,
                 device=None):
        if window < 1 or accum < 1:
            raise ValueError("window and accum must be >= 1")
        self.window = int(window)
        self.accum = int(accum)
        if train_step is not None:
            self.device = train_step.device
        else:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        self._source = source
        self._train_step = train_step
        self._queue = _queuelib.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._exc = None
        self._done = False
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # a source that makes NDArrays (NDArrayIter) makes them in the
        # creator's context: a context scope is per thread
        self._ctx = current_context()
        # registered up front: "armed" is observable before the first stall
        _obs.counter("prefetch_stalls_total",
                     "consumer blocked on an empty device-prefetch queue")
        _obs.gauge("prefetch_queue_depth",
                   "ready groups in the device-prefetch queue")
        if train_step is not None:
            train_step.attach_prefetcher(self)
        self._thread = threading.Thread(
            target=self._producer, name="mxnet-tpu-torch-device-prefetch",
            daemon=True)
        self._thread.start()

    # -- device placement ----------------------------------------------------
    def _to_device(self, host):
        """CPU tensors (pinned on the way to the card) -> device tensors,
        copied on the prefetcher's stream; returns them and the event the
        consumer waits on (None on the CPU)."""
        if self._stream is None:
            return tuple(host), None
        with torch.cuda.stream(self._stream):
            out = tuple(t.pin_memory().to(self.device, non_blocking=True)
                        for t in host)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _place_single(self, host_tuple):
        return self._to_device(host_tuple)

    def _place_window(self, group):
        """Stack a full group of window*accum host batches into one tensor
        per input component: [k(,accum),B,...]."""
        k = len(group) // self.accum
        comps = []
        for j in range(len(group[0])):
            stacked = torch.stack([g[j] for g in group])
            if self.accum > 1:
                stacked = stacked.reshape((k, self.accum)
                                          + tuple(stacked.shape[1:]))
            comps.append(stacked)
        placed, event = self._to_device(comps)
        return placed, k, event

    # -- producer thread -----------------------------------------------------
    def _producer(self):
        group_n = self.window * self.accum
        pending = None  # a batch whose shapes broke the current group
        exhausted = False
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._ctx.__enter__()
            it = iter(self._source)
            while not self._stop.is_set() and \
                    not (exhausted and pending is None):
                group = []
                if pending is not None:
                    group.append(pending)
                    pending = None
                while len(group) < group_n and not self._stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    h = _flatten_batch(item)
                    # stacking needs equal shapes: a ragged batch (a
                    # DataLoader last_batch="keep" tail, a shape change)
                    # flushes the current group and starts the next one
                    if group and tuple(a.shape for a in h) != \
                            tuple(a.shape for a in group[0]):
                        pending = h
                        break
                    group.append(h)
                if self._stop.is_set():
                    return
                if not group:
                    break
                placed = len(group)
                if len(group) == group_n and group_n > 1:
                    payload, k, event = self._place_window(group)
                    self._enqueue(("window", payload, k, event))
                elif self.accum > 1:
                    # partial window: keep accumulation, emit the whole
                    # accum-groups as a smaller window and drop a
                    # sub-group remainder (it would train at another
                    # effective batch size)
                    k, rem = divmod(len(group), self.accum)
                    placed = k * self.accum
                    if k:
                        payload, k, event = self._place_window(
                            group[:placed])
                        self._enqueue(("window", payload, k, event))
                    if rem:
                        _obs.counter(
                            "prefetch_dropped_batches_total",
                            "trailing microbatches short of one full "
                            "accumulation group").inc(rem)
                        _obs.emit("prefetch_dropped", batches=rem,
                                  accum=self.accum)
                else:
                    # partial window (or window=accum=1): single steps
                    for h in group:
                        payload, event = self._place_single(h)
                        self._enqueue(("single", payload, 1, event))
                if placed and _obs.enabled():
                    _obs.counter("prefetch_batches_total",
                                 "host batches moved to device by the "
                                 "prefetcher").inc(placed)
        except BaseException as e:  # surfaced to the consumer
            self._exc = e
        finally:
            self._finish()

    def _enqueue(self, item):
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                if _obs.enabled():
                    _obs.gauge("prefetch_queue_depth").set(self._queue.qsize())
                return
            except _queuelib.Full:
                continue

    def _finish(self):
        while True:
            try:
                self._queue.put(_SENTINEL, timeout=0.1)
                return
            except _queuelib.Full:
                if self._stop.is_set():
                    return  # close() is draining and won't wait on a sentinel

    # -- consumer ------------------------------------------------------------
    def next_group(self):
        """Blocking pop: ``(kind, payload, n_steps)`` where kind is
        ``"window"`` (stacked device batches) or ``"single"`` (one device
        batch), or ``(None, None, 0)`` once the source is exhausted. The
        caller's current stream waits for the group's copy. Re-raises any
        producer-side exception."""
        if self._done:
            return (None, None, 0)
        t0 = time.perf_counter()
        stalled = False
        try:
            item = self._queue.get_nowait()
        except _queuelib.Empty:
            stalled = True
            item = self._queue.get()
        if item is _SENTINEL:
            self._done = True
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
            return (None, None, 0)
        if _obs.enabled():
            _obs.gauge("prefetch_queue_depth").set(self._queue.qsize())
            if stalled:
                _obs.counter("prefetch_stalls_total").inc()
                _obs.histogram("prefetch_wait_seconds",
                               "time the consumer blocked on the prefetch "
                               "queue", unit="s").observe(
                                   time.perf_counter() - t0)
        kind, payload, n, event = item
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for t in payload:
                t.record_stream(cur)
        return kind, payload, n

    def __iter__(self):
        return self

    def __next__(self):
        kind, payload, _n = self.next_group()
        if kind is None:
            raise StopIteration
        return payload

    def close(self):
        """Stop the producer, drain the queue, and detach from the train
        step. Idempotent; safe mid-stream."""
        self._stop.set()
        thread = getattr(self, "_thread", None)
        while thread is not None and thread.is_alive():
            try:
                self._queue.get_nowait()
            except _queuelib.Empty:
                pass
            thread.join(timeout=0.05)
        self._done = True
        ts = getattr(self, "_train_step", None)
        if ts is not None and getattr(ts, "_prefetcher", None) is self:
            ts._prefetcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

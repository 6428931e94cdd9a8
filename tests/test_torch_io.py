"""The port's data path (``io/io.py``, ``io/prefetch.py``,
``gluon/data``) against the JAX package's, mirroring tests/test_io.py and
the prefetcher cases of tests/test_train_window.py: the same batches, in
the same order, with the same padding, ``last_batch`` and tail
semantics."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.io.prefetch import DevicePrefetcher as JPrefetcher
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.io import NDArrayIter, PrefetchingIter, ResizeIter
from mxnet_tpu_torch.io.prefetch import DevicePrefetcher
from mxnet_tpu_torch.resilience import faults

from test_torch_train_loop import _batches

CPU = "cpu"


def _host(x):
    x = getattr(x, "_data", x)
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _iter_batches(mx, *args, **kw):
    with mx.cpu():
        it = mx.io.NDArrayIter(*args, **kw)
        out = [([_host(d) for d in b.data], [_host(l) for l in b.label],
                b.pad) for b in it]
        it.reset()
        again = len(list(it))
    return out, again


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches_jax(handle):
    data = np.arange(20).reshape(10, 2).astype(np.float32)
    label = np.arange(10).astype(np.float32)
    kw = dict(batch_size=4, last_batch_handle=handle)
    tb, tn = _iter_batches(tmx, data, label, **kw)
    jb, jn = _iter_batches(jmx, data, label, **kw)
    assert tn == jn == len(tb) == len(jb)
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)


def test_ndarray_iter_basic():
    with tmx.cpu():
        it = NDArrayIter(np.arange(20).reshape(10, 2).astype(np.float32),
                         np.arange(10).astype(np.float32), batch_size=4)
        batches = list(it)
        assert len(batches) == 3
        assert batches[0].data[0].shape == (4, 2)
        assert batches[-1].pad == 2
        assert it.provide_data[0].shape == (4, 2)
        assert it.provide_label[0].name == "softmax_label"
        it.reset()
        assert len(list(it)) == 3
    with pytest.raises(MXNetError):
        NDArrayIter(None)


def test_resize_and_prefetching_iter():
    with tmx.cpu():
        base = NDArrayIter(np.zeros((8, 2)), np.zeros(8), batch_size=4)
        assert len(list(ResizeIter(base, 5))) == 5  # wraps around
        pf = PrefetchingIter(NDArrayIter(np.zeros((8, 2)), np.zeros(8),
                                         batch_size=4))
        assert len(list(pf)) == 2
        pf.reset()
        assert len(list(pf)) == 2
        pf.close()
        with pytest.raises(StopIteration):
            pf.next()


def _loader_batches(mx, ds_args, **kw):
    np.random.seed(3)  # RandomSampler draws from numpy's global stream
    with mx.cpu():
        ds = mx.gluon.data.ArrayDataset(*ds_args)
        loader = mx.gluon.data.DataLoader(ds, **kw)
        return [tuple(_host(x) for x in b) for b in loader], len(loader)


@pytest.mark.parametrize("kw", [
    dict(batch_size=3), dict(batch_size=3, last_batch="discard"),
    dict(batch_size=5, shuffle=True, last_batch="discard"),
    dict(batch_size=4, shuffle=True), dict(batch_size=3, num_workers=2)],
    ids=["keep", "discard", "shuffle-discard", "shuffle", "workers"])
def test_dataloader_matches_jax(kw):
    args = (np.arange(20).reshape(10, 2).astype(np.float32),
            np.arange(10).astype(np.float32))
    jkw = dict(kw)
    if "num_workers" in kw:
        jkw["thread_pool"] = True
    tb, tn = _loader_batches(tmx, args, **kw)
    jb, jn = _loader_batches(jmx, args, **jkw)
    assert tn == jn and len(tb) == len(jb)
    for a, b in zip(tb, jb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_dataloader_transform_batchify_and_samplers():
    with tmx.cpu():
        ds = tmx.gluon.data.ArrayDataset(np.ones((6, 2), np.float32))
        loader = tmx.gluon.data.DataLoader(ds.transform(lambda x: x * 2),
                                           batch_size=2)
        for b in loader:
            np.testing.assert_allclose(b.asnumpy(), np.full((2, 2), 2.0))
        pairs = tmx.gluon.data.SimpleDataset(
            [(np.float32(i), i) for i in range(5)]).transform_first(
                lambda x: x + 1)
        summed = tmx.gluon.data.DataLoader(
            pairs, batch_size=5, batchify_fn=lambda s: np.sum(
                [a for a, _ in s]))
        assert [b.asnumpy().item() for b in summed] == [15.0]
    bs = tmx.gluon.data.BatchSampler(tmx.gluon.data.SequentialSampler(7), 3,
                                     "rollover")
    assert list(bs) == [[0, 1, 2], [3, 4, 5]]
    assert list(bs) == [[6, 0, 1], [2, 3, 4]]  # the rolled-over tail leads
    assert len(tmx.gluon.data.BatchSampler(
        tmx.gluon.data.SequentialSampler(7), 3, "discard")) == 2


def test_dataloader_batch_fault_is_retried():
    tmx.config.set("retry_base_delay", 0.001)
    faults.reset()
    try:
        faults.load_spec("data.batch:every=3;seed=5")
        ds = tmx.gluon.data.ArrayDataset(
            np.arange(24, dtype=np.float32).reshape(12, 2),
            np.arange(12, dtype=np.float32))
        with tmx.cpu():
            seen = sum(b.shape[0] for b, _l in
                       tmx.gluon.data.DataLoader(ds, batch_size=4))
    finally:
        faults.reset()
        tmx.config._values.pop("retry_base_delay", None)
    assert seen == 12  # every batch arrived despite injected fetch faults


# -- the device prefetch queue (tests/test_train_window.py) -------------------
def _groups(pf):
    out = []
    while True:
        kind, payload, n = pf.next_group()
        if kind is None:
            return out
        out.append((kind, [_host(p) for p in payload], n))


def test_prefetcher_matches_jax_groups():
    """Windows, accumulation groups, a ragged tail and the dropped
    remainder: the port's groups are the JAX prefetcher's."""
    data = _batches(7, b=4) + _batches(2, b=2)
    for window, accum in ((2, 1), (2, 2), (3, 1), (1, 1)):
        pf = DevicePrefetcher(iter(data), window=window, accum=accum,
                              device=CPU)
        jpf = JPrefetcher(iter(data), window=window, accum=accum)
        tg, jg = _groups(pf), _groups(jpf)
        pf.close()
        jpf.close()
        assert [(k, n) for k, _, n in tg] == [(k, n) for k, _, n in jg]
        for (_, a, _), (_, b, _) in zip(tg, jg):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_prefetcher_handles_ragged_tail_batch():
    data = _batches(4, b=4) + _batches(1, b=2)
    pf = DevicePrefetcher(iter(data), window=2, device=CPU)
    kinds = [(k, n, p[0].shape) for k, p, n in _groups(pf)]
    assert [(k, n) for k, n, _ in kinds] == \
        [("window", 2), ("window", 2), ("single", 1)]
    assert kinds[-1][2][0] == 2  # the ragged 2-sample tail survived intact
    pf.close()


def test_prefetcher_orders_windows_and_tail():
    data = _batches(5, b=2)
    pf = DevicePrefetcher(iter(data), window=2, device=CPU)
    groups = _groups(pf)
    assert [(k, n) for k, _, n in groups] == \
        [("window", 2), ("window", 2), ("single", 1)]
    np.testing.assert_array_equal(groups[0][1][0][0], data[0][0])
    np.testing.assert_array_equal(groups[0][1][0][1], data[1][0])
    np.testing.assert_array_equal(groups[1][1][1][0], data[2][1])
    np.testing.assert_array_equal(groups[2][1][0], data[4][0])
    assert pf.next_group()[0] is None
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    pf.close()  # idempotent


def test_prefetcher_converts_host_dtypes_as_ndarray_does():
    ids = np.arange(8, dtype=np.int64).reshape(2, 4)
    x = np.ones((2, 3), np.float64)
    pf = DevicePrefetcher(iter([(ids, x), (ids, x)]), window=2, device=CPU)
    (_kind, (a, b), _n), = [pf.next_group()]
    assert a.dtype == torch.int32 and b.dtype == torch.float32
    assert tuple(a.shape) == (2, 2, 4)
    pf.close()


def test_prefetcher_propagates_source_error():
    def bad():
        yield (np.ones((2, 3), np.float32),)
        raise ValueError("boom")

    pf = DevicePrefetcher(bad(), window=2, device=CPU)
    with pytest.raises(ValueError, match="boom"):
        while pf.next_group()[0] is not None:
            pass
    pf.close()


def test_prefetcher_close_mid_stream_joins_producer():
    pf = DevicePrefetcher(iter(_batches(64, b=2)), window=2, depth=2,
                          device=CPU)
    kind, _payload, _n = pf.next_group()
    assert kind == "window"
    pf.close()  # must unblock the producer's put and join without hanging
    assert not pf._thread.is_alive()
    assert pf.next_group()[0] is None


def test_prefetcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        DevicePrefetcher(iter([]), window=2)
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), window=0, device=CPU)


def test_prefetcher_telemetry(tmp_path):
    tobs.enable(str(tmp_path))
    try:
        moved = tobs.counter("prefetch_batches_total").total()
        pf = DevicePrefetcher(iter(_batches(4)), window=2, device=CPU)
        assert len(list(pf)) == 2
        pf.close()
        assert tobs.counter("prefetch_batches_total").total() == moved + 4
        assert tobs.gauge("prefetch_queue_depth").value() is not None
    finally:
        tobs.shutdown()
        tobs.disable()


def test_dataloader_prefetch_to_device_adapter():
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    y = np.arange(16, dtype=np.float32)
    loader = tmx.gluon.data.DataLoader(tmx.gluon.data.ArrayDataset(x, y),
                                       batch_size=4)
    pf = loader.prefetch_to_device(window=2, device=CPU)
    wins = list(pf)
    assert len(wins) == 2  # 4 batches -> 2 stacked windows
    assert tuple(wins[0][0].shape) == (2, 4, 2)
    np.testing.assert_array_equal(_host(wins[0][0][0]), x[:4])
    np.testing.assert_array_equal(_host(wins[1][1][1]), y[12:])
    pf.close()


def test_ndarrayiter_prefetch_to_device_flattens_databatch():
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.float32)
    with tmx.cpu():
        it = NDArrayIter(x, y, batch_size=4)
        pf = it.prefetch_to_device(window=2, device=CPU)
        wins = list(pf)
    assert len(wins) == 1
    assert tuple(wins[0][0].shape) == (2, 4, 3)  # data
    assert tuple(wins[0][1].shape) == (2, 4)     # label
    pf.close()

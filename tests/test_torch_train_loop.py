"""The port's training loop (``TrainStep.run`` with ``window=``/``accum=``,
``gluon.Trainer.run``, ``attach_monitor``) against itself and against the
JAX package's, mirroring tests/test_train_window.py on the same seeded
numpy batches from carried weights.

Within the port a window is bit-identical to the same number of single
steps (losses, weights, moments, step count, the float16 carry); against
the JAX ``run`` it agrees at that file's tolerances (2e-5; accumulation
5e-5 on losses, 1e-4 on weights)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.contrib.amp import Policy
from mxnet_tpu_torch.io.prefetch import DevicePrefetcher
from mxnet_tpu_torch.parallel import TrainStep

IN, OUT = 6, 4
TOL = dict(rtol=2e-5, atol=1e-6)


def _weights(seed=0):
    rs = np.random.RandomState(100 + seed)
    return {"0.weight": rs.randn(16, IN).astype(np.float32) * 0.3,
            "0.bias": rs.randn(16).astype(np.float32) * 0.1,
            "1.weight": rs.randn(OUT, 16).astype(np.float32) * 0.3,
            "1.bias": rs.randn(OUT).astype(np.float32) * 0.1}


def _mlp(side="torch", seed=0, dtype=None, exact=False):
    """The JAX file's MLP (Dense(16, relu), Dense(OUT)) with the weights of
    ``_weights(seed)`` (rounded to bfloat16 and back with ``exact``), on
    the CPU, its names in a name scope so that both packages key (and
    order) a checkpoint alike."""
    mx = tmx if side == "torch" else jmx
    weights = _weights(seed)
    if exact:
        weights = {k: torch.from_numpy(v).bfloat16().float().numpy()
                   for k, v in weights.items()}
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential(prefix="mlp_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=IN),
                    mx.gluon.nn.Dense(OUT, in_units=16))
        net.initialize()
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[name]))
        if dtype is not None:
            net.cast(dtype)
    return net


def _loss(out, *labels):
    return ((out - labels[0]) ** 2).mean()


def _make_step(optimizer=None, amp=None, seed=0, dtype=None):
    return TrainStep(_mlp(seed=seed, dtype=dtype), _loss,
                     optimizer or topt.Adam(learning_rate=1e-2), amp=amp)


def _jstep(optimizer=None):
    return JTrainStep(_mlp("jax"), _loss,
                      optimizer or jopt.Adam(learning_rate=1e-2), mesh=None,
                      amp=None)


def _batches(k, b=4, seed=123):
    rs = np.random.RandomState(seed)
    return [(rs.normal(size=(b, IN)).astype(np.float32),
             rs.normal(size=(b, OUT)).astype(np.float32)) for _ in range(k)]


def _state(ts):
    """Every parameter, moment, master and the carry, in a fixed order."""
    out = [p.detach().clone() for _, p in ts._plist]
    for name in sorted(ts.opt_state):
        st = ts.opt_state[name]
        out.extend(t.clone() for t in
                   (st if isinstance(st, (tuple, list)) else (st,))
                   if t is not None)
    out.extend(ts._master[n].clone() for n in sorted(ts._master))
    out.append(ts.step_count.clone())
    if ts.amp_state is not None:
        out.extend(ts.amp_state[k].clone() for k in sorted(ts.amp_state))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _jparams(ts):
    return [np.asarray(v) for _, v in sorted(ts.params.items())]


def _tparams(ts):
    return [p.detach().float().numpy() for _, p in
            sorted(ts._plist, key=lambda e: ts._ckpt_names[e[0]])]


def _sched_sgd(side):
    mx = tmx if side == "torch" else jmx
    return mx.optimizer.SGD(learning_rate=0.1,
                            lr_scheduler=mx.lr_scheduler.FactorScheduler(
                                step=2, factor=0.5))


# -- numerical equivalence ---------------------------------------------------
@pytest.mark.parametrize("sched", [False, True], ids=["const", "scheduled"])
def test_window_matches_sequential_steps(sched):
    """A 4-step window is bit-identical to 4 calls; the JAX ``run`` agrees
    at 2e-5. With the schedule each window step reads the scheduler at
    num_update + i (the rate decays inside the window)."""
    data = _batches(4)
    make = (lambda: _sched_sgd("torch")) if sched else (lambda: None)
    seq = _make_step(make())
    seq_losses = torch.stack([seq(x, y) for x, y in data])
    win = _make_step(make())
    losses = win.run(iter(data), steps=4, window=4)
    assert losses.shape == (4,) and torch.equal(losses, seq_losses)
    _same(_state(win), _state(seq))
    assert win.optimizer.num_update == 4 == int(win.step_count)
    assert win._window_dispatches == 1

    jts = _jstep(_sched_sgd("jax") if sched else None)
    jl = np.asarray(jts.run(iter(data), steps=4, window=4))
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)
    for a, b in zip(_tparams(win), _jparams(jts)):
        np.testing.assert_allclose(a, b, **TOL)


def test_window_accum_matches_full_batch_steps():
    """2 steps × accum=2 over microbatches of 4 == 2 steps over the
    concatenated batches of 8 (5e-5 on losses, 1e-4 on weights), and the
    JAX run with accum=2 agrees at 2e-5."""
    micro = _batches(4, b=4)
    full = [(np.concatenate([micro[2 * i][0], micro[2 * i + 1][0]]),
             np.concatenate([micro[2 * i][1], micro[2 * i + 1][1]]))
            for i in range(2)]
    ts_seq = _make_step()
    seq_losses = [float(ts_seq(x, y)) for x, y in full]
    ts_win = _make_step()
    losses = ts_win.run(iter(micro), steps=2, window=2, accum=2)
    np.testing.assert_allclose(losses.numpy(), seq_losses, rtol=5e-5,
                               atol=1e-6)
    assert int(ts_win.step_count) == 2
    for a, b in zip(_tparams(ts_win), _tparams(ts_seq)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    jts = _jstep()
    jl = np.asarray(jts.run(iter(micro), steps=2, window=2, accum=2))
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)
    for a, b in zip(_tparams(ts_win), _jparams(jts)):
        np.testing.assert_allclose(a, b, **TOL)


def test_accum_window_matches_accum_single_windows():
    """A window of 2 accumulated steps is bit-identical to two windows of
    one (the same body, one program against two)."""
    micro = _batches(4)
    one = _make_step()
    a = torch.cat([one.run(iter(micro[:2]), steps=1, window=1, accum=2),
                   one.run(iter(micro[2:]), steps=1, window=1, accum=2)])
    two = _make_step()
    b = two.run(iter(micro), steps=2, window=2, accum=2)
    assert torch.equal(a, b)
    _same(_state(one), _state(two))


def test_partial_tail_with_accum_stays_accumulated():
    """3 steps, window=2, accum=2: one full window + a k=1 window for the
    tail, never unaccumulated singles; a sub-group remainder is dropped and
    counted."""
    ts = _make_step()
    losses = ts.run(iter(_batches(6)), steps=3, window=2, accum=2)
    assert losses.shape == (3,)
    assert ts._window_dispatches == 2 and int(ts.step_count) == 3
    assert sorted(k[1] for k in ts._programs if k[0] == "window") == [1, 2]
    dropped = tobs.counter("prefetch_dropped_batches_total")
    before = dropped.total()
    ts2 = _make_step()
    losses2 = ts2.run(iter(_batches(5)), window=2, accum=2)  # steps=None
    assert losses2.shape == (2,) and int(ts2.step_count) == 2
    assert dropped.total() == before + 1


def test_partial_tail_falls_back_to_single_steps():
    ts = _make_step()
    losses = ts.run(iter(_batches(5)), steps=5, window=2)
    assert losses.shape == (5,)
    assert ts._window_dispatches == 2  # 2 full windows + 1 single tail
    assert int(ts.step_count) == 5 and ts.optimizer.num_update == 5
    ref = _make_step()
    assert torch.equal(losses, torch.stack([ref(x, y)
                                            for x, y in _batches(5)]))


@pytest.mark.parametrize("amp", ["bfloat16", "float16"])
def test_amp_window_matches_sequential_steps(amp):
    """Under AMP the window keeps the copies, masters and (float16) the
    loss-scale carry exactly as the calls do. The float16 policy starts
    at a scale that overflows, so the window holds a skipped step."""
    pol = Policy(amp, loss_scale=2.0 ** 40) if amp == "float16" else amp
    data = _batches(4)
    seq = _make_step(amp=pol)
    seq_losses = torch.stack([seq(x, y) for x, y in data])
    win = _make_step(amp=pol)
    losses = win.run(iter(data), steps=4, window=4)
    assert torch.equal(losses, seq_losses)
    _same(_state(win), _state(seq))
    _same([win._low[n] for n in sorted(win._low)],
          [seq._low[n] for n in sorted(seq._low)])
    if amp == "float16":
        assert win.amp_skipped_steps >= 1
        assert int(win.step_count) == 4 - win.amp_skipped_steps


def test_low_precision_net_trains_through_masters():
    """A ``net.cast("bfloat16")`` net: the step keeps f32 masters, updates
    them and writes the bf16 parameters in the same pass; a window equals
    the calls bit for bit, and the parameters are their masters rounded."""
    data = _batches(4)
    seq = _make_step(dtype="bfloat16")
    seq_losses = torch.stack([seq(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(y).bfloat16())
                              for x, y in data])
    win = _make_step(dtype="bfloat16")
    bf = [tuple(torch.from_numpy(a).bfloat16() for a in b) for b in data]
    losses = win.run(iter(bf), steps=4, window=2)
    assert torch.equal(losses, seq_losses)
    _same(_state(win), _state(seq))
    assert sorted(win._master) == sorted(n for n, _ in win._plist)
    for name, p in win._plist:
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), win._master[name].bfloat16())


# -- one program per signature, one dispatch per window ----------------------
def test_one_program_per_window_signature(tmp_path):
    tobs.enable(str(tmp_path))
    try:
        rc = tobs.counter("train_recompiles_total")
        before = rc.value(reason="window")
        ts = _make_step()
        ts.run(iter(_batches(8)), steps=8, window=4)
        wkeys = [k for k in ts._programs if k[0] == "window"]
        assert len(wkeys) == 1 and ts.compiled_programs == 1
        assert ts._window_dispatches == 2
        assert rc.value(reason="window") == before + 1
        ts.run(iter(_batches(4)), steps=4, window=4)  # cached
        assert len([k for k in ts._programs if k[0] == "window"]) == 1
        assert rc.value(reason="window") == before + 1
        assert ts._window_dispatches == 3
        ts.run(iter(_batches(4)), steps=4, window=2)  # a new window size
        assert len([k for k in ts._programs if k[0] == "window"]) == 2
        assert rc.value(reason="window") == before + 2
    finally:
        tobs.shutdown()
        tobs.disable()


def test_window_telemetry_records_run_window_loop(tmp_path):
    tobs.enable(str(tmp_path))
    try:
        h = tobs.histogram("train_step_seconds")
        s0 = h.stats(loop="run_window")
        h_before = s0["count"] if s0 else 0
        c_before = tobs.counter("train_steps_total").value(loop="run_window")
        ts = _make_step()
        ts.run(iter(_batches(4)), steps=4, window=2)
        assert h.stats(loop="run_window")["count"] == h_before + 2
        assert tobs.counter("train_steps_total").value(
            loop="run_window") == c_before + 4
        assert tobs.gauge("train_loss").value() is not None
        assert tobs.gauge("train_grad_norm").value() > 0
        # the telemetry program is a separate signature: its results are
        # those of the one without telemetry
        ts(*_batches(1)[0])
        assert tobs.counter("train_steps_total").value(
            loop="train_step") >= 1
    finally:
        tobs.shutdown()
        tobs.disable()
    recs = [e for e in tobs.read_events(str(tmp_path))
            if e["event"] == "train_window"]
    assert len(recs) == 2
    for r in recs:
        assert r["window"] == 2 and r["window_seconds"] > 0
        assert r["step_seconds_amortized"] < r["window_seconds"]


def test_telemetry_leaves_the_losses_unchanged(tmp_path):
    data = _batches(4)
    plain = _make_step().run(iter(data), steps=4, window=2)
    tobs.enable(str(tmp_path))
    try:
        ts = _make_step()
        watched = ts.run(iter(data), steps=4, window=2)
        norm = tobs.gauge("train_grad_norm").value()
    finally:
        tobs.shutdown()
        tobs.disable()
    assert torch.equal(plain, watched)
    assert np.isfinite(norm) and norm > 0


def test_run_rejects_mismatched_prefetcher_config():
    ts = _make_step()
    pf = DevicePrefetcher(iter(_batches(4)), train_step=ts, window=2)
    with pytest.raises(ValueError, match="window=4"):
        ts.run(pf, steps=4, window=4)
    with pytest.raises(ValueError, match="accum=2"):
        ts.run(pf, steps=4, accum=2)
    with pytest.raises(ValueError, match="steps=3"):
        ts.run(pf, steps=3)
    pf.close()
    assert ts._prefetcher is None  # close() detached it


def test_run_accepts_a_dataloader_and_a_prefetcher():
    x = np.random.RandomState(0).normal(size=(16, IN)).astype(np.float32)
    y = np.random.RandomState(1).normal(size=(16, OUT)).astype(np.float32)
    loader = tmx.gluon.data.DataLoader(
        tmx.gluon.data.ArrayDataset(x, y), batch_size=4)
    a = _make_step()
    la = a.run(loader, steps=4, window=2)  # through host_batches()
    b = _make_step()
    lb = b.run(loader.prefetch_to_device(b, window=2), steps=4)
    c = _make_step()
    lc = torch.stack([c(x[i:i + 4], y[i:i + 4]) for i in range(0, 16, 4)])
    assert torch.equal(la, lc) and torch.equal(lb, lc)


def test_empty_source_returns_no_losses():
    ts = _make_step()
    out = ts.run(iter([]), steps=None, window=2)
    assert out.shape == (0,) and ts.optimizer.num_update == 0


# -- Trainer.run -------------------------------------------------------------
def _trainer(side, net, opt="sgd", params=None):
    mx = tmx if side == "torch" else jmx
    return mx.gluon.Trainer(net.collect_params(), opt,
                            params or {"learning_rate": 0.1})


def test_trainer_run_matches_train_step_and_refreshes_states():
    data = _batches(4)
    net = _mlp()
    trainer = _trainer("torch", net)
    losses = trainer.run(net, _loss, iter(data), steps=4, window=2)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert trainer.optimizer.num_update == 4
    assert all(trainer._states_created)
    assert trainer.optimizer._index_update_count == {i: 4 for i in range(4)}
    # a TrainStep sequence from the same weights, bit for bit
    ts = _make_step(topt.SGD(learning_rate=0.1))
    seq = torch.stack([ts(x, y) for x, y in data])
    assert torch.equal(losses, seq)
    for (_, a), (_, b) in zip(sorted(net.named_parameters()), ts._plist):
        assert torch.equal(a, b)
    # and the JAX Trainer.run
    jnet = _mlp("jax")
    jl = np.asarray(_trainer("jax", jnet).run(jnet, _loss, iter(data),
                                               steps=4, window=2))
    np.testing.assert_allclose(losses.numpy(), jl, **TOL)


def test_trainer_run_reseeds_from_net_between_runs():
    """Parameters replaced between run() calls (what an interleaved
    imperative step does) are picked up by the cached TrainStep."""
    data = _batches(2)
    net = _mlp()
    trainer = _trainer("torch", net)
    trainer.run(net, _loss, iter(data), steps=2, window=2)
    cached = trainer._fused[1]
    snap = {}
    with torch.no_grad():
        for i, (name, p) in enumerate(sorted(net.named_parameters())):
            new = np.random.RandomState(50 + i).normal(
                0, 0.1, tuple(p.shape)).astype(np.float32)
            p.copy_(torch.from_numpy(new))
            snap[name] = new
    trainer.run(net, _loss, iter(data), steps=2, window=2)
    assert trainer._fused[1] is cached  # same signature: cache hit
    ref_net = _mlp()
    with torch.no_grad():
        for name, p in ref_net.named_parameters():
            p.copy_(torch.from_numpy(snap[name]))
    ref = TrainStep(ref_net, _loss, topt.SGD(learning_rate=0.1))
    for x, y in data:
        ref(x, y)
    for (_, a), (_, b) in zip(sorted(net.named_parameters()),
                              sorted(ref_net.named_parameters())):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   **TOL)
    # a different loss_fn is a different program family: a new TrainStep
    trainer.run(net, lambda o, *l: ((o - l[0]) ** 2).sum(), iter(data),
                steps=2, window=2)
    assert trainer._fused[1] is not cached


def _imperative(side, net, trainer, x, y):
    mx = tmx if side == "torch" else jmx
    with mx.cpu():
        xa, ya = mx.nd.array(x), mx.nd.array(y)
        with mx.autograd.record():
            loss = ((net(xa) - ya) ** 2).mean()
        loss.backward()
    trainer.step(1)
    return float(loss.asnumpy())


def test_trainer_step_and_run_interleave_as_in_jax():
    """step(), run(2 steps), step() with Adam: the run is seeded from the
    first step's moments and Adam's t, and the last step sees the
    moments the run left; the JAX Trainer agrees at 2e-5."""
    data = _batches(4)
    out = {}
    for side in ("torch", "jax"):
        net = _mlp(side)
        trainer = _trainer(side, net, "adam", {"learning_rate": 1e-2})
        first = _imperative(side, net, trainer, *data[0])
        ran = np.asarray(trainer.run(net, _loss, iter(data[1:3]), steps=2,
                                     window=2))
        last = _imperative(side, net, trainer, *data[3])
        params = [np.asarray(p.data().asnumpy(), np.float32) for _, p in
                  sorted(net._collect_params_with_prefix().items())]
        out[side] = ([first, *ran.tolist(), last], params,
                     dict(trainer.optimizer._index_update_count))
    (tl, tp, tc), (jl, jp, jc) = out["torch"], out["jax"]
    np.testing.assert_allclose(tl, jl, **TOL)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, **TOL)
    assert tc == jc == {i: 4 for i in range(4)}


def test_trainer_run_multi_precision_shares_masters():
    """A bf16 net under multi_precision: run() is seeded with each state's
    master and base, and writes back ``{"master", "base"}`` holding the
    step's own tensors, so a later step() updates the masters run left
    (not masters cast again from the bf16 weights)."""
    data = _batches(3)
    net = _mlp(dtype="bfloat16")
    trainer = _trainer("torch", net, "adam", {"learning_rate": 1e-2,
                                              "multi_precision": True})
    bf = [tuple(torch.from_numpy(a).bfloat16() for a in b) for b in data]
    trainer.run(net, _loss, iter(bf[:2]), steps=2, window=2)
    ts = trainer._fused[1]
    for p, st in zip(trainer._params, trainer._states):
        name = next(n for _, n, q in ts._train if q is p._var)
        assert st["master"] is ts._master[name]
        assert st["base"] is ts.opt_state[name]
        assert torch.equal(p._var.detach(), st["master"].bfloat16())
    masters = [st["master"].clone() for st in trainer._states]
    with tmx.cpu():
        x, y = tmx.nd.array(bf[2][0]), tmx.nd.array(bf[2][1])
        with tmx.autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
    trainer.step(1)
    for before, st in zip(masters, trainer._states):
        assert not torch.equal(before, st["master"])
    assert trainer.optimizer._index_update_count == {i: 3 for i in range(4)}


def _mp_states(trainer):
    """Parameter name -> (master, mean, var, weight) of a multi-precision
    Adam trainer, as f32 numpy arrays."""
    def f32(t):
        return np.asarray(t.detach().float().numpy() if torch.is_tensor(t)
                          else t, np.float32)

    return {p.name: (f32(st["master"]), f32(st["base"][0]),
                     f32(st["base"][1]), f32(p.data().asnumpy()))
            for p, st in zip(trainer._params, trainer._states)}


def _mp_imperative(side, data):
    """The imperative multi_precision loop (record, backward, ``step(1)``)
    of Adam over the bf16 net: the f32-master maths of the JAX
    ``Trainer.step``. Returns the losses and the states."""
    mx = tmx if side == "torch" else jmx
    net = _mlp(side, dtype="bfloat16", exact=True)
    trainer = _trainer(side, net, "adam", {"learning_rate": 1e-2,
                                           "multi_precision": True})
    losses = []
    for x, y in data:
        with mx.cpu():
            xa = mx.nd.array(x).astype("bfloat16")
            ya = mx.nd.array(y).astype("bfloat16")
            with mx.autograd.record():
                loss = _loss(net(xa), ya)
            loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    return np.asarray(losses, np.float32), _mp_states(trainer)


@pytest.mark.parametrize("route", ["train_step", "trainer_run"])
def test_low_precision_route_matches_multi_precision_steps(route):
    """A bf16 net trained through the f32 masters the port's compiled
    route keeps (``TrainStep.run``, or ``Trainer.run`` under
    ``multi_precision``) against the imperative multi_precision loop, which
    does the same f32-master maths: bit for bit within the port, and
    against the JAX package's ``Trainer.step`` loop at the tolerances of
    tests/test_torch_trainer.py's multi-precision case (losses, bf16
    weights, masters, moments). The weights are bf16-exact, so that both
    packages start from the same masters."""
    data = _batches(4)
    bf = [tuple(torch.from_numpy(a).bfloat16() for a in b) for b in data]
    net = _mlp(dtype="bfloat16", exact=True)
    if route == "train_step":
        ts = TrainStep(net, _loss, topt.Adam(learning_rate=1e-2), amp=None)
        losses = ts.run(iter(bf), steps=4, window=2)
        got = {}
        for name, p in ts._plist:
            mean, var = ts.opt_state[name]
            got[ts._ckpt_names[name]] = tuple(
                t.detach().float().numpy()
                for t in (ts._master[name], mean, var, p))
    else:
        trainer = _trainer("torch", net, "adam", {"learning_rate": 1e-2,
                                                  "multi_precision": True})
        losses = trainer.run(net, _loss, iter(bf), steps=4, window=2)
        got = _mp_states(trainer)
    losses = losses.numpy()
    tl, want = _mp_imperative("torch", data)
    np.testing.assert_array_equal(losses, tl)
    assert sorted(got) == sorted(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
    jl, jwant = _mp_imperative("jax", data)
    np.testing.assert_allclose(losses, jl, rtol=2 ** -7, atol=1e-4)
    assert sorted(jwant) == sorted(got)
    for name, (master, mean, var, w) in got.items():
        jm, jmean, jvar, jw = jwant[name]
        np.testing.assert_allclose(master, jm, rtol=2e-3, atol=2e-4,
                                   err_msg=name)
        np.testing.assert_allclose(mean, jmean, rtol=5e-2, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(var, jvar, rtol=5e-2, atol=1e-4,
                                   err_msg=name)
        np.testing.assert_allclose(w, jw, rtol=2 ** -7, atol=1e-4,
                                   err_msg=name)


def test_trainer_run_refuses_a_mesh():
    net = _mlp()
    with pytest.raises(MXNetError, match="not ported"):
        _trainer("torch", net).run(net, _loss, iter(_batches(2)),
                                   layout=object())


# -- monitors ----------------------------------------------------------------
def test_monitor_on_train_step_and_trainer():
    """Every ``interval`` boundaries the monitor reads the parameters (no
    gradient rows under a TrainStep; gradient rows under a Trainer)."""
    net = _mlp()
    ts = _make_step()
    mon = tmx.mon.Monitor(2, pattern=".*weight").install(ts.net,
                                                         train_step=ts)
    seen = []
    orig = mon.toc

    def toc():
        rows = orig()
        seen.append(rows)
        return rows

    mon.toc = toc
    ts.run(iter(_batches(4)), steps=4, window=2)  # 2 window boundaries
    ts(*_batches(1)[0])                          # 1 step boundary
    assert [len(r) for r in seen] == [2, 0, 2]
    assert all(not n.endswith("_grad") for r in seen for _, n, _ in r)
    tr = _trainer("torch", net)
    tmon = tmx.Monitor(1, sort=True).install(net, trainer=tr)
    rows = []
    tmon.toc = (lambda f: lambda: rows.append(f()) or rows[-1])(tmon.toc)
    _imperative("torch", net, tr, *_batches(1)[0])
    names = [n for _, n, _ in rows[0]]
    assert names == sorted(names) and any(n.endswith("_grad")
                                          for n in names)

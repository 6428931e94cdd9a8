"""The port's ``gluon.Trainer`` (and the optimizers' imperative protocol,
``multi_precision``, ``contrib.amp``'s LossScaler) against the JAX
package's, from carried weights on the same numpy batches: 3 steps of SGD,
NAG, Adam and AdamW; Adam with bf16 weights under ``multi_precision``
(the ``{"master", "base"}`` states); ``grad_req="add"``,
``ignore_stale_grad`` and ``set_learning_rate``; ``save_states`` files
read across the packages; a float16 LossScaler overflow skip; and the
linear-regression convergence of tests/test_gluon.py."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu_torch.contrib import amp as tamp

F32 = dict(rtol=1e-5, atol=1e-6)
SIDES = ("jax", "torch")
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "adam": {"learning_rate": 0.01, "wd": 1e-3},
    "adamw": {"learning_rate": 0.01, "wd": 0.1},
}


def _mx(side):
    return jmx if side == "jax" else tmx


def _ctx(side):
    return jmx.cpu() if side == "jax" else tmx.cpu()


def _batches(k=3, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [(rs.randn(n, 5).astype(np.float32),
             rs.randn(n, 3).astype(np.float32)) for _ in range(k)]


def _weights(seed=0):
    rs = np.random.RandomState(100 + seed)
    return {"0.weight": rs.randn(8, 5).astype(np.float32) * 0.3,
            "0.bias": rs.randn(8).astype(np.float32) * 0.1,
            "1.weight": rs.randn(3, 8).astype(np.float32) * 0.3,
            "1.bias": rs.randn(3).astype(np.float32) * 0.1}


def _net(side, weights, dtype=None, grad_req=None):
    mx = _mx(side)
    with _ctx(side):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(8, activation="tanh", in_units=5),
                mx.gluon.nn.Dense(3, in_units=8))
        if grad_req is not None:
            # before initialize: the JAX Parameter applies its grad_req to
            # the gradient it makes there
            net.collect_params().setattr("grad_req", grad_req)
        net.initialize()
        for name, p in net._collect_params_with_prefix().items():
            p.set_data(mx.nd.array(weights[name]))
        if dtype is not None:
            net.cast(dtype)
    return net


def _params(net):
    return {k: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net._collect_params_with_prefix().items()}


def _step(side, net, trainer, x, y, loss_fn, batch=None):
    mx = _mx(side)
    with _ctx(side):
        xa, ya = mx.nd.array(x), mx.nd.array(y)
        if net.collect_params()[list(net.collect_params())[0]].dtype == \
                "bfloat16":
            xa = xa.astype("bfloat16")
            ya = ya.astype("bfloat16")
        with mx.autograd.record():
            loss = loss_fn(net(xa), ya)
        loss.backward()
        trainer.step(batch or x.shape[0])
    return np.asarray(loss.asnumpy(), np.float32)


def _train(side, opt, params, steps=3, dtype=None, weights=None):
    mx = _mx(side)
    net = _net(side, weights or _weights(), dtype)
    trainer = mx.gluon.Trainer(net.collect_params(), opt, dict(params))
    loss_fn = mx.gluon.loss.L2Loss()
    losses = [_step(side, net, trainer, x, y, loss_fn)
              for x, y in _batches(steps)]
    return net, trainer, losses


def _close(a, b, **tol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], err_msg=k, **(tol or F32))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_three_steps_match_jax(opt):
    jnet, jtr, jl = _train("jax", opt, OPTIMIZERS[opt])
    tnet, ttr, tl = _train("torch", opt, OPTIMIZERS[opt])
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **F32)
    _close(_params(tnet), _params(jnet))
    assert ttr.optimizer.num_update == jtr.optimizer.num_update == 3
    assert ttr.optimizer._index_update_count == \
        jtr.optimizer._index_update_count


def _bf16_exact(weights):
    """Weights that bfloat16 holds exactly, so the f32 master from the
    pre-cast values (the port) equals the one from the cast (JAX)."""
    return {k: torch.from_numpy(v).bfloat16().float().numpy()
            for k, v in weights.items()}


def _state_arrays(state):
    if isinstance(state, dict):
        return {k: _state_arrays(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return [_state_arrays(v) for v in state]
    return np.asarray(state.detach().cpu().numpy() if torch.is_tensor(state)
                      else np.asarray(state), np.float32)


def test_multi_precision_adam_matches_jax():
    """Adam over bf16 weights with f32 masters: the states are
    {"master", "base": (mean, var)} in both packages and agree; the bf16
    weights are the masters rounded."""
    w = _bf16_exact(_weights(1))
    params = {"learning_rate": 0.01, "multi_precision": True}
    jnet, jtr, _ = _train("jax", "adam", params, dtype="bfloat16", weights=w)
    tnet, ttr, _ = _train("torch", "adam", params, dtype="bfloat16",
                          weights=w)
    assert len(ttr._states) == len(jtr._states) == 4
    # the forward and backward are bf16 in both (different summation
    # orders); Adam's normalised step makes the masters close to lr's ulp
    tol = dict(rtol=2e-3, atol=2e-4)
    for ts, js in zip(ttr._states, jtr._states):
        assert set(ts) == set(js) == {"master", "base"}
        np.testing.assert_allclose(_state_arrays(ts["master"]),
                                   _state_arrays(js["master"]), **tol)
        for a, b in zip(_state_arrays(ts["base"]), _state_arrays(js["base"])):
            np.testing.assert_allclose(a, b, rtol=5e-2, atol=1e-4)
    for p, st in zip(ttr._params, ttr._states):
        assert p.tensor().dtype == torch.bfloat16
        assert torch.equal(p.tensor().detach(), st["master"].bfloat16())
    # the bf16 weights: the masters rounded, so one bf16 ulp apart at most
    _close(_params(tnet), _params(jnet), rtol=2 ** -7, atol=1e-4)


def test_multi_precision_master_comes_from_the_precast_weights():
    """cast() keeps the f32 values and the Trainer's master takes them
    (where the weights were not bf16-exact, the master is not the bf16
    weight widened)."""
    w = _weights(2)
    with tmx.cpu():
        net = _net("torch", w, dtype="bfloat16")
        tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                               {"multi_precision": True})
        tr._ensure_states()
    for name, p in net._collect_params_with_prefix().items():
        st = tr._states[tr._params.index(p)]
        np.testing.assert_array_equal(st["master"].numpy(), w[name])


def test_grad_req_add_matches_jax():
    out = {}
    for side in SIDES:
        mx = _mx(side)
        net = _net(side, _weights(), grad_req="add")
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        loss_fn = mx.gluon.loss.L2Loss()
        with _ctx(side):
            for x, y in _batches(2):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
            grads = {k: p.grad().asnumpy().copy()
                     for k, p in net._collect_params_with_prefix().items()}
            trainer.step(8)
            net.collect_params().zero_grad()
            zeroed = [p.grad().asnumpy() for p in
                      net.collect_params().values()]
        out[side] = (grads, _params(net), zeroed)
    _close(out["torch"][0], out["jax"][0])
    _close(out["torch"][1], out["jax"][1])
    assert all(not z.any() for z in out["torch"][2])


def test_ignore_stale_grad_and_set_learning_rate_match_jax():
    """A parameter the loss does not reach is stepped as the JAX package
    steps it (its gradient is zeros there), and a learning rate set
    between steps applies from the next one."""
    out = {}
    for side in SIDES:
        mx = _mx(side)
        net = _net(side, _weights(3))
        with _ctx(side):
            extra = mx.gluon.nn.Dense(2, in_units=3, prefix="unused_")
            extra.initialize()
            extra.collect_params()["unused_weight"].set_data(
                mx.nd.array(np.full((2, 3), 0.5, np.float32)))
        params = list(net.collect_params().values()) + \
            list(extra.collect_params().values())
        trainer = mx.gluon.Trainer(params, "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.5,
                                    "wd": 0.01})
        loss_fn = mx.gluon.loss.L2Loss()
        lrs = []
        for i, (x, y) in enumerate(_batches(3, seed=4)):
            if i == 1:
                trainer.set_learning_rate(0.05)
            lrs.append(trainer.learning_rate)
            with _ctx(side):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
                loss.backward()
                trainer.step(x.shape[0], ignore_stale_grad=True)
        out[side] = (_params(net), _params(extra), lrs)
    _close(out["torch"][0], out["jax"][0])
    _close(out["torch"][1], out["jax"][1])
    assert out["torch"][2] == out["jax"][2] == [0.1, 0.05, 0.05]


@pytest.mark.parametrize("first", SIDES)
def test_save_states_cross_the_packages(tmp_path, first):
    """Train 2 steps in one package, save the weights and the Trainer's
    states, load both into the other, and take a third step in each:
    the same weights."""
    second = "torch" if first == "jax" else "jax"
    opt = {"learning_rate": 0.01, "wd": 1e-3}
    net, trainer, _ = _train(first, "adam", opt, steps=2)
    wfile, sfile = str(tmp_path / "w.params"), str(tmp_path / "s.states")
    net.save_parameters(wfile)
    trainer.save_states(sfile)
    other = _net(second, _weights())
    other.load_parameters(wfile)
    otr = _mx(second).gluon.Trainer(other.collect_params(), "adam", opt)
    otr.load_states(sfile)
    assert otr.optimizer.num_update == 2
    x, y = _batches(3)[2]
    for side, n, t in ((first, net, trainer), (second, other, otr)):
        _step(side, n, t, x, y, _mx(side).gluon.loss.L2Loss())
    _close(_params(other), _params(net))


@pytest.fixture
def fp16_amp():
    jamp.init("float16")
    tamp.init("float16")
    try:
        yield
    finally:
        jamp._reset()
        tamp._reset()


def test_float16_loss_scaler_skips_an_overflowed_step(fp16_amp):
    """Under amp.init("float16") a step whose scaled gradients overflow is
    skipped (weights unchanged) and the loss scale halves; the next finite
    step applies. Both packages."""
    out = {}
    for side in SIDES:
        mx = _mx(side)
        amp = jamp if side == "jax" else tamp
        net = _net(side, _weights(5))
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        amp.init_trainer(trainer)
        loss_fn = mx.gluon.loss.L2Loss()
        before = _params(net)
        scales, snaps = [], []
        for big in (1e38, 1.0):
            x, y = _batches(1, seed=6)[0]
            with _ctx(side):
                with mx.autograd.record():
                    loss = loss_fn(net(mx.nd.array(x)),
                                   mx.nd.array(y * big))
                    with amp.scale_loss(loss, trainer) as scaled:
                        scaled.backward()
                trainer.step(x.shape[0])
            scales.append(trainer._amp_loss_scaler.loss_scale)
            snaps.append(_params(net))
        out[side] = (before, snaps, scales)
    for side in SIDES:
        before, snaps, scales = out[side]
        _close(snaps[0], before)
        assert scales == [2.0 ** 15, 2.0 ** 15]
        assert any(not np.array_equal(snaps[1][k], before[k])
                   for k in before)
    _close(out["torch"][1][1], out["jax"][1][1], rtol=1e-4, atol=1e-6)


def test_trainer_sgd_step_converges_linreg():
    """tests/test_gluon.py's linear regression, on the port."""
    w_true = np.array([[2.0, -3.4]], np.float32)
    b_true = 4.2
    X = np.random.RandomState(0).rand(256, 2).astype(np.float32)
    Y = X @ w_true.T + b_true
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(1)
        net.initialize()
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        loss_fn = tmx.gluon.loss.L2Loss()
        for _ in range(300):
            with tmx.autograd.record():
                loss = loss_fn(net(tmx.nd.array(X)), tmx.nd.array(Y))
            loss.backward()
            trainer.step(256)
    params = {k.split("_")[-1]: p.data().asnumpy()
              for k, p in net.collect_params().items()}
    np.testing.assert_allclose(params["weight"], w_true, atol=0.1)
    np.testing.assert_allclose(params["bias"], [b_true], atol=0.1)


def test_trainer_refuses_a_distributed_kvstore():
    with tmx.cpu():
        d = tmx.gluon.nn.Dense(2, in_units=2)
        d.initialize()
    with pytest.raises(tmx.MXNetError, match="one device"):
        tmx.gluon.Trainer(d.collect_params(), "sgd", kvstore="dist_sync")
    tr = tmx.gluon.Trainer(d.collect_params(), "sgd", kvstore="device")
    tr.allreduce_grads()

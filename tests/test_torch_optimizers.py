"""The port's update ops (mxnet_tpu_torch/ops/optimizer_ops.py) and
optimizers (AdaGrad, RMSProp, FTRL, SignSGD, LAMB beside SGD, NAG, Adam and
AdamW; ``Updater``) against the JAX package's on the same seeded numpy
inputs:

- every registered update op, three chained steps (each step's states fed
  to the next), every output at f32 1e-5 relative; ``nd`` with ``out=``
  writes the new weights into ``out`` and the states into their arguments;
- each optimizer through the imperative protocol (``update``), three steps
  with weight decay, ``rescale_grad`` and ``clip_gradient`` (1e-5); the
  centered RMSProp against JAX's ``rmspropalex_update`` op, since the JAX
  optimizer ignores ``centered``;
- ``Updater`` states through ``get_states``/``set_states`` (the optimizer
  too with ``dump_optimizer``), bit for bit;
- ``TrainStep`` (naive) against the JAX ``TrainStep`` for AdaGrad,
  RMSProp, FTRL, SignSGD and LAMB on tests/test_torch_train_loop.py's MLP,
  three steps (that file's 2e-5); ``TrainStep.run(window=)`` equal to
  calls, and the bf16 ``cast`` route through f32 masters equal to the
  Gluon ``Trainer`` with ``multi_precision``, bit for bit."""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import registry as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.parallel import TrainStep
from test_torch_train_loop import (_batches, _jstep, _loss, _mlp, _trainer)

F32 = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=2e-5, atol=1e-6)  # tests/test_torch_train_loop.py's
SHAPE = (4, 5)


def _a(seed, positive=False):
    a = np.random.RandomState(seed).randn(*SHAPE).astype(np.float32)
    return np.abs(a) + 0.1 if positive else a


W, G, M, V = _a(1), _a(2), _a(3), _a(4, positive=True)
W32 = _a(5)

# name -> (inputs, params, for each output the position of the input it
# replaces at the next step (None: none))
OPS = {
    "sgd_update": ([W, G], dict(lr=0.1, wd=0.01, clip_gradient=0.5), [0]),
    "sgd_mom_update": ([W, G, M], dict(lr=0.1, momentum=0.9, wd=0.01,
                                       rescale_grad=0.5), [0, 2]),
    "nag_mom_update": ([W, G, M], dict(lr=0.1, momentum=0.9, wd=0.01), [0, 2]),
    "adam_update": ([W, G, M, V], dict(lr=0.01, wd=0.01, clip_gradient=1.0),
                    [0, 2, 3]),
    "rmsprop_update": ([W, G, V], dict(lr=0.01, gamma1=0.9, wd=0.01,
                                       clip_weights=0.8), [0, 2]),
    "rmspropalex_update": ([W, G, V, 0.1 * M, 0.1 * M],
                           dict(lr=0.01, wd=0.01, clip_weights=1.5),
                           [0, 2, 3, 4]),
    "ftml_update": ([W, G, V, V, M], dict(lr=0.1, t=2, wd=0.01), [0, 2, 3, 4]),
    "adagrad_update": ([W, G, V], dict(lr=0.1, wd=0.01, clip_gradient=1.0),
                       [0, 2]),
    "ftrl_update": ([W, G, M, V], dict(lr=0.1, lamda1=0.05, wd=0.01),
                    [0, 2, 3]),
    "signsgd_update": ([W, G], dict(lr=0.1, wd=0.01), [0]),
    "signum_update": ([W, G, M], dict(lr=0.1, wd=0.01, wd_lh=0.001), [0, 2]),
    "lamb_update_phase1": ([W, G, M, V], dict(t=3, wd=0.01,
                                              clip_gradient=1.0),
                           [None, 2, 3]),
    "lamb_update_phase2": ([W, G, np.float32(2.0), np.float32(0.5)],
                           dict(lr=0.1, lower_bound=0.1, upper_bound=1.5),
                           [0]),
    "mp_sgd_update": ([W, G, W32], dict(lr=0.1, wd=0.01), [0, 2]),
    "mp_sgd_mom_update": ([W, G, M, W32], dict(lr=0.1, momentum=0.9),
                          [0, 2, 3]),
    "mp_nag_mom_update": ([W, G, M, W32], dict(lr=0.1, momentum=0.9),
                          [0, 2, 3]),
    "multi_sgd_update": ([W, G, W32, M], dict(lrs=[0.1, 0.2], wds=[0.0, 0.01],
                                              num_weights=2), [0, 2]),
    "multi_sgd_mom_update": ([W, G, M, W32, V, M],
                             dict(lrs=[0.1, 0.2], wds=0.01, momentum=0.9,
                                  num_weights=2), [0, 2, 3, 5]),
    "multi_mp_sgd_update": ([W, G, W32, W32, V, W], dict(lrs=0.1, wds=0.01),
                            [0, 2, 3, 5]),
    "multi_mp_sgd_mom_update": ([W, G, M, W32], dict(lrs=[0.1], wds=[0.01],
                                                     momentum=0.5,
                                                     num_weights=1),
                                [0, 2, 3]),
}


def _outs(res):
    return list(res) if isinstance(res, (tuple, list)) else [res]


def test_every_update_op_of_jax_is_registered_with_its_nout():
    names = [n for n, op in jreg._REGISTRY.items()
             if op.fn.__module__ == "mxnet_tpu.ops.optimizer_ops"]
    assert sorted(names) == sorted(OPS)
    for n in names:
        assert treg.get(n).nout == jreg.get(n).nout, n


@pytest.mark.parametrize("name", sorted(OPS))
def test_update_op_matches_jax_over_three_steps(name):
    arrays, params, feed = OPS[name]
    jin, tin = list(arrays), list(arrays)
    for _ in range(3):
        jout = _outs(getattr(jnd, name)(*[jnd.array(a) for a in jin],
                                        **params))
        with tmx.cpu():
            tout = _outs(getattr(tnd, name)(*[tnd.array(a) for a in tin],
                                            **params))
        assert len(tout) == len(jout)
        jout = [o.asnumpy() for o in jout]
        tout = [o.asnumpy() for o in tout]
        for t, j in zip(tout, jout):
            assert t.shape == j.shape and t.dtype == j.dtype, name
            np.testing.assert_allclose(t, j, err_msg=name, **F32)
        for k, pos in enumerate(feed):
            if pos is not None:
                jin[pos], tin[pos] = jout[k], tout[k]


def test_out_writes_weights_and_states_in_place():
    with tmx.cpu():
        w, g, m = tnd.array(W), tnd.array(G), tnd.array(M)
        want = tnd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9)
        handle = w._data
        got = tnd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, out=w)
        assert got is w and w._data is handle
        np.testing.assert_array_equal(w.asnumpy(), want[0].asnumpy())
        np.testing.assert_array_equal(m.asnumpy(), want[1].asnumpy())
        # multi-tensor: out= the list of weights, the moments in place
        ws = [tnd.array(W), tnd.array(W32)]
        ms = [tnd.array(M), tnd.array(V)]
        ref = tnd.multi_sgd_mom_update(ws[0], tnd.array(G), ms[0], ws[1],
                                       tnd.array(G), ms[1], lrs=[0.1, 0.2],
                                       wds=0.0, momentum=0.9)
        tnd.multi_sgd_mom_update(ws[0], tnd.array(G), ms[0], ws[1],
                                 tnd.array(G), ms[1], lrs=[0.1, 0.2],
                                 wds=0.0, momentum=0.9, out=ws)
        for got_, want_ in zip((ws[0], ms[0], ws[1], ms[1]), ref):
            np.testing.assert_array_equal(got_.asnumpy(), want_.asnumpy())
        # LAMB's first phase: out= the update; the moments in place
        upd = tnd.zeros(SHAPE)
        mean, var = tnd.array(M), tnd.array(V)
        ref = tnd.lamb_update_phase1(tnd.array(W), tnd.array(G), mean, var,
                                     t=1)
        tnd.lamb_update_phase1(tnd.array(W), tnd.array(G), mean, var, t=1,
                               out=upd)
        for got_, want_ in zip((upd, mean, var), ref):
            np.testing.assert_array_equal(got_.asnumpy(), want_.asnumpy())


OPTIMIZERS = [
    ("sgd", dict(momentum=0.9)), ("nag", dict(momentum=0.9)), ("adam", {}),
    ("adamw", {}), ("adagrad", dict(eps=1e-6)),
    ("rmsprop", dict(gamma1=0.95, clip_weights=0.9)),
    ("ftrl", dict(lamda1=0.02, beta=0.5)), ("signsgd", {}),
    ("lamb", dict(lower_bound=0.05, upper_bound=5.0)),
    ("lamb", dict(bias_correction=False)),
]


def _imperative(mx, name, kw, steps=3):
    opt = mx.optimizer.create(name, learning_rate=0.05, wd=0.01,
                              rescale_grad=0.5, clip_gradient=2.0, **kw)
    w = mx.nd.array(W)
    state = opt.create_state(0, w._data if mx is tmx else w)
    for i in range(steps):
        state = opt.update(0, w, mx.nd.array(_a(10 + i)), state)
    return w.asnumpy()


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{k}" for n, k in OPTIMIZERS])
def test_optimizer_matches_jax_over_three_steps(name, kw):
    want = _imperative(jmx, name, kw)
    with tmx.cpu():
        got = _imperative(tmx, name, kw)
    np.testing.assert_allclose(got, want, **F32)


def test_centered_rmsprop_is_rmspropalex():
    """``RMSProp(centered=True)`` runs ``rmspropalex_update`` with its
    states (n, g, delta), as MXNet's; the JAX optimizer ignores
    ``centered``, so it is held against the JAX op."""
    opt = topt.RMSProp(learning_rate=0.05, gamma1=0.9, gamma2=0.8,
                       centered=True, wd=0.01)
    jin = [W, None, np.zeros(SHAPE, np.float32), np.zeros(SHAPE, np.float32),
           np.zeros(SHAPE, np.float32)]
    with tmx.cpu():
        w = tnd.array(W)
        state = opt.create_state(0, w._data)
        assert len(state) == 3
        for i in range(3):
            g = _a(10 + i)
            state = opt.update(0, w, tnd.array(g), state)
            jin[1] = g
            out = jnd.rmspropalex_update(*[jnd.array(a) for a in jin],
                                         lr=0.05, gamma1=0.9, gamma2=0.8,
                                         wd=0.01)
            jin = [out[0].asnumpy(), None] + [o.asnumpy() for o in out[1:]]
    np.testing.assert_allclose(w.asnumpy(), jin[0], **F32)
    for s, j in zip(state, jin[2:]):
        np.testing.assert_allclose(s.numpy(), j, **F32)


@pytest.mark.parametrize("dump", [False, True])
def test_updater_states_round_trip(dump):
    def run(updater, w, seeds):
        for s in seeds:
            updater(0, tnd.array(_a(s)), w)

    with tmx.cpu():
        u = topt.get_updater(topt.LAMB(learning_rate=0.05))
        w = tnd.array(W)
        run(u, w, (20, 21))
        blob = u.get_states(dump_optimizer=dump)
        other = topt.Updater(topt.LAMB(learning_rate=0.05) if not dump
                             else topt.SGD())
        other.set_states(blob)
        if dump:  # the optimizer came back with its update counts
            assert isinstance(other.optimizer, topt.LAMB)
        else:  # the states alone: LAMB's t comes from the counts
            other.optimizer._index_update_count = dict(
                u.optimizer._index_update_count)
        assert other.optimizer._index_update_count == \
            u.optimizer._index_update_count
        w2 = tnd.array(w.asnumpy())
        run(u, w, (22,))
        run(other, w2, (22,))
    np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())
    for a, b in zip(pickle.loads(u.get_states())[0],
                    pickle.loads(other.get_states())[0]):
        assert torch.equal(a, b)


def test_updater_keeps_an_f32_master_for_a_bf16_weight():
    with tmx.cpu():
        u = topt.Updater(topt.AdaGrad(learning_rate=0.1,
                                      multi_precision=True))
        w = tnd.array(W).astype("bfloat16")
        u(0, tnd.array(G).astype("bfloat16"), w)
    st = u.states[0]
    assert st["master"].dtype == torch.float32
    assert torch.equal(w._data, st["master"].to(torch.bfloat16))


TS_OPTS = [("AdaGrad", dict(learning_rate=0.05)),
           ("RMSProp", dict(learning_rate=0.01)),
           ("FTRL", dict(learning_rate=0.1, lamda1=0.001)),
           ("SignSGD", dict(learning_rate=0.01)),
           ("LAMB", dict(learning_rate=0.01, wd=0.01))]


@pytest.mark.parametrize("name,kw", TS_OPTS, ids=[n for n, _ in TS_OPTS])
def test_train_step_matches_jax(name, kw):
    data = _batches(3)
    ts = TrainStep(_mlp(), _loss, getattr(topt, name)(**kw), amp=None,
                   engine_type="naive")
    jts = _jstep(getattr(jopt, name)(**kw))
    losses = [float(ts(x, y)) for x, y in data]
    jlosses = [float(np.asarray(jts(jnd.array(x), jnd.array(y))))
               for x, y in data]
    np.testing.assert_allclose(losses, jlosses, **TOL)
    jts.sync()
    jparams = {k: p.data().asnumpy()
               for k, p in jts.net._collect_params_with_prefix().items()}
    for k, p in ts.net._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(), jparams[k], err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("name,kw", TS_OPTS, ids=[n for n, _ in TS_OPTS])
def test_window_equals_calls(name, kw):
    data = _batches(4)
    a = TrainStep(_mlp(), _loss, getattr(topt, name)(**kw), amp=None)
    b = TrainStep(_mlp(), _loss, getattr(topt, name)(**kw), amp=None)
    la = torch.stack([a(x, y) for x, y in data])
    lb = b.run(iter(data), steps=4, window=2)
    assert torch.equal(la, lb)
    for (_, p), (_, q) in zip(a._plist, b._plist):
        assert torch.equal(p, q)


def _mp_run(route, name, kw, data):
    """The bf16 net through f32 masters: ``TrainStep`` on the ``cast``
    net, or the imperative ``Trainer`` with ``multi_precision``. Returns
    the losses, the masters and the bf16 weights, by parameter name."""
    net = _mlp(dtype="bfloat16", exact=True)
    bf = [tuple(torch.from_numpy(a).bfloat16() for a in b) for b in data]
    if route == "train_step":
        ts = TrainStep(net, _loss, getattr(topt, name)(**kw), amp=None)
        losses = [float(ts(x, y)) for x, y in bf]
        masters = {ts._ckpt_names[n]: m for n, m in ts._master.items()}
    else:
        trainer = _trainer("torch", net, name.lower(),
                           dict(kw, multi_precision=True))
        losses = []
        for x, y in bf:
            with tmx.cpu():
                with tmx.autograd.record():
                    loss = _loss(net(tnd.array(x)), tnd.array(y))
                loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
        masters = {p.name: st["master"]
                   for p, st in zip(trainer._params, trainer._states)}
    weights = {p.name: p.data()._data
               for p in net.collect_params().values()}
    return losses, masters, weights


@pytest.mark.parametrize("name,kw", TS_OPTS, ids=[n for n, _ in TS_OPTS])
def test_cast_route_equals_multi_precision_trainer(name, kw):
    data = _batches(3)
    la, ma, wa = _mp_run("train_step", name, kw, data)
    lb, mb, wb = _mp_run("trainer", name, kw, data)
    assert la == lb
    assert sorted(ma) == sorted(mb) == sorted(wa)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
        assert wa[k].dtype == torch.bfloat16 and torch.equal(wa[k], wb[k]), k

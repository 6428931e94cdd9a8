"""The port's learning-rate schedules (mxnet_tpu_torch.lr_scheduler), its
SGD, NAG and AdamW, and a TrainStep under a schedule, against the JAX
package on the same numpy inputs. The schedules are compared bit for bit:
both evaluate in f32. The updates at rtol 1e-6 / atol 1e-7 (one update,
tests/test_pallas_optimizer.py's tolerance), the 3-step TrainStep as
tests/test_torch_train_step.py holds it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.parallel import TrainStep

ONE = dict(rtol=1e-6, atol=1e-7)

SCHEDULES = [
    ("FactorScheduler", dict(step=3, factor=0.7, base_lr=0.013,
                             warmup_steps=4, warmup_begin_lr=0.001)),
    ("FactorScheduler", dict(step=2, factor=0.1, stop_factor_lr=1e-4)),
    ("MultiFactorScheduler", dict(step=[2, 5, 9], factor=0.3, base_lr=0.017,
                                  warmup_steps=2)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.011, pwr=3,
                           final_lr=1e-4, warmup_steps=3,
                           warmup_begin_lr=1e-3)),
    ("PolyScheduler", dict(max_update=20, base_lr=0.011, pwr=1.5)),
    ("CosineScheduler", dict(max_update=17, base_lr=3e-4, final_lr=1e-5,
                             warmup_steps=5)),
    ("CosineScheduler", dict(max_update=17, base_lr=3e-4, warmup_steps=5,
                             warmup_mode="constant", warmup_begin_lr=1e-4)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(SCHEDULES)])
def test_schedule_equals_jax_bit_for_bit(name, kw):
    j, t = getattr(jls, name)(**kw), getattr(tls, name)(**kw)
    want = np.asarray([float(j(n)) for n in range(30)], np.float32)
    got = np.asarray([t(n) for n in range(30)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_optimizer_learning_rate_follows_the_schedule():
    """Optimizer(lr_scheduler=) makes learning_rate the schedule at
    num_update, with learning_rate as its base_lr; set_learning_rate moves
    the base, as in the JAX optimizer."""
    kw = dict(max_update=10, warmup_steps=2)
    jo = jopt.Adam(learning_rate=0.5, lr_scheduler=jls.CosineScheduler(**kw))
    to = topt.Adam(learning_rate=0.5, lr_scheduler=tls.CosineScheduler(**kw))
    for n in range(12):
        jo.num_update = to.num_update = n
        assert to.learning_rate == jo.learning_rate
    jo.set_learning_rate(0.25)
    to.set_learning_rate(0.25)
    assert to.lr_scheduler.base_lr == 0.25 == jo.lr_scheduler.base_lr
    assert to.learning_rate == jo.learning_rate


def _mk(rs, shape):
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32),
            (rs.randn(*shape) * 0.1).astype(np.float32),
            (np.abs(rs.randn(*shape)) * 0.01).astype(np.float32))


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict()), ("SGD", dict(momentum=0.9)),
    ("NAG", dict()), ("NAG", dict(momentum=0.9)),
    ("AdamW", dict()),
], ids=["sgd", "sgd_momentum", "nag", "nag_momentum", "adamw"])
def test_update_raw_matches_jax(name, kw):
    """Three in-place updates with rescale, clip and wd, state included."""
    rs = np.random.RandomState(0)
    w, g, m, v = _mk(rs, (17, 9))
    hyper = dict(learning_rate=0.01, wd=0.02, rescale_grad=0.5,
                 clip_gradient=1.0, **kw)
    jo, to = getattr(jopt, name)(**hyper), getattr(topt, name)(**hyper)
    js = jo.create_state(0, jnp.asarray(w))
    tw = torch.from_numpy(w.copy())
    ts = to.create_state(0, tw)
    if name == "AdamW":
        js, ts = (jnp.asarray(m), jnp.asarray(v)), (torch.from_numpy(m.copy()),
                                                     torch.from_numpy(v.copy()))
    elif kw:
        js, ts = jnp.asarray(m), torch.from_numpy(m.copy())
    else:
        assert js is None and ts is None
    jw = jnp.asarray(w)
    for t in (1, 2, 3):
        jw, js = jo.update_raw(jw, jnp.asarray(g * t), js, jnp.float32(0.01),
                               jnp.float32(0.02), jnp.int32(t))
        out, ts = to.update_raw(tw, torch.from_numpy(g * t), ts,
                                torch.tensor(0.01), torch.tensor(0.02),
                                torch.tensor(t, dtype=torch.int32))
        assert out is tw
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **ONE)
    for a, b in zip(jax_leaves(js), jax_leaves(ts)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **ONE)


def jax_leaves(state):
    if state is None:
        return []
    return list(state) if isinstance(state, tuple) else [state]


def test_update_raw_multi_loops_for_the_plain_optimizers():
    rs = np.random.RandomState(1)
    data = [_mk(rs, s) for s in ((5, 4), (11,))]
    opt = topt.create("sgd", learning_rate=0.1, momentum=0.5)
    ws = [torch.from_numpy(d[0].copy()) for d in data]
    st = [opt.create_state(i, w) for i, w in enumerate(ws)]
    lows = [torch.empty(5, 4, dtype=torch.bfloat16), None]
    opt.update_raw_multi(ws, [torch.from_numpy(d[1]) for d in data], st,
                         torch.tensor([0.1, 0.2]), torch.tensor([0.0, 0.1]),
                         torch.tensor(1, dtype=torch.int32), out_lows=lows)
    for d, w, s, lr, wd in zip(data, ws, st, (0.1, 0.2), (0.0, 0.1)):
        rw, rm = jopt.SGD(momentum=0.5).update_raw(
            jnp.asarray(d[0]), jnp.asarray(d[1]), jnp.zeros_like(d[0]),
            jnp.float32(lr), jnp.float32(wd), jnp.int32(1))
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), **ONE)
        np.testing.assert_allclose(s.numpy(), np.asarray(rm), **ONE)
    assert torch.equal(lows[0], ws[0].to(torch.bfloat16))
    assert {"sgd", "nag", "adam", "adamw"} <= set(topt._OPT_REGISTRY)


VOCAB = 97
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)


@pytest.mark.parametrize("opt_name", ["Adam", "SGD"])
def test_three_steps_under_a_schedule_match_jax(opt_name):
    """A warm-up cosine schedule over 3 TrainStep steps (the rate changes
    every step and reaches the card without a host sync): losses to 1e-5
    relative and the masters within the f32 test's Adam bound."""
    kw = dict(max_update=10, warmup_steps=2, warmup_begin_lr=1e-4)
    opt_kw = dict(learning_rate=1e-3) if opt_name == "Adam" else \
        dict(learning_rate=0.1, momentum=0.9)
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    init = {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 24)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    jts = JTrainStep(jnet, jgpt2.lm_loss, getattr(jopt, opt_name)(
        lr_scheduler=jls.CosineScheduler(**kw), **opt_kw), mesh=None, amp=None)
    jl = [float(np.asarray(jts(nd.array(ids, dtype="int32"),
                               nd.array(labels, dtype="int32"))))
          for _ in range(3)]
    jts.sync()
    jfinal = {k: np.asarray(p.data().asnumpy())
              for k, p in jnet._collect_params_with_prefix().items()}
    net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=5)
    tser.load_mxnet_params(net, init)
    ts = TrainStep(net, tgpt2.lm_loss, getattr(topt, opt_name)(
        lr_scheduler=tls.CosineScheduler(**kw), **opt_kw), amp=None)
    tl = [float(ts(ids, labels)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert ts.optimizer.num_update == 3
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    bound = 2 * 1e-3 * 3 if opt_name == "Adam" else 1e-4
    assert err.max() <= bound

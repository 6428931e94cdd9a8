"""The port's mixed precision (mxnet_tpu_torch.contrib.amp and
TrainStep(amp=...)) against the JAX package: the policy surface, 3 bf16
steps of a 2-layer GPT-2 trained through SoftmaxCrossEntropyLoss against
the JAX TrainStep with its fused dispatch forced (same weights through
load_mxnet_params), float16 dynamic loss scaling with an overflowed step,
and amp="auto" after amp.init. Tolerance rtol 2e-2 / atol 1e-3, that of
tests/test_amp_policy.py for a bf16 trajectory."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.ops import pallas_softmax_xent as px
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.contrib import amp
from mxnet_tpu_torch.contrib.amp import Policy, resolve_policy
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.ops import nn as tops
from mxnet_tpu_torch.parallel import TrainStep

AMP_TOL = dict(rtol=2e-2, atol=1e-3)
VOCAB = 97
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)
LR, STEPS = 1e-3, 3
KNOBS = ("flash_attention", "flash_pallas_bwd", "fused_adam",
         "fused_layernorm", "fused_softmax_xent")


# -- policy surface ----------------------------------------------------------
def test_init_and_reset_idempotent():
    try:
        amp.init("bfloat16")
        assert amp.amp_dtype() == "bfloat16"
        assert amp.compute_dtype() is torch.bfloat16
        amp.init("bfloat16")
        amp.init("float16")
        assert amp.compute_dtype() is torch.float16
        with pytest.raises(ValueError):
            amp.init("float64")
    finally:
        amp._reset()
    assert amp.amp_dtype() is None and amp.compute_dtype() is None
    amp._reset()
    assert amp.amp_dtype() is None


def test_resolve_policy_mapping():
    assert resolve_policy(None) is None and resolve_policy(False) is None
    assert resolve_policy("bfloat16") == Policy("bfloat16")
    p = Policy("float16", loss_scale=128.0)
    assert resolve_policy(p) is p
    assert p.dynamic_scaling and not Policy("bfloat16").dynamic_scaling
    assert p.torch_compute_dtype is torch.float16
    assert resolve_policy("auto") is None
    try:
        amp.init("bfloat16")
        assert resolve_policy("auto") == Policy("bfloat16")
    finally:
        amp._reset()
    with pytest.raises(ValueError):
        Policy("float64")
    with pytest.raises(TypeError):
        resolve_policy(3.14)
    # the fields and defaults of the JAX Policy
    assert Policy() == Policy("bfloat16", 2.0 ** 16, 2.0, 2000)
    assert jamp.Policy().__dict__ == Policy().__dict__


def test_op_lists_match_jax():
    assert amp.list_lp16_ops() == jamp.list_lp16_ops()
    assert amp.list_fp16_ops() == jamp.list_fp16_ops()
    assert amp.list_fp32_ops() == jamp.list_fp32_ops()
    assert amp.list_widest_type_cast_ops() == jamp.list_widest_type_cast_ops()


def test_dense_computes_in_the_init_dtype():
    """Under amp.init an f32 dense input is multiplied in bf16 with an f32
    result, as the JAX fully_connected's preferred_element_type=f32; without
    it, in f32."""
    rs = np.random.RandomState(0)
    x, w, b = (rs.randn(*s).astype(np.float32) for s in ((5, 33), (7, 33), (7,)))
    plain = tops.fully_connected(*map(torch.from_numpy, (x, w, b)))
    try:
        jamp.init("bfloat16")
        amp.init("bfloat16")
        ref = jops.fully_connected(*(nd.array(a)._data for a in (x, w, b)))
        got = tops.fully_connected(*map(torch.from_numpy, (x, w, b)))
    finally:
        jamp._reset()
        amp._reset()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, plain, rtol=1e-5, atol=1e-5)


# -- bf16 training against the JAX TrainStep ---------------------------------
def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (2, 24)).astype(np.int32)
    return ids, np.roll(ids, -1, 1)


@pytest.fixture(scope="module")
def jax_bf16_run():
    """Initial weights and, after STEPS bf16 steps of the JAX TrainStep with
    SoftmaxCrossEntropyLoss on its fused dispatch, the losses and the
    final (f32 master) weights."""
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))

    def params():
        return {k: np.asarray(p.data().asnumpy())
                for k, p in jnet._collect_params_with_prefix().items()}

    init = params()
    ids, labels = _batch()
    mp = pytest.MonkeyPatch()
    mp.setattr(px, "xent_kernel_supported", lambda *a, **k: True)
    try:
        ts = JTrainStep(jnet, jloss.SoftmaxCrossEntropyLoss(),
                        jopt.Adam(learning_rate=LR), mesh=None,
                        amp="bfloat16")
        losses = [float(np.asarray(ts(nd.array(ids, dtype="int32"),
                                      nd.array(labels, dtype="int32"))))
                  for _ in range(STEPS)]
    finally:
        mp.undo()
    ts.sync()
    return init, losses, params()


@pytest.mark.parametrize("knobs", [True, False], ids=["kernels", "plain"])
def test_bf16_three_steps_match_jax(jax_bf16_run, knobs):
    """Losses within the bf16 trajectory tolerance; the masters stay f32
    and within Adam's sign-flip bound (2 · lr · steps) of the JAX masters,
    and 99% of them within the bf16 tolerance."""
    init, jlosses, jfinal = jax_bf16_run
    old = {k: tconfig.get(k) for k in KNOBS}
    try:
        for k in KNOBS:
            tconfig.set(k, knobs)
        net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=5)
        tser.load_mxnet_params(net, init)
        ts = TrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                       topt.Adam(learning_rate=LR), amp="bfloat16")
        ids, labels = _batch()
        losses = [ts(ids, labels) for _ in range(STEPS)]
    finally:
        for k, v in old.items():
            tconfig.set(k, v)
    for got in losses:
        assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose([float(x) for x in losses], jlosses, **AMP_TOL)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(c.dtype == torch.bfloat16 for c in ts._low.values())
    # the copies are the rounding of the updated masters
    for name, p in net.named_parameters():
        assert torch.equal(ts._low[name], p.detach().to(torch.bfloat16)), name
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    assert err.max() <= 2 * LR * STEPS
    bad = np.concatenate([(np.abs(final[k] - jfinal[k])
                           > AMP_TOL["atol"] + AMP_TOL["rtol"] * np.abs(jfinal[k])
                           ).ravel() for k in jfinal])
    assert bad.mean() <= 1e-2
    assert int(ts.step_count) == STEPS


@pytest.mark.parametrize("how", ["load_mxnet_params", "data_then_refresh"])
def test_bf16_masters_loaded_after_the_step_is_built_match_jax(
        jax_bf16_run, how):
    """Weights loaded into the net after the TrainStep cast its copies reach
    the forward: the step casts the changed masters again by itself
    (load_mxnet_params writes them in place), or on refresh_copies() after
    a write through ``p.data``. The losses then follow the JAX run from
    those weights."""
    init, jlosses, _ = jax_bf16_run
    net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=5)
    ts = TrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                   topt.Adam(learning_rate=LR), amp="bfloat16")
    if how == "load_mxnet_params":
        tser.load_mxnet_params(net, init)
    else:
        for name, p in net.named_parameters():
            p.data.copy_(torch.from_numpy(np.array(init[name])))
        ts.refresh_copies()
        for name, p in net.named_parameters():
            assert torch.equal(ts._low[name],
                               p.detach().to(torch.bfloat16)), name
    ids, labels = _batch()
    losses = [float(ts(ids, labels)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, jlosses, **AMP_TOL)
    for name, p in net.named_parameters():
        assert torch.equal(ts._low[name], p.detach().to(torch.bfloat16)), name


def test_bf16_tracks_f32_and_the_knobs_agree():
    """The bf16 policy follows the f32 trajectory of the same net within
    the bf16 tolerance, and the step reads amp.init through amp="auto"."""
    ids, labels = _batch(1)

    def run(**kw):
        net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=3)
        ts = TrainStep(net, tloss.SoftmaxCrossEntropyLoss(),
                       topt.Adam(learning_rate=LR), **kw)
        return [float(ts(ids, labels)) for _ in range(4)], ts

    l32, ts32 = run(amp=None)
    l16, ts16 = run(amp="bfloat16")
    assert ts32.amp_policy is None and not ts32._low
    np.testing.assert_allclose(l16, l32, **AMP_TOL)
    try:
        amp.init("bfloat16")
        lauto, tsauto = run()
    finally:
        amp._reset()
    assert tsauto.amp_policy == Policy("bfloat16")
    assert lauto == l16
    l_default, ts_default = run()
    assert ts_default.amp_policy is None and l_default == l32


# -- float16 dynamic loss scaling --------------------------------------------
IN, OUT = 6, 4


def _mlps(seed=0):
    """The JAX MLP of tests/test_amp_policy.py and the port's with the same
    weights (Dense, relu, Dense)."""
    mx.random.seed(seed)
    jnet = jnn.HybridSequential()
    jnet.add(jnn.Dense(16, activation="relu"), jnn.Dense(OUT))
    jnet.initialize()
    _ = jnet(nd.ones((2, IN)))
    tnet = tnn.HybridSequential()
    tnet.add(tnn.Dense(16, in_units=IN), torch.nn.ReLU(),
             tnn.Dense(OUT, in_units=16))
    jp = {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    with torch.no_grad():
        for (jname, tname) in (("0", "0"), ("1", "2")):
            for leaf in ("weight", "bias"):
                getattr(tnet[int(tname)], leaf).copy_(
                    torch.from_numpy(np.array(jp[f"{jname}.{leaf}"])))
    return jnet, tnet


def _mse(out, *labels):
    return ((out - labels[0]) ** 2).mean()


def _batches(k, seed=123, scale=1.0):
    rs = np.random.RandomState(seed)
    return [(rs.normal(size=(4, IN)).astype(np.float32) * scale,
             rs.normal(size=(4, OUT)).astype(np.float32) * scale)
            for _ in range(k)]


def _tparams(net):
    return [p.detach().clone() for _, p in sorted(net.named_parameters())]


@pytest.mark.parametrize("fused", [True, False], ids=["fused_adam", "plain_adam"])
def test_fp16_overflow_skips_update_and_halves_scale(fused):
    """An inf in the batch: params, moments and Adam's t unchanged, the
    scale halved, the skip counted; the next healthy step applies, and
    both steps agree with the JAX TrainStep."""
    jnet, tnet = _mlps()
    pol = dict(loss_scale=8.0, scale_window=1000)
    jts = JTrainStep(jnet, _mse, jopt.Adam(learning_rate=1e-2),
                     amp=jamp.Policy("float16", **pol))
    tconfig.set("fused_adam", fused)
    try:
        ts = TrainStep(tnet, _mse, topt.Adam(learning_rate=1e-2),
                       amp=Policy("float16", **pol))
        p0 = _tparams(tnet)
        state0 = [s.clone() for m in ts.opt_state.values() for s in m]
        bad = np.ones((4, IN), np.float32)
        bad[0, 0] = np.inf
        zeros = np.zeros((4, OUT), np.float32)
        loss = ts(bad, zeros)
        jloss_ = float(np.asarray(jts(nd.array(bad), nd.array(zeros))))
        assert not np.isfinite(float(loss)) and not np.isfinite(jloss_)
        assert ts.loss_scale == 4.0 == jts.loss_scale
        assert ts.amp_skipped_steps == 1 == jts.amp_skipped_steps
        assert int(ts.step_count) == 0 and ts.optimizer.num_update == 1
        for a, b in zip(p0, _tparams(tnet)):
            assert torch.equal(a, b)
        for a, b in zip(state0, [s for m in ts.opt_state.values() for s in m]):
            assert torch.equal(a, b)
        for name, p in tnet.named_parameters():
            assert torch.equal(ts._low[name], p.detach().half())
        x, y = _batches(1)[0]
        got = float(ts(x, y))
        want = float(np.asarray(jts(nd.array(x), nd.array(y))))
    finally:
        tconfig.set("fused_adam", True)
    assert int(ts.step_count) == 1 and ts.amp_skipped_steps == 1
    assert any(not torch.equal(a, b) for a, b in zip(p0, _tparams(tnet)))
    np.testing.assert_allclose(got, want, **AMP_TOL)
    jts.sync()
    jp = {k: p.data().asnumpy() for k, p in jnet._collect_params_with_prefix().items()}
    for jname, tname in (("0", "0"), ("1", "2")):
        for leaf in ("weight", "bias"):
            np.testing.assert_allclose(
                getattr(tnet[int(tname)], leaf).detach().numpy(),
                jp[f"{jname}.{leaf}"], **AMP_TOL)


def test_fp16_scale_grows_after_a_window_of_good_steps():
    _, tnet = _mlps()
    ts = TrainStep(tnet, _mse, topt.SGD(learning_rate=1e-3),
                   amp=Policy("float16", loss_scale=4.0, scale_factor=2.0,
                              scale_window=2))
    for x, y in _batches(4, scale=0.1):
        ts(x, y)
    # 4 good steps, window 2: two doublings, 4 -> 8 -> 16
    assert ts.loss_scale == 16.0 and ts.amp_skipped_steps == 0
    assert int(ts.step_count) == 4


def test_scale_properties_without_float16():
    _, tnet = _mlps()
    ts = TrainStep(tnet, _mse, topt.Adam(), amp="bfloat16")
    assert ts.loss_scale is None and ts.amp_skipped_steps == 0

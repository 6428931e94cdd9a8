"""The port's single-device TrainStep (mxnet_tpu_torch.parallel) against
the JAX package's TrainStep(mesh=None) on a 2-layer GPT-2 with the same
weights (carried through mxnet_tpu_torch.serialization) and the same
batches, three Adam steps; and the refusals of what the port has not
ported yet."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.ops import paged_attention as tpa
from mxnet_tpu_torch.parallel import TrainStep

VOCAB = 97
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)
LR, STEPS = 1e-3, 3
KNOBS = ("flash_attention", "flash_pallas_bwd", "fused_adam",
         "fused_layernorm")


def _batch(seed=0):
    ids = np.random.RandomState(seed).randint(0, VOCAB, (2, 24)).astype(np.int32)
    return ids, np.roll(ids, -1, 1)  # next-token labels, as modelbench


@pytest.fixture(scope="module")
def jax_run():
    """Initial weights and, after STEPS steps of the JAX TrainStep, the
    per-step losses and the final weights."""
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))

    def params():
        return {k: np.asarray(p.data().asnumpy())
                for k, p in jnet._collect_params_with_prefix().items()}

    init = params()
    ids, labels = _batch()
    ts = JTrainStep(jnet, jgpt2.lm_loss, jopt.Adam(learning_rate=LR),
                    mesh=None, amp=None)
    losses = [float(np.asarray(ts(nd.array(ids, dtype="int32"),
                                  nd.array(labels, dtype="int32"))))
              for _ in range(STEPS)]
    ts.sync()
    return init, losses, params()


@pytest.mark.parametrize("knobs", [True, False], ids=["kernels", "plain"])
def test_three_steps_match_jax(jax_run, knobs):
    """Losses agree to 1e-5 relative: the f32 forward differs only in sum
    order. Parameters: Adam's first steps move a weight by about
    lr * g / (|g| + eps), close to lr * sign(g), so a gradient near 0 whose
    sign differs between the two runs moves that weight by up to 2 * lr in
    each step: no weight may differ by more than 2 * lr * STEPS, and 99.9%
    of them must agree to 1e-2 * lr (the JAX and port runs agree to
    ~3e-3 * lr at worst on this input; no sign flip occurs)."""
    init, jlosses, jfinal = jax_run
    old = {k: tconfig.get(k) for k in KNOBS}
    try:
        for k in KNOBS:  # knobs on: flash + fused Adam wrappers (plain on CPU)
            tconfig.set(k, knobs)
        net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=5)
        tser.load_mxnet_params(net, init)
        ts = TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=LR))
        ids, labels = _batch()
        losses = [ts(ids, labels) for _ in range(STEPS)]
    finally:
        for k, v in old.items():
            tconfig.set(k, v)
    for got, want in zip(losses, jlosses):
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-5 * abs(want)
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    assert err.max() <= 2 * LR * STEPS
    assert (err > 1e-2 * LR).mean() <= 1e-3
    assert int(ts.step_count) == STEPS and ts.optimizer.num_update == STEPS


def _tiny_step(**opt_kw):
    net = tgpt2.GPT2Model(num_layers=1, units=32, num_heads=2, max_length=16,
                          vocab_size=VOCAB, dropout=0.0, device="cpu", seed=1)
    return net, TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=1e-2,
                                                        **opt_kw))


def test_loss_falls_and_state_stays_on_the_nets_device():
    net, ts = _tiny_step()
    ids, labels = _batch(1)
    ids, labels = ids[:, :16], labels[:, :16]
    losses = [float(ts(ids, labels)) for _ in range(5)]
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert ts.step_count.device == net.device and \
        ts.step_count.dtype == torch.int32
    for m, v in ts.opt_state.values():
        assert m.device == net.device and v.dtype == torch.float32
    assert ts.device == torch.device("cpu")
    ts.sync()  # kept for the API; the net already holds the update


def test_frozen_parameters_and_lr_mult_zero_stay_put():
    net, _ = _tiny_step()
    net.ln_f.gamma.requires_grad_(False)  # frozen before the step is built
    ts = TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=1e-2))
    ts.optimizer.set_lr_mult({"ln_f.beta": 0.0})
    net.blocks[0].proj.bias.lr_mult = 0.0  # a Parameter attribute, as in JAX
    keep = {n: p.detach().clone() for n, p in net.named_parameters()}
    ids, labels = _batch(2)
    ts(ids[:, :16], labels[:, :16])
    after = dict(net.named_parameters())
    assert "ln_f.gamma" not in ts.opt_state
    for name in ("ln_f.gamma", "ln_f.beta", "blocks.0.proj.bias"):
        assert torch.equal(after[name].detach(), keep[name]), name
    assert not torch.equal(after["blocks.0.qkv.weight"].detach(),
                           keep["blocks.0.qkv.weight"])


def test_train_mode_is_restored_and_dropout_only_trains():
    net = tgpt2.GPT2Model(num_layers=1, units=32, num_heads=2, max_length=16,
                          vocab_size=VOCAB, dropout=0.5, device="cpu", seed=2)
    net.eval()
    ids = torch.from_numpy(_batch(3)[0][:, :16])
    with torch.no_grad():
        a, b = net(ids), net(ids)
    assert torch.equal(a, b)  # eval: dropout off
    net.train()
    torch.manual_seed(0)
    with torch.no_grad():
        c = net(ids)
    assert not torch.equal(a, c)  # train: dropout on
    net.eval()
    ts = TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=1e-3))
    ts(ids, torch.roll(ids, -1, 1))
    assert not net.training  # the step trains and then restores eval


def test_lm_loss_is_differentiable():
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.randn(2, 5, VOCAB).astype(np.float32)) \
        .requires_grad_()
    labels = torch.from_numpy(rs.randint(0, VOCAB, (2, 5)))
    (g,) = torch.autograd.grad(tgpt2.lm_loss(logits, labels), logits)
    want = (torch.softmax(logits.detach(), -1)
            - torch.nn.functional.one_hot(labels, VOCAB)) / 10
    torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"layout": object()},
                                {"amp": "bfloat16"}])
def test_refuses_what_is_not_ported(kw):
    net, _ = _tiny_step()
    with pytest.raises(MXNetError, match="not ported"):
        TrainStep(net, tgpt2.lm_loss, topt.Adam(), **kw)


def test_paged_read_raises_under_grad():
    """The paged read has no backward: with grad mode on and an input that
    requires grad it raises instead of returning a detached result."""
    q = torch.randn(1, 2, 1, 16, requires_grad=True)
    pool = torch.randn(3, 2, 4, 16)
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    pos = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(MXNetError, match="no backward"):
        tpa.paged_attention_read(q, pool, pool, table, pos)
    with torch.no_grad():
        out = tpa.paged_attention_read(q, pool, pool, table, pos)
    assert out.shape == (1, 2, 1, 16)
    tpa.paged_attention_read(q.detach(), pool, pool, table, pos)

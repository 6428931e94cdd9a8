"""BERT in the port (mxnet_tpu_torch.models.bert) against the JAX package
with the same weights, at a small size (2 layers, units 64, 4 heads, vocab
97, max_length 64, dropout 0): the structural names, the weight carry
through .params files both ways, the forward outputs with ragged
valid_length and non-zero token types (and the None branches) at 1e-4,
pretrain_loss at 1e-5 relative (zero weights, masked positions T and -1,
labels -1 and V), three f32 TrainStep steps (knobs on and off) and three
amp="bfloat16" steps against the JAX TrainStep(mesh=None,
n_model_inputs=4), dropout only in training mode, and one step program
per batch signature."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.parallel import TrainStep

VOCAB = 97
SMALL = dict(num_layers=2, units=64, hidden_size=256, num_heads=4,
             max_length=64, vocab_size=VOCAB)
B, T, M = 3, 16, 5
LR, STEPS = 1e-3, 3
AMP_TOL = dict(rtol=2e-2, atol=1e-3)  # tests/test_torch_amp.py's
KNOBS = ("flash_attention", "flash_pallas_bwd", "fused_adam",
         "fused_layernorm", "fused_softmax_xent")


def _jax_params(jnet):
    return {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}


def _jax_net(seed=0, dropout=0.0):
    mx.random.seed(seed)
    jnet = jbert.get_bert("bert_large", dropout=dropout, **SMALL)
    jnet.initialize()
    inputs, _ = _batch()
    _ = jnet(*(nd.array(a, dtype="int32") for a in inputs))
    return jnet


def _batch(seed=0):
    """(ids, types, valid_length, masked positions), (labels, weights, NSP
    labels): ragged lengths, both token types, a masked position at T and
    one at -1, labels -1 and V, and a zero weight."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (B, T)).astype(np.int32)
    types = rs.randint(0, 2, (B, T)).astype(np.int32)
    valid = np.array([T, 9, 4], np.int32)
    pos = rs.randint(0, T, (B, M)).astype(np.int32)
    pos[0, 0], pos[1, 1] = T, -1
    labels = rs.randint(0, VOCAB, (B, M)).astype(np.int32)
    labels[0, 1], labels[2, 2] = -1, VOCAB
    weights = np.ones((B, M), np.float32)
    weights[1, 3] = 0.0
    nsp = rs.randint(0, 2, (B,)).astype(np.int32)
    return (ids, types, valid, pos), (labels, weights, nsp)


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax_loss(out, labels, weights, nsp):
    mlm, nsp_scores = out
    return jbert.pretrain_loss(mlm.astype("float32"),
                               nsp_scores.astype("float32"), labels, weights,
                               nsp)


def _loss(out, labels, weights, nsp):
    mlm, nsp_scores = out
    return tbert.pretrain_loss(mlm.float(), nsp_scores.float(), labels,
                               weights, nsp)


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_net()
    tnet = tbert.get_bert("bert_large", dropout=0.0, device="cpu", seed=3,
                          **SMALL)
    tser.load_mxnet_params(tnet, _jax_params(jnet))
    return jnet, tnet


def test_state_dict_names_are_the_jax_structural_names(pair):
    jnet, tnet = pair
    names = list(tnet.state_dict())
    assert names == list(jnet._collect_params_with_prefix())
    assert len(names) == 39 and names[0] == "bert.word_embed.weight" \
        and names[-1] == "nsp.bias"
    assert "bert.encoder.layers.0.attention.qkv.weight" in names
    assert "bert.encoder.layers.0.ln1.gamma" in names


def _elements(num_layers, units, hidden_size, vocab_size, max_length,
              **_):
    u, h, v = units, hidden_size, vocab_size
    layer = 4 * u * u + 4 * u + 2 * u * h + h + u + 4 * u
    body = (v + 2 + max_length) * u + 2 * u + num_layers * layer + u * u + u
    heads = u * u + u + 2 * u + v * u + v + 2 * u + 2
    return body + heads


def test_bert_large_has_303_tensors_and_its_element_count():
    """bert_large at max_length 128 (bench.py's configuration): 303
    tensors and 367,087,420 elements. The tensor count from a model of 24
    narrow layers, the element count from its shapes, a formula held
    against that model."""
    cfg = dict(tbert.bert_configs["bert_large"], max_length=128)
    narrow = dict(cfg, units=8, hidden_size=16, num_heads=2, vocab_size=11)
    net = tbert.get_bert("bert_large", device="cpu", **narrow)
    assert len(list(net.parameters())) == 303
    assert sum(p.numel() for p in net.parameters()) == _elements(**narrow)
    assert _elements(**cfg) == 367_087_420


def test_weight_carry_through_jax_written_params_file(pair, tmp_path):
    jnet, tnet = pair
    fname = str(tmp_path / "bert.params")
    jnet.save_parameters(fname)
    fresh = tbert.get_bert("bert_large", device="cpu", seed=11, **SMALL)
    tser.load_mxnet_params(fresh, tser.load_ndarrays(fname))
    for (k, a), (_, b) in zip(fresh.state_dict().items(),
                              tnet.state_dict().items()):
        assert torch.equal(a, b), k


def test_port_written_params_file_loads_into_jax(pair, tmp_path):
    jnet, tnet = pair
    fname = str(tmp_path / "port.params")
    tser.save_ndarrays(fname, tser.mxnet_params(tnet))
    other = _jax_net(seed=5)
    other.load_parameters(fname)
    inputs, _ = _batch(1)
    args = [nd.array(a, dtype="int32") for a in inputs]
    for a, b in zip(other(*args), jnet(*args)):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("branch", ["full", "no_types", "no_length"])
def test_forward_matches_jax(pair, branch):
    """seq and pooled of the body, mlm and nsp scores of the heads, at
    1e-4; the body also without token types and without valid_length."""
    jnet, tnet = pair
    (ids, types, valid, pos), _ = _batch()
    jargs = [nd.array(a, dtype="int32") for a in (ids, types, valid)]
    targs = list(_torch((ids, types, valid)))
    if branch == "no_types":
        jargs[1] = targs[1] = None
    elif branch == "no_length":
        jargs[2] = targs[2] = None
    with torch.no_grad():
        seq, pooled = tnet.bert(*targs)
        jseq, jpooled = jnet.bert(*jargs)
        np.testing.assert_allclose(seq.numpy(), jseq.asnumpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(pooled.numpy(), jpooled.asnumpy(),
                                   rtol=1e-4, atol=1e-4)
        if branch == "full":
            mlm, nsp = tnet(*_torch((ids, types, valid, pos)))
            jmlm, jnsp = jnet(*jargs, nd.array(pos, dtype="int32"))
            assert mlm.shape == (B, M, VOCAB) and nsp.shape == (B, 2)
            np.testing.assert_allclose(mlm.numpy(), jmlm.asnumpy(),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(nsp.numpy(), jnsp.asnumpy(),
                                       rtol=1e-4, atol=1e-4)


def test_pretrain_loss_matches_jax():
    """Zero weights, labels -1 and V (a label outside the vocabulary
    contributes 0) and an NSP label per row; 1e-5 relative."""
    rs = np.random.RandomState(7)
    mlm = (3 * rs.randn(B, M, VOCAB)).astype(np.float32)
    nsp = rs.randn(B, 2).astype(np.float32)
    _, (labels, weights, nsp_labels) = _batch()
    want = float(jbert.pretrain_loss(
        nd.array(mlm), nd.array(nsp), nd.array(labels, dtype="int32"),
        nd.array(weights), nd.array(nsp_labels, dtype="int32")).asnumpy())
    got = tbert.pretrain_loss(*_torch((mlm, nsp, labels, weights,
                                       nsp_labels)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    # the out-of-range labels (-1, V) add nothing: as weight 0
    w0 = weights.copy()
    w0[0, 1] = w0[2, 2] = 0.0
    rescale = (w0.sum() + 1e-6) / (weights.sum() + 1e-6)
    nsp_part = float(tbert.pretrain_loss(
        *_torch((mlm, nsp, labels, np.zeros_like(weights), nsp_labels))))
    got0 = float(tbert.pretrain_loss(*_torch((mlm, nsp, labels, w0,
                                              nsp_labels))))
    assert abs((float(got) - nsp_part) - (got0 - nsp_part) * rescale) \
        <= 1e-5 * abs(float(got))


def _run_jax(amp):
    jnet = _jax_net()
    init = _jax_params(jnet)
    inputs, loss_in = _batch()
    ts = JTrainStep(jnet, _jax_loss, jopt.Adam(learning_rate=LR), mesh=None,
                    n_model_inputs=4, amp=amp)
    batch = [nd.array(a, dtype="int32") for a in inputs] + [
        nd.array(loss_in[0], dtype="int32"), nd.array(loss_in[1]),
        nd.array(loss_in[2], dtype="int32")]
    losses = [float(np.asarray(ts(*batch))) for _ in range(STEPS)]
    ts.sync()
    return init, losses, _jax_params(jnet)


@pytest.fixture(scope="module")
def jax_f32_run():
    return _run_jax(None)


@pytest.fixture(scope="module")
def jax_bf16_run():
    return _run_jax("bfloat16")


def _run_port(init, amp, knobs, engine_type=None):
    old = {k: tconfig.get(k) for k in KNOBS}
    try:
        for k in KNOBS:
            tconfig.set(k, knobs)
        net = tbert.get_bert("bert_large", dropout=0.0, device="cpu", seed=5,
                             **SMALL)
        tser.load_mxnet_params(net, init)
        ts = TrainStep(net, _loss, topt.Adam(learning_rate=LR),
                       n_model_inputs=4, amp=amp, engine_type=engine_type)
        inputs, loss_in = _batch()
        losses = [ts(*inputs, *loss_in) for _ in range(STEPS)]
    finally:
        for k, v in old.items():
            tconfig.set(k, v)
    return net, ts, losses


@pytest.mark.parametrize("knobs", [True, False], ids=["kernels", "plain"])
def test_three_steps_match_jax(jax_f32_run, knobs):
    """The criteria of tests/test_torch_train_step.py: losses to 1e-5
    relative, no weight beyond Adam's sign-flip bound 2 * lr * steps, and
    99.9% of them within 1e-2 * lr."""
    init, jlosses, jfinal = jax_f32_run
    net, ts, losses = _run_port(init, None, knobs)
    for got, want in zip(losses, jlosses):
        assert got.dim() == 0 and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-5 * abs(want)
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    assert err.max() <= 2 * LR * STEPS
    assert (err > 1e-2 * LR).mean() <= 1e-3
    assert int(ts.step_count) == STEPS


@pytest.mark.parametrize("knobs", [True, False], ids=["kernels", "plain"])
def test_bf16_three_steps_match_jax(jax_bf16_run, knobs):
    """amp="bfloat16": losses within AMP_TOL, the masters f32 within the
    sign-flip bound of the JAX masters and 99% within AMP_TOL, the copies
    the rounding of the masters."""
    init, jlosses, jfinal = jax_bf16_run
    net, ts, losses = _run_port(init, "bfloat16", knobs)
    np.testing.assert_allclose([float(x) for x in losses], jlosses,
                               **AMP_TOL)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    for name, p in net.named_parameters():
        assert torch.equal(ts._low[name], p.detach().to(torch.bfloat16)), name
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    assert err.max() <= 2 * LR * STEPS
    bad = np.concatenate([(np.abs(final[k] - jfinal[k])
                           > AMP_TOL["atol"] + AMP_TOL["rtol"] * np.abs(jfinal[k])
                           ).ravel() for k in jfinal])
    assert bad.mean() <= 1e-2


def test_dropout_only_in_training_mode():
    net = tbert.get_bert("bert_large", dropout=0.5, device="cpu", seed=2,
                         **SMALL)
    inputs = _torch(_batch()[0])
    net.eval()
    with torch.no_grad():
        a, b = net(*inputs), net(*inputs)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    net.train()
    torch.manual_seed(0)
    with torch.no_grad():
        c = net(*inputs)
    assert not torch.equal(a[0], c[0])
    net.eval()
    ts = TrainStep(net, _loss, topt.Adam(learning_rate=0.0),
                   n_model_inputs=4)
    _, loss_in = _batch()
    first, second = (float(ts(*inputs, *loss_in)) for _ in range(2))
    assert first != second  # lr 0: only the dropout masks differ
    assert not net.training  # the step trains and then restores eval


@pytest.mark.parametrize("mode", ["graph", "naive"])
def test_one_program_per_batch_signature(jax_f32_run, mode):
    """Seven batch entries (four int32 model inputs, int32 labels, f32
    weights, int32 NSP labels): one program while the signature holds, a
    second for another sequence length; "graph" and "naive" agree bit for
    bit."""
    init = jax_f32_run[0]
    _, ts, losses = _run_port(init, None, True, engine_type=mode)
    assert ts.compiled_programs == 1 and ts.recaptures == 0
    (ids, types, valid, pos), loss_in = _batch()
    short = (ids[:, :8], types[:, :8], np.minimum(valid, 8), pos % 8)
    assert np.isfinite(float(ts(*short, *loss_in)))
    assert ts.compiled_programs == 2
    _, other, other_losses = _run_port(
        init, None, True, engine_type="naive" if mode == "graph" else "graph")
    assert [float(x) for x in losses] == [float(x) for x in other_losses]


def test_too_long_a_sequence_raises():
    net = tbert.get_bert("bert_large", device="cpu", **dict(SMALL,
                                                            max_length=8))
    (ids, types, valid, _), _ = _batch()
    with pytest.raises(MXNetError, match="max_length"):
        net.bert(*_torch((ids, types, valid)))

"""GPT-2 in the port (mxnet_tpu_torch.models.gpt2) against the JAX package
with the same weights: the weight carry through the parameter dict and
through .params files both ways, full-forward logits, cached prefill and
decode logits (1e-4), and the LM loss."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import serialization as jser
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2

VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)


def _jax_params(jnet):
    return {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    tnet = tgpt2.GPT2Model(**SMALL, device="cpu", seed=3)
    tser.load_mxnet_params(tnet, _jax_params(jnet))
    return jnet, tnet


def test_state_dict_names_are_the_jax_structural_names(pair):
    jnet, tnet = pair
    assert list(tnet.state_dict()) == list(jnet._collect_params_with_prefix())


def test_weight_carry_round_trips_through_dict(pair):
    jnet, tnet = pair
    back = tser.mxnet_params(tnet)
    ref = _jax_params(jnet)
    assert back.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k])


def test_weight_carry_through_jax_written_params_file(pair, tmp_path):
    jnet, tnet = pair
    fname = str(tmp_path / "gpt2.params")
    jnet.save_parameters(fname)
    fresh = tgpt2.GPT2Model(**SMALL, device="cpu", seed=11)
    tser.load_mxnet_params(fresh, tser.load_ndarrays(fname))
    for (k, a), (_, b) in zip(fresh.state_dict().items(),
                              tnet.state_dict().items()):
        assert torch.equal(a, b), k


def test_port_written_params_file_loads_into_jax(pair, tmp_path):
    jnet, tnet = pair
    fname = str(tmp_path / "port.params")
    tser.save_ndarrays(fname, tser.mxnet_params(tnet))
    mx.random.seed(5)
    other = jgpt2.GPT2Model(**SMALL)
    other.initialize()
    _ = other(nd.array(np.zeros((1, 4)), dtype="int32"))
    other.load_parameters(fname)
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 9))
    np.testing.assert_array_equal(
        other(nd.array(ids, dtype="int32")).asnumpy(),
        jnet(nd.array(ids, dtype="int32")).asnumpy())


def test_bf16_params_payload_reads_widened(tmp_path):
    import ml_dtypes

    a = (np.random.RandomState(0).randn(3, 5)).astype(ml_dtypes.bfloat16)
    fname = str(tmp_path / "bf16.params")
    jser.save_ndarrays(fname, {"a": a, "b": np.arange(4, dtype=np.int32)})
    got = tser.load_ndarrays(fname)
    assert got["a"].dtype == np.float32
    np.testing.assert_array_equal(got["a"], a.astype(np.float32))
    np.testing.assert_array_equal(got["b"], np.arange(4, dtype=np.int32))


@pytest.mark.parametrize("bad", ["missing", "extra", "shape"])
def test_weight_carry_checks_names_and_shapes(pair, bad):
    jnet, _ = pair
    arrays = _jax_params(jnet)
    if bad == "missing":
        arrays.pop("ln_f.beta")
    elif bad == "extra":
        arrays["blocks.9.qkv.weight"] = np.zeros((1,), np.float32)
    else:
        arrays["blocks.0.qkv.bias"] = np.zeros((7,), np.float32)
    net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=4)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with pytest.raises(MXNetError):
        tser.load_mxnet_params(net, arrays)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), "a failed load changed the module"


@pytest.mark.parametrize("t", [1, 9, 33])
def test_full_forward_logits_match_jax(pair, t):
    jnet, tnet = pair
    ids = np.random.RandomState(t).randint(0, VOCAB, (3, t))
    ref = jnet(nd.array(ids, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("paged", [False, True])
def test_cached_prefill_and_decode_logits_match_jax(pair, paged):
    jnet, tnet = pair
    kw = dict(batch_size=2, prefill_buckets=(8, 16), eos_id=None, pad_id=PAD,
              paged=paged)
    if paged:
        kw["page_size"] = 8
    jeng, teng = JEngine(jnet, **kw), TEngine(tnet, device="cpu", **kw)
    rs = np.random.RandomState(7)
    for slot, n in enumerate((5, 13)):
        prompt = list(rs.randint(1, EOS, n))
        assert jeng.prefill(prompt, slot) == teng.prefill(prompt, slot)
        np.testing.assert_allclose(teng._last_logits.numpy(),
                                   np.asarray(jeng._last_logits),
                                   rtol=1e-4, atol=1e-4)
    for _ in range(5):
        jt, _, jl = jeng.decode_step()
        tt, _, tl = teng.decode_step()
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)


def test_lm_loss_matches_jax(pair):
    rs = np.random.RandomState(8)
    logits = rs.randn(2, 6, VOCAB).astype(np.float32)
    labels = rs.randint(0, VOCAB, (2, 6)).astype(np.int32)
    ref = float(jgpt2.lm_loss(nd.array(logits), nd.array(labels)).asnumpy())
    got = float(tgpt2.lm_loss(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref))


def test_get_gpt2_config_and_seeded_init():
    a = tgpt2.get_gpt2("gpt2_tiny", dropout=0.0, device="cpu", seed=1,
                       num_layers=1)
    b = tgpt2.get_gpt2("gpt2_tiny", dropout=0.0, device="cpu", seed=1,
                       num_layers=1)
    assert a.word_embed.weight.shape == (50257, 128)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert torch.equal(a.ln_f.gamma.detach(), torch.ones(128))
    assert torch.equal(a.ln_f.beta.detach(), torch.zeros(128))
    std = a.blocks[0].qkv.weight.detach().std().item()
    assert abs(std - 0.02) < 0.002

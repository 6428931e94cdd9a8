"""The port's serving slice (GenerationEngine + ContinuousBatcher) against
the JAX package's, with the same weights: greedy tokens identical (dense
and paged), per-step decode logits at 1e-4, paged == dense bit-identical
within the port, page reclaim, page exhaustion, finished rows at
max_length, batcher finish reasons, and the samplers' distributions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.ops import random_ops as jrops
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.ops import sampling as tsampling

VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)


def _lively_weights(jnet, seed=0):
    """Seeded weights large enough that greedy decoding wanders over the
    vocabulary instead of repeating one token."""
    rs = np.random.RandomState(seed)
    out = {}
    for name, p in jnet._collect_params_with_prefix().items():
        shape = p.data().shape
        if name.endswith("gamma"):
            a = 1 + 0.1 * rs.randn(*shape)
        elif name.endswith(("beta", "bias")):
            a = 0.1 * rs.randn(*shape)
        elif name == "word_embed.weight":
            a = rs.randn(*shape)
        elif name == "position_embed.weight":
            a = 3 * rs.randn(*shape)
        else:
            a = 1.5 * rs.randn(*shape) / np.sqrt(shape[1])
        out[name] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    weights = _lively_weights(jnet)
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(weights[name]))
    tnet = tgpt2.GPT2Model(**SMALL, device="cpu")
    tser.load_mxnet_params(tnet, weights)
    return jnet, tnet


def _kw(paged, **kw):
    kw.setdefault("batch_size", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("eos_id", EOS)
    kw.setdefault("pad_id", PAD)
    kw["paged"] = paged
    if paged:
        kw.setdefault("page_size", 8)
    return kw


def _prompt(n, seed):
    return list(np.random.RandomState(seed).randint(1, EOS, n))


PROMPTS = [_prompt(5, 10), _prompt(12, 11), _prompt(3, 12)]


@pytest.mark.parametrize("paged,extra", [
    (False, {}),
    (True, {}),
    (True, {"page_size": 6}),
    (False, {"cache_dtype": "bfloat16"}),
])
def test_greedy_tokens_identical_to_jax(pair, paged, extra):
    jnet, tnet = pair
    kw = _kw(paged, **extra)
    ref = JEngine(jnet, **kw).generate(PROMPTS, max_new_tokens=12)
    got = TEngine(tnet, device="cpu", **kw).generate(PROMPTS, max_new_tokens=12)
    assert got == ref
    assert len(set(sum(got, []))) > 6  # the weights make decoding wander


def test_paged_decode_logits_match_jax_per_step(pair):
    jnet, tnet = pair
    kw = _kw(True, batch_size=2, page_size=6)
    jeng, teng = JEngine(jnet, **kw), TEngine(tnet, device="cpu", **kw)
    for i, p in enumerate(PROMPTS[:2]):
        assert jeng.prefill(p, i) == teng.prefill(p, i)
    for _ in range(8):
        jt, jd, jl = jeng.decode_step()
        tt, td, tl = teng.decode_step()
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_array_equal(td, np.asarray(jd))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", [8, 6])
def test_paged_equals_dense_bit_identical(pair, cache_dtype, page_size):
    _, tnet = pair
    dense = TEngine(tnet, device="cpu",
                    **_kw(False, batch_size=2, cache_dtype=cache_dtype))
    paged = TEngine(tnet, device="cpu",
                    **_kw(True, batch_size=2, cache_dtype=cache_dtype,
                          page_size=page_size))
    for i, p in enumerate([_prompt(5, 20), _prompt(12, 21)]):
        assert dense.prefill(p, i) == paged.prefill(p, i)
        assert torch.equal(dense._last_logits, paged._last_logits)
    for _ in range(10):
        _, _, lg_d = dense.decode_step()
        _, _, lg_p = paged.decode_step()
        assert torch.equal(lg_d, lg_p)


def test_pages_reclaimed_on_release(pair):
    _, tnet = pair
    eng = TEngine(tnet, device="cpu", **_kw(True, batch_size=2, eos_id=None))
    assert eng.free_pages == eng.num_pages
    eng.prefill(_prompt(12, 30), 0)
    eng.prefill(_prompt(5, 31), 1)
    assert eng.pages_in_use == 2 + 1
    for _ in range(6):
        eng.decode_step()
    used = eng.pages_in_use
    # row 0 (12..17) crossed into its third page at 16, row 1 (5..10) into
    # its second at 8
    assert used == 3 + 2
    row1 = list(eng._row_pages[1])
    eng.release_slot(1)
    assert eng.pages_in_use == used - len(row1)
    eng.decode_step()  # the released row's device table row is cleared
    assert int(eng.page_table[1].abs().sum()) == 0
    # a reallocated page must not be corrupted by the released row
    eng.prefill(_prompt(7, 32), 1)
    assert set(eng._row_pages[1]) <= set(row1) | set(range(1, eng.num_pages + 1))
    eng.release_slot(0)
    eng.release_slot(1)
    assert eng.free_pages == eng.num_pages


def test_page_exhaustion_matches_jax(pair):
    jnet, tnet = pair
    kw = _kw(True, batch_size=2, num_pages=5, eos_id=None)
    jeng, teng = JEngine(jnet, **kw), TEngine(tnet, device="cpu", **kw)
    prompts = [_prompt(12, 40), _prompt(9, 41)]
    ref = jeng.generate(prompts, max_new_tokens=30)
    got = teng.generate(prompts, max_new_tokens=30)
    assert got == ref
    assert teng.page_exhausted.any()
    np.testing.assert_array_equal(teng.page_exhausted, jeng.page_exhausted)


@pytest.mark.parametrize("paged", [False, True])
def test_finished_row_at_max_length_does_not_raise(pair, paged):
    """Row 0 fills the cache (position == max_length) and keeps riding the
    decode batch as a done row while row 1 is still live: no error, and the
    live row's tokens match the JAX dense engine."""
    jnet, tnet = pair
    kw = _kw(paged, batch_size=2, eos_id=None)
    prompts = [_prompt(14, 50), _prompt(3, 51)]
    eng = TEngine(tnet, device="cpu", **kw)
    got = eng.generate(prompts, max_new_tokens=200)
    assert [len(g) for g in got] == [64 - 14 + 1, 64 - 3 + 1]
    assert int(eng.positions[0]) == 64 and bool(eng.done[0])
    ref = JEngine(jnet, **_kw(False, batch_size=2, eos_id=None)).generate(
        prompts, max_new_tokens=200)
    assert got == ref


def _serve_jax(jnet, kw, reqs):
    b = JBatcher(JEngine(jnet, **kw))
    hs = [b.submit(p, max_new_tokens=n) for p, n in reqs]
    b.run_until_idle()
    return [(h.output, h.finish_reason) for h in hs]


def _serve_port(tnet, kw, reqs):
    b = TBatcher(TEngine(tnet, device="cpu", **kw), device="cpu")
    hs = [b.submit(p, max_new_tokens=n) for p, n in reqs]
    b.run()
    assert b.active == 0 and b.pending == 0
    assert b.engine.free_pages == b.engine.num_pages
    return [(h.output, h.finish_reason) for h in hs]


def test_batcher_serves_more_requests_than_slots(pair):
    jnet, tnet = pair
    reqs = [(_prompt(5, 60), 6), (_prompt(9, 61), 1), (_prompt(14, 62), 60),
            (_prompt(3, 63), 10), (_prompt(7, 64), 8)]
    kw = _kw(True, batch_size=2, eos_id=None)
    # make a token that the JAX engine emits mid-way through request 3, and
    # never in request 2, the EOS, so that both the eos and the cache_full
    # finish reasons are exercised
    first = _serve_jax(jnet, kw, reqs)
    eos = next(t for t in first[3][0][1:] if t not in first[2][0])
    kw["eos_id"] = int(eos)
    ref = _serve_jax(jnet, kw, reqs)
    got = _serve_port(tnet, kw, reqs)
    assert got == ref
    reasons = {r for _, r in got}
    assert {"eos", "length", "cache_full"} <= reasons, reasons


def test_batcher_page_exhausted_finish(pair):
    _, tnet = pair
    reqs = [(_prompt(12, 70), 40), (_prompt(9, 71), 40), (_prompt(4, 72), 5)]
    got = _serve_port(tnet, _kw(True, batch_size=2, num_pages=5, eos_id=None),
                      reqs)
    reasons = [r for _, r in got]
    assert "page_exhausted" in reasons
    assert all(r in ("length", "page_exhausted") for r in reasons)


def _tv(counts, p):
    return 0.5 * np.abs(counts / counts.sum() - p).sum()


@pytest.mark.parametrize("method", ["temperature", "top_k"])
def test_sampling_distribution_matches(method):
    """Port and JAX samplers both draw from the exact target distribution
    (total variation on a fixed logits vector, 20000 draws each)."""
    logits = np.array([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2], np.float32)
    temp, k, n = 0.8, 4, 20000
    z = logits / temp
    if method == "top_k":
        kth = np.sort(logits)[-k]
        z = np.where(logits < kth, -np.inf, z)
    p = np.exp(z - z.max())
    p /= p.sum()
    batch = np.tile(logits, (n, 1))
    gen = torch.Generator().manual_seed(0)
    if method == "top_k":
        t = tsampling.top_k_sampling(torch.from_numpy(batch), k=k,
                                     temperature=temp, generator=gen)
        j = jrops.top_k_sampling(jnp.asarray(batch), k=k, temperature=temp,
                                 key=jax.random.key(0))
    else:
        t = tsampling.temperature_sampling(torch.from_numpy(batch),
                                           temperature=temp, generator=gen)
        j = jrops.temperature_sampling(jnp.asarray(batch), temperature=temp,
                                       key=jax.random.key(0))
    assert t.dtype == torch.int32 and t.shape == (n,)
    tc = np.bincount(t.numpy(), minlength=logits.size).astype(float)
    jc = np.bincount(np.asarray(j), minlength=logits.size).astype(float)
    assert _tv(tc, p) < 0.02 and _tv(jc, p) < 0.02
    if method == "top_k":
        assert tc[logits < np.sort(logits)[-k]].sum() == 0


def test_stochastic_engine_is_seeded(pair):
    _, tnet = pair
    kw = _kw(True, sampling="top_k")
    a = TEngine(tnet, device="cpu", **kw).generate(PROMPTS, max_new_tokens=8)
    b = TEngine(tnet, device="cpu", **kw).generate(PROMPTS, max_new_tokens=8)
    assert a == b


def test_submit_refuses_out_of_range_ids(pair):
    """An id outside [0, vocab) is refused at submit (the JAX batcher takes
    it and its engine computes NaN from it), before the request can take
    a slot; nothing is queued."""
    _, tnet = pair
    bat = TBatcher(TEngine(tnet, device="cpu", **_kw(True)), device="cpu")
    for bad in ([1, 2, VOCAB], [-1, 5], [3, VOCAB + 40]):
        with pytest.raises(ValueError, match="token ids"):
            bat.submit(bad, max_new_tokens=3)
    assert bat.pending == 0 and bat.active == 0
    bat.submit([1, VOCAB - 1], max_new_tokens=2)
    bat.run()


@pytest.mark.parametrize("paged", [False, True])
def test_failed_prefill_holds_no_slot(pair, paged):
    """A prefill that raises leaves its slot free (``active == 0``) and its
    request at the head of the queue; once the fault is gone the run
    serves every request with the tokens of an unfaulted run."""
    _, tnet = pair
    reqs = [(_prompt(5, 80), 4), (_prompt(9, 81), 3)]
    clean = TBatcher(TEngine(tnet, device="cpu", **_kw(paged, batch_size=2)),
                     device="cpu")
    want = [clean.submit(p, max_new_tokens=n) for p, n in reqs]
    clean.run()
    want = [(h.output, h.finish_reason) for h in want]
    eng = TEngine(tnet, device="cpu", **_kw(paged, batch_size=2))
    bat = TBatcher(eng, device="cpu")
    hs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
    prefill = eng.prefill

    def failing(prompt, slot):
        raise RuntimeError("planted prefill failure")

    eng.prefill = failing
    with pytest.raises(RuntimeError, match="planted"):
        bat.run()
    assert bat.active == 0 and bat.pending == 2
    assert all(h.slot is None and not h.done and h.output == [] for h in hs)
    eng.prefill = prefill
    bat.run()
    assert [(h.output, h.finish_reason) for h in hs] == want


def test_embedding_out_of_range_matches_jnp_take():
    """``ops.nn.embedding`` against ``jnp.take`` (the JAX ``Embedding``):
    in-range ids and ids in [-V, 0) gather rows, ids outside [-V, V) give
    NaN rows, on the forward and through a GPT-2's token embedding; the
    gradient drops the rows of the ids outside."""
    from mxnet_tpu_torch.ops import nn as tnn

    rs = np.random.RandomState(3)
    weight = rs.randn(7, 5).astype(np.float32)
    ids = np.array([[0, 3, 6, 7], [-1, -7, -8, 100]])
    cot = rs.randn(2, 4, 5).astype(np.float32)
    want = np.asarray(jnp.take(jnp.asarray(weight), jnp.asarray(ids), axis=0))
    want_grad = np.asarray(jax.grad(lambda w: (jnp.take(
        w, jnp.asarray(ids), axis=0) * cot).sum())(jnp.asarray(weight)))
    w = torch.tensor(weight, requires_grad=True)
    got = tnn.embedding(torch.tensor(ids), w)
    (got * torch.tensor(cot)).sum().backward()
    nan = np.isnan(want)
    assert nan.any(axis=-1).tolist() == [[False] * 3 + [True],
                                         [False, False, True, True]]
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), nan)
    np.testing.assert_array_equal(got.detach().numpy()[~nan], want[~nan])
    np.testing.assert_allclose(w.grad.numpy(), want_grad, rtol=1e-6,
                               atol=1e-6)

def test_model_with_out_of_range_id_is_nan_where_jax_is(pair):
    """An id past the vocabulary in a full GPT-2 forward: no error, and
    NaN logits where the JAX model has them."""
    jnet, tnet = pair
    ids = np.array([[5, VOCAB + 3, 7, 9], [1, 2, 3, 4]])
    want = jnet(nd.array(ids, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tnet(torch.tensor(ids)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[0]).any() and not np.isnan(got[1]).any()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-4)

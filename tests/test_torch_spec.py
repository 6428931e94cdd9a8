"""The port's speculative decoding (``draft_net=``, ``speculate_k=``) against
the JAX engine's, with the same weights: greedy rounds give the JAX tokens
exactly at every accept rate (self-draft full accept, a draft net of
perturbed weights, a scripted partial accept with exact counts, a reject-all
rollback), stop at EOS inside the window and at the cache end, write the
last drafted token into the draft's cache, serve through the batcher as
the solo engine does, count buckets used + 2 programs, and refuse what the
JAX engine refuses. Rejection-sampled rounds are held within the port: the
first emitted token's marginal against plain sampled decode (total
variation < 0.15; Philox and threefry streams never match draw for
draw)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.inference import SamplingConfig
from mxnet_tpu_torch.models import gpt2 as tgpt2

VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)


def _lively_weights(jnet, seed=0):
    """Seeded weights large enough that greedy decoding wanders over the
    vocabulary (as tests/test_torch_engine.py draws them)."""
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


def _pair(seed, noise=0.0, **over):
    """A JAX net and a port net with the same seeded weights; ``noise``
    perturbs the seed-0 weights by that share of a seeded normal draw."""
    cfg = dict(SMALL, **over)
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**cfg)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    weights = _lively_weights(jnet, 0 if noise else seed)
    if noise:
        rs = np.random.RandomState(seed)
        weights = {k: (w * (1 + noise * rs.randn(*w.shape))).astype(
            np.float32) for k, w in sorted(weights.items())}
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(weights[name]))
    tnet = tgpt2.GPT2Model(**cfg, device="cpu")
    tser.load_mxnet_params(tnet, weights)
    return jnet, tnet


@pytest.fixture(scope="module")
def pair():
    return _pair(0)


@pytest.fixture(scope="module")
def draft_pair():
    """A draft net of the target's weights perturbed: its greedy tokens
    agree with the target's now and then, so rounds accept partly."""
    return _pair(7, noise=NOISE)


#: the draft's weight perturbation (see draft_pair)
NOISE = 0.1


def _kw(**kw):
    kw.setdefault("batch_size", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("eos_id", EOS)
    kw.setdefault("pad_id", PAD)
    kw.setdefault("page_size", 8)
    kw["paged"] = True
    return kw


def _prompt(n, seed):
    return list(np.random.RandomState(seed).randint(1, EOS, n))


def _engines(pair, draft=None, **kw):
    """(JAX engine, port engine) with the same configuration; ``draft`` a
    (JAX, port) pair of draft nets or "self"."""
    jnet, tnet = pair
    jkw, tkw = dict(kw), dict(kw)
    if draft == "self":
        jkw.update(draft_net=jnet, speculate_k=kw.get("speculate_k", 4))
        tkw.update(draft_net=tnet, speculate_k=kw.get("speculate_k", 4))
    elif draft is not None:
        jkw.update(draft_net=draft[0])
        tkw.update(draft_net=draft[1])
    return JEngine(jnet, **_kw(**jkw)), TEngine(tnet, device="cpu",
                                                **_kw(**tkw))


class ScriptedDraftJax:
    """JAX draft whose greedy token at sequence position p is
    ``script[p]`` (tests/test_paged_inference.py's ScriptedDraft)."""

    def __init__(self, script, max_length):
        self._script = jnp.asarray(np.asarray(script, np.int32))
        self._max_length = max_length

    def collect_params(self):
        return {}

    def init_paged_cache(self, num_pages, page_size, dtype="float32"):
        shape = (num_pages + 1, 1, page_size, 1)
        return [(jnp.zeros(shape, jnp.float32),
                 jnp.zeros(shape, jnp.float32))]

    def __call__(self, tokens, cache=None, start_pos=None, page_table=None):
        t = tokens._data.shape[1]
        pos = jnp.clip(start_pos._data.reshape(-1, 1)
                       + jnp.arange(t, dtype=jnp.int32)[None, :],
                       0, self._max_length - 1)
        return NDArray(jax.nn.one_hot(self._script[pos], VOCAB,
                                      dtype=jnp.float32) * 10.0), cache


class ScriptedDraft(torch.nn.Module):
    """The port's counterpart: a module whose greedy token at sequence
    position p is ``script[p]``."""

    def __init__(self, script, max_length):
        super().__init__()
        self._script = torch.as_tensor(np.asarray(script), dtype=torch.int64)
        self._max_length = max_length

    @property
    def device(self):
        return torch.device("cpu")

    def init_paged_cache(self, num_pages, page_size, dtype="float32"):
        z = torch.zeros((num_pages + 1, 1, page_size, 1))
        return [(z, z.clone())]

    def forward(self, tokens, cache=None, start_pos=None, page_table=None):
        t = tokens.shape[1]
        pos = (torch.as_tensor(start_pos).reshape(-1, 1).long()
               + torch.arange(t)).clamp(0, self._max_length - 1)
        return F.one_hot(self._script[pos], VOCAB).float() * 10.0, cache


def _scripted(script):
    return ScriptedDraftJax(script, 64), ScriptedDraft(script, 64)


PROMPTS = [_prompt(5, 120), _prompt(12, 121), _prompt(3, 122)]


def test_self_draft_full_accept_equals_jax(pair):
    jeng, teng = _engines(pair, draft="self")
    ref = JEngine(pair[0], **_kw()).generate(PROMPTS, max_new_tokens=11)
    assert jeng.generate(PROMPTS, max_new_tokens=11) == ref
    teng.prefill(PROMPTS[0], 0)
    drafted = accepted = 0
    for _ in range(2):
        teng.spec_step()
        drafted += teng.last_round_drafted
        accepted += teng.last_round_accepted
    assert drafted == 2 * 4 and accepted == drafted  # self-draft: all kept
    got = teng.generate(PROMPTS, max_new_tokens=11)
    assert got == ref
    assert len(set(sum(got, []))) > 6  # the weights make decoding wander


def test_other_draft_partial_accept_equals_jax(pair, draft_pair):
    """A draft net of perturbed weights: rounds accept some drafts and
    reject others; tokens and per-round counts equal JAX's and plain
    greedy's."""
    jeng, teng = _engines(pair, draft=draft_pair, speculate_k=3)
    prompts = PROMPTS[:2]
    for i, p in enumerate(prompts):
        assert jeng.prefill(p, i) == teng.prefill(p, i)
    accepted = []
    for _ in range(8):
        jt, jm, jd = jeng.spec_step()
        tt, tm, td = teng.spec_step()
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_array_equal(tm, np.asarray(jm))
        np.testing.assert_array_equal(td, np.asarray(jd))
        assert teng.last_round_accepted == jeng.last_round_accepted
        accepted.append(teng.last_round_accepted)
    np.testing.assert_array_equal(teng.positions, jeng.positions)
    assert 0 < sum(accepted) < 8 * 2 * 3  # neither all nor nothing
    ref = JEngine(pair[0], **_kw()).generate(prompts, max_new_tokens=16)
    assert teng.generate(prompts, max_new_tokens=16) == ref


def test_scripted_partial_accept_exact_counts(pair):
    """A draft right once and wrong after: round 1 emits 1 draft + the
    correction (m 2), round 2 rejects all (m 1)."""
    jnet, tnet = pair
    p = _prompt(6, 130)
    probe = TEngine(tnet, device="cpu", **_kw(batch_size=1, eos_id=None))
    t0 = probe.prefill(p, 0)
    cont = [int(probe.decode_step()[0][0]) for _ in range(6)]
    script = np.zeros(64, np.int32)
    script[len(p)] = cont[0]                    # d1 right
    script[len(p) + 1] = (cont[1] + 1) % VOCAB  # d2 wrong
    jd, td = _scripted(script)
    kw = _kw(batch_size=1, eos_id=None, speculate_k=3)
    jeng = JEngine(jnet, draft_net=jd, **kw)
    teng = TEngine(tnet, device="cpu", draft_net=td, **kw)
    assert jeng.prefill(p, 0) == teng.prefill(p, 0) == t0
    toks, m, _ = teng.spec_step()
    assert int(m[0]) == 2 and list(toks[0, :2]) == cont[:2]
    assert teng.last_round_accepted == 1
    toks, m, _ = teng.spec_step()  # the zero script: full reject
    assert int(m[0]) == 1 and int(toks[0, 0]) == cont[2]
    assert teng.last_round_accepted == 0
    for _ in range(2):
        jt, jm, _ = jeng.spec_step()
    np.testing.assert_array_equal(teng.positions, jeng.positions)


def test_reject_all_rollback_equals_jax(pair):
    """A draft that is always wrong rolls the frontier back every round:
    the stream is still plain greedy's, and JAX's."""
    prompts = [_prompt(5, 140), _prompt(9, 141)]
    jd, td = _scripted(np.full(64, EOS - 1, np.int32))
    jeng, teng = _engines(pair, draft=(jd, td), batch_size=2,
                          speculate_k=3)
    ref = JEngine(pair[0], **_kw(batch_size=2)).generate(prompts,
                                                         max_new_tokens=9)
    assert jeng.generate(prompts, max_new_tokens=9) == ref
    assert teng.generate(prompts, max_new_tokens=9) == ref


def test_eos_mid_window_equals_jax(pair):
    """The third greedy token declared EOS: emission stops there, as in
    the plain engine."""
    jnet, tnet = pair
    p = _prompt(7, 150)
    probe = TEngine(tnet, device="cpu", **_kw(batch_size=1, eos_id=None))
    probe.prefill(p, 0)
    eos = [int(probe.decode_step()[0][0]) for _ in range(4)][2]
    kw = _kw(batch_size=1, eos_id=eos)
    ref = JEngine(jnet, **kw).generate([p], max_new_tokens=12)
    got = TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4,
                  **kw).generate([p], max_new_tokens=12)
    assert got == ref == JEngine(jnet, draft_net=jnet, speculate_k=4,
                                 **kw).generate([p], max_new_tokens=12)
    assert got[0][-1] == eos


def test_cache_end_clamp_equals_jax():
    """Rounds near the cache end clamp emission at capacity and finish
    the row as the plain path does."""
    jnet, tnet = _pair(2, max_length=16)
    kw = _kw(batch_size=1, max_length=16, prefill_buckets=(8,), eos_id=None)
    p = _prompt(6, 160)
    ref = JEngine(jnet, **kw).generate([p], max_new_tokens=100)
    spec = TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4, **kw)
    got = spec.generate([p], max_new_tokens=100)
    assert got == ref == JEngine(jnet, draft_net=jnet, speculate_k=4,
                                 **kw).generate([p], max_new_tokens=100)
    assert len(got[0]) == 16 - 6 + 1 and bool(spec.done[0])


def test_draft_cache_writes_last_drafted_token(pair):
    """Full-accept rounds move the frontier past p + k; the draft's k + 1
    steps wrote d_k's K/V there: every draft entry below the frontier
    equals the target's (self-draft) and none is the zero page content."""
    _, tnet = pair
    spec = TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4,
                   **_kw(batch_size=1, prefill_buckets=(8,), eos_id=None))
    spec.prefill(_prompt(6, 210), 0)
    for _ in range(6):
        spec.spec_step()
    frontier = int(spec.positions[0])
    assert frontier > 12
    table = spec.page_table[0].tolist()
    k_draft, k_target = spec.draft_pools[0][0], spec.pools[0][0]
    for pos in range(frontier):
        pid, off = table[pos // 8], pos % 8
        torch.testing.assert_close(k_draft[pid, :, off], k_target[pid, :, off],
                                   rtol=1e-6, atol=1e-6)
        assert k_draft[pid, :, off].abs().sum() > 0


def test_batcher_matches_solo_and_jax(pair):
    prompts = [_prompt(4, 170), _prompt(11, 171), _prompt(7, 172)]
    jnet, tnet = pair
    want = JEngine(jnet, **_kw()).generate(prompts, max_new_tokens=7)
    jb = JBatcher(JEngine(jnet, draft_net=jnet, speculate_k=4,
                          **_kw(batch_size=2)))
    tb = TBatcher(TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4,
                          **_kw(batch_size=2)), device="cpu")
    jr = [jb.submit(p, max_new_tokens=7) for p in prompts]
    tr = [tb.submit(p, max_new_tokens=7) for p in prompts]
    jb.run_until_idle(max_steps=100)
    tb.run(max_steps=100)
    assert [r.result() for r in tr] == [r.result() for r in jr] == want
    assert [r.finish_reason for r in tr] == [r.finish_reason for r in jr]
    assert tb.engine.free_pages == tb.engine.num_pages


def test_batcher_other_draft_equals_jax(pair, draft_pair):
    """The batcher on a partly accepting draft: budgets that end inside a
    window, EOS and slot reuse, against JAX's batcher."""
    jnet, tnet = pair
    reqs = [(_prompt(4 + i, 180 + i), 3 + 2 * i) for i in range(5)]
    jb = JBatcher(JEngine(jnet, draft_net=draft_pair[0], speculate_k=3,
                          **_kw(batch_size=2)))
    tb = TBatcher(TEngine(tnet, device="cpu", draft_net=draft_pair[1],
                          speculate_k=3, **_kw(batch_size=2)), device="cpu")
    jr = [jb.submit(p, max_new_tokens=n) for p, n in reqs]
    tr = [tb.submit(p, max_new_tokens=n) for p, n in reqs]
    jb.run_until_idle(max_steps=200)
    tb.run(max_steps=200)
    assert [(r.output, r.finish_reason) for r in tr] == \
        [(r.output, r.finish_reason) for r in jr]
    assert [r.rounds for r in tr] == [r.rounds for r in jr]


def test_config_validation(pair):
    _, tnet = pair
    for bad in (dict(draft_net=tnet), dict(speculate_k=4)):
        with pytest.raises(ValueError):
            TEngine(tnet, device="cpu", **_kw(**bad))
    with pytest.raises(ValueError):
        TEngine(tnet, device="cpu", **dict(_kw(draft_net=tnet, speculate_k=4),
                                           paged=False))
    assert TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4,
                   **_kw(sampling="temperature")).speculative
    with pytest.raises(ValueError):
        TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=4,
                **_kw(sampling=SamplingConfig(method="temperature",
                                              temperature=0.0)))
    short = tgpt2.GPT2Model(**dict(SMALL, max_length=32), device="cpu")
    with pytest.raises(ValueError, match="max_length"):
        TEngine(tnet, device="cpu", draft_net=short, speculate_k=4, **_kw())
    with pytest.raises(ValueError):
        TEngine(tnet, device="cpu", **_kw(num_pages=0))


def test_buckets_plus_two_programs_equal_jax(pair):
    jeng, teng = _engines(pair, draft="self")
    prompts = [_prompt(5, 200), _prompt(12, 201)]
    counts = []
    for eng in (jeng, teng):
        eng.generate(prompts, max_new_tokens=9)
        first = eng.compiled_programs
        eng.generate([_prompt(7, 202)], max_new_tokens=12)
        counts.append((first, eng.compiled_programs))
    used = {teng.bucket_for(len(p)) for p in prompts}
    assert counts[0] == counts[1] == (len(used) + 2, len(used) + 2)
    assert teng._signatures == {("prefill", 8), ("prefill", 16),
                                ("draft", 3, 4), ("verify", 3, 4)}


def test_decode_step_refused_on_spec_engine(pair):
    _, tnet = pair
    eng = TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=2, **_kw())
    with pytest.raises(RuntimeError):
        eng.decode_step()
    with pytest.raises(RuntimeError):
        TEngine(tnet, device="cpu", **_kw()).spec_step()


def test_plain_step_on_spec_engine_equals_greedy(pair):
    """The fallback decode program of a speculative engine: greedy tokens
    of plain decode, one more program."""
    jnet, tnet = pair
    p = _prompt(9, 220)
    ref = JEngine(jnet, **_kw(batch_size=1)).generate([p], max_new_tokens=6)
    eng = TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=2,
                  **_kw(batch_size=1))
    got = [eng.prefill(p, 0)] + [int(eng.plain_step()[0][0])
                                 for _ in range(5)]
    assert [got] == ref
    assert ("decode", 1, "paged") in eng._signatures


def test_stochastic_spec_needs_positive_temperature(pair):
    _, tnet = pair
    with pytest.raises(ValueError):
        TEngine(tnet, device="cpu", draft_net=tnet, speculate_k=3,
                **_kw(sampling=SamplingConfig(method="temperature",
                                              temperature=0.0)))


def test_rejection_sampling_first_token_marginal(pair, draft_pair):
    """The first token a sampled speculative round emits is distributed as
    plain sampled decode's for the same context (the gate of
    tests/test_prefix_sharing.py: 300 trials of 3 rows, top-k 8, a draft
    of perturbed weights so that q != p and the accept/residual rule carries
    the correction)."""
    _, tnet = pair
    sampling = SamplingConfig(method="top_k", top_k=8, temperature=1.0)
    L, fix, trials = 6, 5, 300
    prompt = _prompt(L, 460)

    def marginal(eng):
        for s in range(eng.batch_size):
            eng.prefill(prompt, s)
        counts = np.zeros(VOCAB)
        for _ in range(trials):
            # rewind to the same frontier: every round is an iid draw from
            # the conditional at position L
            eng.positions[:] = L
            eng.last_tokens[:] = fix
            eng.done[:] = False
            if eng.speculative:
                toks, m, _ = eng.spec_step()
                assert (m >= 1).all()
                np.add.at(counts, toks[:, 0], 1)
            else:
                tok, _, _ = eng.decode_step()
                np.add.at(counts, tok, 1)
        return counts / counts.sum()

    plain = TEngine(tnet, device="cpu", **_kw(eos_id=None, sampling=sampling))
    spec = TEngine(tnet, device="cpu", draft_net=draft_pair[1], speculate_k=3,
                   **_kw(eos_id=None, sampling=sampling))
    p_hat, s_hat = marginal(plain), marginal(spec)
    tv = 0.5 * np.abs(p_hat - s_hat).sum()
    assert tv < 0.15, f"total variation {tv:.3f} vs plain decode"
    assert (p_hat > 0).sum() <= 8 and (s_hat > 0).sum() <= 8


def test_stochastic_spec_engine_is_seeded(pair, draft_pair):
    """Two engines from one seed draw the same sampled rounds; every active
    row emits at least one token a round."""
    _, tnet = pair
    kw = _kw(sampling=SamplingConfig(method="top_k", top_k=8, seed=3))
    outs = []
    for _ in range(2):
        eng = TEngine(tnet, device="cpu", draft_net=draft_pair[1],
                      speculate_k=3, **kw)
        for i, p in enumerate(PROMPTS):
            eng.prefill(p, i)
        rounds = []
        for _ in range(4):
            active = ~eng.done
            toks, m, _ = eng.spec_step()
            assert (m[active] >= 1).all()
            rounds.append((toks.tolist(), m.tolist()))
        outs.append(rounds)
    assert outs[0] == outs[1]

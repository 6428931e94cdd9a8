"""The port's copy-on-write forks against the JAX package's, on the same
scripted sequences and with the same weights:

- CoW isolation: rows forked onto shared pages and forced onto divergent
  suffixes give the tokens of rows that share nothing, and JAX's; the
  first write into a shared page copies it, so the source's pages keep
  their contents;
- ``submit(..., samples=N)``: the leader prefills once and N - 1 siblings
  are admitted by fork; greedy groups give JAX's outputs and allocator
  state, sampled ones diverge and are seeded;
- ``cache_sequence`` indexes a live row's pages as JAX's does;
- releasing a fork mid-decode frees only its refcount-0 pages and leaves
  the survivor's stream untouched;
- the copy-on-write program is one ``("cow", W)`` program, and "graph"
  and "naive" serve forks identically."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
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


def _kw(**kw):
    kw.setdefault("batch_size", 3)
    kw.setdefault("prefill_buckets", (8, 16))
    kw.setdefault("eos_id", None)
    kw.setdefault("pad_id", PAD)
    kw.setdefault("page_size", 8)
    kw.setdefault("paged", True)
    return kw


def _engines(pair, **kw):
    jnet, tnet = pair
    return (JEngine(jnet, **_kw(**kw)),
            TEngine(tnet, device="cpu", **_kw(**kw)))


def _prompt(n, seed):
    return list(np.random.RandomState(seed).randint(1, EOS, n))


def _alloc_state(eng):
    """The allocator as numbers: refcounts, free list, row pages."""
    return (np.asarray(eng._page_rc).tolist(), list(eng._free_pages),
            [list(r) for r in eng._row_pages])


def _page_contents(eng, pages):
    """Copies of the target pools' layer-0 K and V of ``pages``."""
    k_pool, v_pool = eng.pools[0]
    idx = torch.tensor(pages)
    return k_pool[idx].clone(), v_pool[idx].clone()


def test_divergent_forks_match_isolated_rows_and_jax(pair):
    """Rows 0 and 1 share every prompt page by a fork, then decode
    different suffixes: both streams equal those of rows that never shared
    a page, and JAX's; the source's pages keep their contents, and the
    fork's writes went to private copies."""
    engs = _engines(pair, prefix_cache=True)
    ref = TEngine(pair[1], device="cpu", **_kw())  # paged, no sharing
    p = _prompt(12, 410)
    streams = []
    for eng in engs:
        t0 = eng.prefill(p, slot=0)
        assert eng.fork_slot(0, 1) == t0
        eng.last_tokens[1] = alt = (t0 + 1) % VOCAB  # force divergence
        if isinstance(eng, TEngine):
            shared = list(eng._row_pages[0])
            before = _page_contents(eng, shared)
        got = [[t0], [alt]]
        for _ in range(6):
            tok, _, _ = eng.decode_step()
            got[0].append(int(tok[0]))
            got[1].append(int(tok[1]))
        streams.append(got)
    assert streams[0] == streams[1]
    assert _alloc_state(engs[1]) == _alloc_state(engs[0])
    want = [[ref.prefill(p, 0)], [ref.prefill(p, 1)]]
    ref.last_tokens[1] = want[1][0] = alt
    for _ in range(6):
        tok, _, _ = ref.decode_step()
        want[0].append(int(tok[0]))
        want[1].append(int(tok[1]))
    assert streams[1] == want
    assert want[1][1:] != want[0][1:]  # the suffixes really diverged
    teng = engs[1]
    # the partly filled prompt page was copied for the row that wrote
    # first (row 0, the lower row): row 1 kept the original
    assert teng._row_pages[0][0] == teng._row_pages[1][0] == shared[0]
    assert teng._row_pages[0][1] != shared[1] == teng._row_pages[1][1]
    k0, v0 = before
    k1, v1 = _page_contents(teng, shared)
    # the shared full page is untouched; the copied page's prompt
    # positions (8..11) too: row 1 wrote only past them
    assert torch.equal(k1[0], k0[0]) and torch.equal(v1[0], v0[0])
    assert torch.equal(k1[1, :, :4], k0[1, :, :4])
    assert ("cow", 3) in teng._signatures


def test_fork_inside_the_first_page_is_isolated(pair):
    """A fork of a 5-token prompt: the first write copies the rows' shared
    first page, whose table entry is (row 0, slot 0), the entry the
    copy-on-write program's padding entries would name too. Both streams
    equal those of rows that share nothing, and the device tables name the
    allocator's pages. (The JAX engine's program writes its padding
    entries into (0, 0) of the table as well, and there its device table
    keeps the shared page: ROADMAP.md, queue 3.)"""
    _, tnet = pair
    p, alt = _prompt(5, 516), 78
    streams = []
    for fork in (True, False):
        eng = TEngine(tnet, device="cpu", **_kw())
        eng.prefill(p, 0)
        if fork:
            eng.fork_slot(0, 1)
        else:
            eng.prefill(p, 1)
        eng.last_tokens[1] = alt
        got = [[], []]
        for _ in range(6):
            tok, _, _ = eng.decode_step()
            got[0].append(int(tok[0]))
            got[1].append(int(tok[1]))
        streams.append(got)
        for row in (0, 1):
            pages = eng._row_pages[row]
            assert eng.page_table[row, :len(pages)].tolist() == pages
    assert streams[0] == streams[1]
    assert streams[1][0] != streams[1][1]


def test_fork_cancel_reclaims_only_rc0_pages(pair):
    """A fork released mid-decode returns only its private pages; the
    survivor's stream equals a solo run's, and JAX's allocator agrees."""
    p = _prompt(12, 470)
    solo = TEngine(pair[1], device="cpu", **_kw(batch_size=1))
    want = [solo.prefill(p, 0)] + [int(solo.decode_step()[0][0])
                                   for _ in range(8)]
    engs = _engines(pair, prefix_cache=True)
    streams = []
    for eng in engs:
        got = [eng.prefill(p, slot=0)]
        eng.fork_slot(0, 1)
        a = eng._row_pages[0][0]  # first prompt page: shared and cached
        for i in range(8):
            tok, _, _ = eng.decode_step()
            got.append(int(tok[0]))
            if i == 2:
                free0 = eng.free_pages
                fork_only = [pid for pid in eng._row_pages[1]
                             if eng._page_rc[pid] == 1]
                eng.release_slot(1)
                assert eng.free_pages == free0 + len(fork_only)
                assert eng._page_rc[a] == 2  # row 0 + the prefix cache
        streams.append(got)
    assert streams[0] == streams[1] == want
    assert _alloc_state(engs[1]) == _alloc_state(engs[0])


def test_fork_slot_error_paths(pair):
    _, tnet = pair
    dense = TEngine(tnet, device="cpu", **_kw(paged=False, batch_size=2))
    with pytest.raises(RuntimeError):
        dense.fork_slot(0, 1)
    eng = TEngine(tnet, device="cpu", **_kw())
    with pytest.raises(ValueError):
        eng.fork_slot(0, 0)
    with pytest.raises(RuntimeError):
        eng.fork_slot(0, 1)  # empty source row
    eng.prefill(_prompt(5, 411), 0)
    eng.release_slot(0)
    with pytest.raises(RuntimeError):
        eng.fork_slot(0, 1)  # finished source row


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_greedy_samples_equal_jax(pair, prefix_cache):
    """``samples=3`` under greedy sampling: every sibling repeats the
    leader's stream; outputs, fork flags and the final allocator are
    JAX's, and every page comes back."""
    jnet, tnet = pair
    kw = _kw(prefix_cache=prefix_cache)
    res = []
    for bat in (JBatcher(JEngine(jnet, **kw)),
                TBatcher(TEngine(tnet, device="cpu", **kw), device="cpu")):
        leader = bat.submit(_prompt(10, 440), max_new_tokens=6, samples=3)
        other = bat.submit(_prompt(6, 441), max_new_tokens=4)
        (getattr(bat, "run_until_idle", None) or bat.run)(max_steps=100)
        assert len(leader.samples) == 3 and leader.samples[0] is leader
        res.append(([r.result() for r in leader.samples + [other]],
                    [r.forked for r in leader.samples],
                    _alloc_state(bat.engine)))
    assert res[0] == res[1]
    outs, forked, _ = res[1]
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 6
    assert forked == [False, True, True]


def test_sampled_forks_diverge_and_are_seeded(pair):
    """``samples=3`` under temperature sampling: each sibling draws its
    own first token from the leader's prefill logits and its own stream;
    two engines from one seed draw the same."""
    _, tnet = pair
    outs = []
    for _ in range(2):
        eng = TEngine(tnet, device="cpu", **_kw(
            prefix_cache=True, sampling=SamplingConfig(method="temperature",
                                                       seed=4)))
        bat = TBatcher(eng, device="cpu")
        leader = bat.submit(_prompt(10, 440), max_new_tokens=6, samples=3)
        bat.run(max_steps=200)
        got = [r.result() for r in leader.samples]
        assert all(len(o) == 6 for o in got)
        assert [r.forked for r in leader.samples] == [False, True, True]
        assert eng.free_pages + len(eng.prefix_cache) == eng.num_pages
        outs.append(got)
    assert outs[0] == outs[1]
    assert len({tuple(o) for o in outs[0]}) >= 2  # the samples diverged


def test_sibling_without_leader_falls_back_to_prefill(pair):
    """A sibling that finds no free slot while its leader lives is admitted
    later by an ordinary prefill; the group still gives JAX's outputs."""
    jnet, tnet = pair
    kw = _kw(batch_size=2)
    res = []
    for bat in (JBatcher(JEngine(jnet, **kw)),
                TBatcher(TEngine(tnet, device="cpu", **kw), device="cpu")):
        leader = bat.submit(_prompt(9, 442), max_new_tokens=3, samples=3)
        (getattr(bat, "run_until_idle", None) or bat.run)(max_steps=100)
        res.append(([r.result() for r in leader.samples],
                    [r.forked for r in leader.samples]))
    assert res[0] == res[1]
    assert res[1][1] == [False, True, False]


def test_cache_sequence_equals_jax(pair):
    """A live row's prompt and output indexed mid-decode: the tokens now
    served from cache, the cached pages and the refcounts are JAX's; a
    row shorter than a page indexes nothing."""
    engs = _engines(pair, prefix_cache=True)
    p = _prompt(6, 460)
    outs = []
    for eng in engs:
        toks = [eng.prefill(p, 0)]
        toks += [int(eng.decode_step()[0][0]) for _ in range(11)]
        n = eng.cache_sequence(0, p + toks)
        short = eng.cache_sequence(1, p)  # an empty row
        outs.append((toks, n, short, sorted(eng.prefix_cache.pages()),
                     _alloc_state(eng)))
    assert outs[0] == outs[1]
    assert outs[1][1] == 16 and outs[1][2] == 0


@pytest.mark.parametrize("mode", ["graph", "naive"])
def test_cow_is_one_program(pair, mode):
    """Two fork groups admitted at two boundaries: two copy-on-write calls,
    one ``("cow", 3)`` program; the count equals JAX's."""
    jnet, tnet = pair
    counts = []
    for eng in (JEngine(jnet, **_kw()),
                TEngine(tnet, device="cpu", engine_type=mode, **_kw())):
        bat = TBatcher(eng, device="cpu") if isinstance(eng, TEngine) \
            else JBatcher(eng)
        run = getattr(bat, "run_until_idle", None) or bat.run
        bat.submit(_prompt(12, 490), max_new_tokens=4, samples=3)
        run(max_steps=100)
        bat.submit(_prompt(13, 491), max_new_tokens=4, samples=3)
        run(max_steps=100)
        counts.append(eng.compiled_programs)
    assert counts[0] == counts[1] == 3  # prefill 16, decode, cow
    cow = [p for (sig, _), p in eng._programs.items() if sig[0] == "cow"]
    assert len(cow) == 1 and cow[0].calls == 2
    assert eng.free_pages == eng.num_pages


def test_forks_graph_equals_naive(pair):
    """Top-k sampled fork groups served under "graph" and "naive" draw the
    same tokens from the same seed."""
    _, tnet = pair
    outs = {}
    for mode in ("graph", "naive"):
        eng = TEngine(tnet, device="cpu", engine_type=mode, **_kw(
            batch_size=4, sampling=SamplingConfig(method="top_k", top_k=8,
                                                  seed=5)))
        bat = TBatcher(eng, device="cpu")
        hs = [bat.submit(_prompt(11, 495 + i), max_new_tokens=5, samples=2)
              for i in range(2)]
        bat.run(max_steps=100)
        outs[mode] = [r.result() for h in hs for r in h.samples]
    assert outs["graph"] == outs["naive"]

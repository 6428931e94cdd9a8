"""The port's prefix sharing against the JAX package's, on the same scripted
sequences and with the same weights:

- ``RadixPrefixCache`` (the port's own copy): ``lookup``/``insert``/
  ``evict``/``collectable``/``pages``/``clear`` give the JAX cache's
  results, call by call;
- the page refcount lifecycle (prefill with a cache insert, fork, release,
  eviction) ends with the JAX engine's refcounts and free-page counts;
- prefix adoption: the adopted pages, the tokens (cold, hit and no-cache
  runs equal), suffix pricing, ``can_admit``, page-bounded admission
  through the batcher, and a prompt longer than every bucket admitted on
  its cached history;
- program counts: a hit adds no program, and the copy-on-write program of
  a partially adopted tail page is one ``("cow", W)`` program."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.inference import RadixPrefixCache as JCache
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.inference import RadixPrefixCache as TCache
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


def _make_pair():
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


@pytest.fixture(scope="module")
def pair():
    return _make_pair()


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


# ---------------------------------------------------------------------------
# the radix tree, call by call against the JAX cache
# ---------------------------------------------------------------------------
def _random_script(seed, ps=4, n=40):
    """The sequence of tests/test_prefix_sharing.py's random-model test:
    inserts of fresh and perturbed sequences, then lookups, an eviction
    cascade and a clear."""
    rs = np.random.RandomState(seed)
    ops, seqs, next_page = [], [], 1
    for _ in range(n):
        if seqs and rs.rand() < 0.5:
            base = seqs[rs.randint(len(seqs))]
            seq = (base[:rs.randint(len(base) + 1)]
                   + list(rs.randint(0, 5, rs.randint(0, 12))))
        else:
            seq = list(rs.randint(0, 5, rs.randint(0, 16)))
        seqs.append(seq)
        pages = list(range(next_page, next_page + len(seq) // ps))
        next_page += len(pages)
        ops.append(("insert", seq, pages))
        if rs.rand() < 0.3:
            ops.append(("lookup", seqs[rs.randint(len(seqs))], True))
    ops += [("lookup", s, False) for s in seqs]
    ops += [("lookup", list(rs.randint(0, 5, 10)), True) for _ in range(20)]
    ops += [("collectable", "odd", ()), ("collectable", "all", (1, 2)),
            ("evict", 5, "odd", ()), ("evict", 3, "all", (4,)),
            ("collectable", "all", ()), ("pages",), ("len",),
            ("evict", 1000, "all", ()), ("pages",), ("clear",)]
    return ps, ops


SCRIPTS = {
    # (page size, ops) of tests/test_prefix_sharing.py's TestRadixCache
    "full_pages_only": (4, [("insert", [1, 2, 3], [7]), ("len",),
                            ("insert", [1, 2, 3, 4, 5], [7, 8]),
                            ("lookup", [1, 2, 3, 4, 5, 6], True),
                            ("lookup", [1, 2, 3], True)]),
    "first_writer_wins": (2, [("insert", [1, 2, 3, 4], [10, 11]),
                              ("insert", [1, 2, 5, 6], [90, 12]),
                              ("lookup", [1, 2, 3, 4], True),
                              ("lookup", [1, 2, 5, 6], True), ("pages",)]),
    "longest_prefix": (2, [("insert", [1, 2, 3, 4, 5, 6], [1, 2, 3]),
                           ("lookup", [1, 2, 3, 4, 9, 9, 9, 9], True)]),
    "lru_cascade": (4, [("insert", list(range(8)), [1, 2]),
                        ("insert", list(range(4)) + [9] * 4, [1, 3]),
                        ("lookup", list(range(8)), True),
                        ("evict", 1, "all", ()), ("evict", 2, "all", ()),
                        ("len",), ("pages",)]),
    "predicate_protect": (4, [("insert", list(range(8)), [1, 2]),
                              ("evict", 2, "none", ()),
                              ("evict", 2, "all", (2,)),
                              ("evict", 2, "not1", ()), ("pages",)]),
    "collectable": (4, [("insert", list(range(8)), [1, 2]),
                        ("insert", list(range(4)) + [9] * 4, [1, 3]),
                        ("collectable", "all", ()),
                        ("collectable", "not1", ()),
                        ("collectable", "all", (2,)), ("len",)]),
    "random_0": _random_script(0),
    "random_1": _random_script(1, ps=3),
}

PREDICATES = {"all": lambda p: True, "none": lambda p: False,
              "not1": lambda p: p != 1, "odd": lambda p: p % 2 == 1}


def _apply(cache, op):
    name, args = op[0], op[1:]
    if name == "insert":
        return cache.insert(*args)
    if name == "lookup":
        return cache.lookup(args[0], touch=args[1])
    if name == "evict":
        n, pred, protect = args
        return cache.evict(n, PREDICATES[pred], protect=protect)
    if name == "collectable":
        pred, protect = args
        return cache.collectable(PREDICATES[pred], protect=protect)
    if name == "pages":
        return sorted(cache.pages())
    if name == "len":
        return len(cache)
    return sorted(cache.clear())


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_radix_cache_equals_jax(script):
    ps, ops = SCRIPTS[script]
    jc, tc = JCache(ps), TCache(ps)
    for op in ops:
        assert _apply(tc, op) == _apply(jc, op), op
    assert sorted(tc.pages()) == sorted(jc.pages())


def test_radix_cache_semantics():
    """The expectations of tests/test_prefix_sharing.py, on the port's
    cache alone."""
    c = TCache(4)
    assert c.insert([1, 2, 3], [7]) == [] and len(c) == 0
    assert c.insert([1, 2, 3, 4, 5], [7, 8]) == [7]
    assert c.lookup([1, 2, 3, 4, 5, 6]) == ([7], 4)
    c = TCache(4)
    c.insert(list(range(8)), [1, 2])
    c.insert(list(range(4)) + [9] * 4, [1, 3])
    assert c.collectable(lambda p: True) == 3
    c.lookup(list(range(8)))  # leaf 2 is the most recent
    assert c.evict(1, lambda p: True) == [3]
    assert c.evict(2, lambda p: True) == [2, 1]  # the parent follows
    assert len(c) == 0 and c.pages() == []
    with pytest.raises(ValueError):
        TCache(0)


# ---------------------------------------------------------------------------
# refcount lifecycle
# ---------------------------------------------------------------------------
def test_refcount_lifecycle_equals_jax(pair):
    """prefill (+ cache insert) / fork / release / release / evict: each
    moves a page by one reference, only refcount-0 pages go back, and the
    allocator matches JAX's after every call."""
    engs = _engines(pair, prefix_cache=True)
    p = _prompt(16, 400)
    for eng in engs:
        eng.prefill(p, slot=0)
    a, b = engs[1]._row_pages[0]
    script = [lambda e: e.fork_slot(0, 1), lambda e: e.release_slot(0),
              lambda e: e.release_slot(1), lambda e: e._evict_prefix(2)]
    rcs = []
    for step in [None] + script:
        outs = [None if step is None else step(e) for e in engs]
        assert outs[0] == outs[1]
        assert _alloc_state(engs[1]) == _alloc_state(engs[0])
        rcs.append((int(engs[1]._page_rc[a]), int(engs[1]._page_rc[b])))
    # row + cache, + the fork, - row 0, - row 1 (cache only), evicted
    assert rcs == [(2, 2), (3, 3), (2, 2), (1, 1), (0, 0)]
    assert engs[1].free_pages == engs[1].num_pages


def test_eviction_refuses_row_backed_pages(pair):
    engs = _engines(pair, prefix_cache=True)
    for eng in engs:
        eng.prefill(_prompt(16, 401), slot=0)
    assert [e._evict_prefix(2) for e in engs] == [0, 0]  # a row reads them
    assert len(engs[1].prefix_cache) == 2
    for eng in engs:
        eng.release_slot(0)
    assert [e._evict_prefix(2) for e in engs] == [2, 2]
    assert _alloc_state(engs[1]) == _alloc_state(engs[0])


# ---------------------------------------------------------------------------
# prefix adoption
# ---------------------------------------------------------------------------
def test_cold_hit_and_no_cache_tokens_equal_jax(pair):
    """A cold prefill, a full hit (adopting a page) and a partial hit give
    the tokens of an engine without a cache, and of JAX's; the adopted
    pages are JAX's."""
    jeng, teng = _engines(pair, prefix_cache=True, batch_size=2)
    plain = TEngine(pair[1], device="cpu", **_kw(batch_size=2))
    p = _prompt(14, 420)
    q = p[:8] + _prompt(6, 421)  # shares only the first full page
    seen = set()
    for prompt in (p, p, q):
        want = plain.generate([prompt], max_new_tokens=6)
        got = teng.generate([prompt], max_new_tokens=6)
        assert got == want == jeng.generate([prompt], max_new_tokens=6)
        assert _alloc_state(teng) == _alloc_state(jeng)
        seen.update(got[0])
    assert len(seen) > 2


def test_adopted_pages_and_tail_copy_equal_jax(pair):
    """A fully cached, page-aligned prompt re-serves from its last token:
    the row adopts the first page and copies the second (the tail), and
    its tokens equal the cold run's and JAX's."""
    jeng, teng = _engines(pair, prefix_cache=True, batch_size=2)
    p = _prompt(16, 425)

    def serve(eng):
        out = [eng.prefill(p, 0)]
        pages = list(eng._row_pages[0])
        out += [int(eng.decode_step()[0][0]) for _ in range(4)]
        eng.release_slot(0)
        return out, pages

    (cold, cached), (jcold, _) = serve(teng), serve(jeng)
    assert teng.suffix_for(p) == 1 and teng.pages_needed(p) == 1
    (hit, pages), (jhit, _) = serve(teng), serve(jeng)
    assert cold == jcold == hit == jhit
    assert len(set(cold)) > 2
    assert pages[0] == cached[0]  # adopted
    assert pages[1] != cached[1]  # the copied tail
    assert _alloc_state(teng) == _alloc_state(jeng)
    assert ("cow", 2) in teng._signatures


def test_suffix_pricing_and_can_admit(pair):
    _, teng = _engines(pair, prefix_cache=True)
    p = _prompt(16, 422)
    assert teng.pages_needed(p) == 2 and teng.suffix_for(p) == 16
    teng.prefill(p, slot=0)
    teng.release_slot(0)
    assert teng.suffix_for(p) == 1  # fully cached: re-read the last token
    assert teng.pages_needed(p) == 1  # only the tail copy
    long = p + _prompt(9, 423)  # 25 > largest bucket 16
    assert teng.can_admit(long)  # suffix 9 fits bucket 16
    assert not TEngine(pair[1], device="cpu", **_kw()).can_admit(long)
    assert teng.available_pages == teng.num_pages  # cache-only: evictable


def test_cached_prompt_admits_through_a_tight_pool(pair):
    """Suffix pricing: a cached re-serve is charged one page, so it admits
    beside a holder in a 5-page pool and re-serves the cold tokens, as in
    JAX."""
    jnet, tnet = pair
    p, holder = _prompt(16, 430), _prompt(10, 431)
    outs = []
    for eng, bat in ((j := JEngine(jnet, **_kw(prefix_cache=True,
                                               num_pages=5)), JBatcher(j)),
                     (t := TEngine(tnet, device="cpu",
                                   **_kw(prefix_cache=True, num_pages=5)),
                      TBatcher(t, device="cpu"))):
        run = getattr(bat, "run_until_idle", None) or bat.run
        first = bat.submit(p, max_new_tokens=2)
        run(max_steps=100)
        assert len(eng.prefix_cache) == 2  # prompt + output full pages
        reqs = [bat.submit(holder, max_new_tokens=5),
                bat.submit(p, max_new_tokens=2)]
        bat.step()
        # no deferral: both admitted at the first boundary
        assert [len(r.output) for r in reqs] == [2, 2]
        run(max_steps=100)
        outs.append([(r.output, r.finish_reason) for r in [first] + reqs])
    assert outs[0] == outs[1]
    assert outs[1][2][0] == outs[1][0][0]


def test_page_bounded_admission_equals_jax(pair):
    """A 5-page pool under 3 slots: the head parks on pages, a smaller
    request bypasses it, the aging guard reserves freed pages for it, a
    row runs out of pages; admission order, reservations, tokens and
    finish reasons are JAX's."""
    jnet, tnet = pair
    reqs = [(_prompt(n, 100 + i), b) for i, (n, b) in enumerate(
        [(3, 8), (3, 9), (9, 13), (11, 4), (11, 13), (5, 2)])]
    kw = _kw(batch_size=3, num_pages=5)
    res = []
    for bat in (JBatcher(JEngine(jnet, **kw), head_aging_steps=2),
                TBatcher(TEngine(tnet, device="cpu", **kw), device="cpu",
                         head_aging_steps=2)):
        eng, reserved = bat.engine, []
        reserve = eng.reserve_pages
        eng.reserve_pages = lambda n: (reserved.append(n), reserve(n))
        hs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
        order = []
        while bat.step():
            order += [h.id for h in hs
                      if h.slot is not None and h.id not in order]
        res.append(([(h.output, h.finish_reason) for h in hs], order,
                    [n for n in reserved if n]))
        assert eng.free_pages == eng.num_pages
    assert res[0] == res[1]
    outs, order, reserved = res[1]
    assert order == [0, 1, 2, 5, 3, 4]  # 5 went past the parked head 3
    assert reserved == [2]  # the aging guard held pages for the head
    assert [r for _, r in outs].count("page_exhausted") == 1


def test_session_resume_past_largest_bucket(pair):
    """A finished turn's pages are indexed (``cache_sequence``); the next
    turn, longer than every bucket, admits on its cached history and gives
    the tokens of an engine with a bucket large enough, and of JAX's."""
    jnet, tnet = pair
    turn1 = _prompt(12, 450)
    outs = []
    for eng in (JEngine(jnet, **_kw(prefix_cache=True, batch_size=2)),
                TEngine(tnet, device="cpu",
                        **_kw(prefix_cache=True, batch_size=2))):
        bat = TBatcher(eng, device="cpu") if isinstance(eng, TEngine) \
            else JBatcher(eng)
        run = getattr(bat, "run_until_idle", None) or bat.run
        r1 = bat.submit(turn1, max_new_tokens=8)
        run(max_steps=100)
        resume = turn1 + r1.result() + _prompt(5, 451)  # 25 > bucket 16
        r2 = bat.submit(resume, max_new_tokens=4)
        run(max_steps=100)
        outs.append((r1.result(), r2.result()))
    big = TEngine(tnet, device="cpu",
                  **_kw(batch_size=2, prefill_buckets=(8, 16, 32)))
    assert outs[0] == outs[1]
    assert outs[1][1] == big.generate([resume], max_new_tokens=4)[0]


def test_evicted_prefix_sheds_the_parked_head(pair):
    """A prompt admitted past the bucket check on a cached history whose
    pages were evicted while it queued finishes as "shed"."""
    _, tnet = pair
    eng = TEngine(tnet, device="cpu", **_kw(prefix_cache=True,
                                            batch_size=1))
    bat = TBatcher(eng, device="cpu")
    turn1 = _prompt(12, 452)
    r1 = bat.submit(turn1, max_new_tokens=8)
    bat.run()
    resume = turn1 + r1.result() + _prompt(5, 453)
    r2 = bat.submit(resume, max_new_tokens=2)
    eng._evict_prefix(eng.num_pages)
    bat.run()
    assert r2.finish_reason == "shed" and r2.output == []
    with pytest.raises(ValueError):  # and no cache: refused at submit
        bat.submit(resume, max_new_tokens=2)


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["graph", "naive"])
def test_hit_adds_no_program_and_cow_is_one(pair, mode):
    """prefill16 + decode, then the bucket-8 suffix + the copy-on-write
    program; flat under more traffic, and equal to JAX's count."""
    jnet, tnet = pair
    jeng = JEngine(jnet, **_kw(prefix_cache=True, batch_size=2))
    teng = TEngine(tnet, device="cpu", engine_type=mode,
                   **_kw(prefix_cache=True, batch_size=2))
    p = _prompt(16, 480)
    counts = []
    for eng in (jeng, teng):
        eng.generate([p], max_new_tokens=4)
        eng.generate([p], max_new_tokens=4)
        n = eng.compiled_programs
        eng.generate([p], max_new_tokens=4)
        eng.generate([p[:8] + _prompt(6, 481)], max_new_tokens=4)
        counts.append((n, eng.compiled_programs))
    assert counts[0] == counts[1] == (4, 4)
    assert teng._signatures == {("prefill", 16), ("prefill", 8),
                                ("decode", 2, "paged"), ("cow", 2)}
    assert {sig for sig, _ in teng._programs} == teng._signatures

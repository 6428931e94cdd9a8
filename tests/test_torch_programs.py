"""The port's step programs (``engine_type="graph"``: one captured CUDA graph
per step signature, replayed from static buffers) against the JAX package's
compiled step programs, on the CPU. Nothing is captured here: a "graph"
step is a plain call over the same static buffers and the same program
bookkeeping as on the card, so these tests hold the static-buffer path and
the program counts; ``chip_smoke.py`` holds the captured graphs.

- ``compiled_programs`` equals the JAX engine's on the traffic of
  ``tests/test_inference.py`` (dense) and ``tests/test_paged_inference.py``
  (paged), and stays flat under more traffic;
- greedy tokens and per-step paged logits under "graph" and "naive" match
  JAX (tokens exactly, logits at 1e-4), with prefills into different slots
  at one bucket, and the two modes agree bit for bit;
- a scheduled-rate TrainStep matches JAX through the static rate buffers;
- a loss or decode logits held across the next step keep their values;
- a parameter given new storage is recaptured and counted;
- the ``engine_type`` knob, its ``MXNET_ENGINE_TYPE`` alias and its
  refusals."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jls
from mxnet_tpu import nd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import lr_scheduler as tls
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.ops import cuda_graph as tcg
from mxnet_tpu_torch.parallel import TrainStep

VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)
MODES = ["graph", "naive"]


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


def _jax_net():
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    return jnet


@pytest.fixture(scope="module")
def pair():
    jnet = _jax_net()
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


def _traffic(eng, batcher_cls, **batcher_kw):
    """The traffic of the JAX program-count tests: three prompts over two
    buckets, two more, then five requests through a batcher. Returns the
    program count after each of the three."""
    counts = []
    eng.generate([_prompt(5, 100), _prompt(12, 101), _prompt(3, 102)],
                 max_new_tokens=9)
    counts.append(eng.compiled_programs)
    eng.generate([_prompt(7, 103), _prompt(15, 104)], max_new_tokens=11)
    counts.append(eng.compiled_programs)
    bat = batcher_cls(eng, **batcher_kw)
    for i in range(5):
        bat.submit(_prompt(2 + i, 110 + i), max_new_tokens=6)
    if hasattr(bat, "run_until_idle"):
        bat.run_until_idle(max_steps=200)
    else:
        bat.run()
    counts.append(eng.compiled_programs)
    return counts


@pytest.fixture(scope="module")
def jax_counts(pair):
    jnet, _ = pair
    return {paged: _traffic(JEngine(jnet, **_kw(paged)), JBatcher)
            for paged in (False, True)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_compiled_programs_equal_jax_and_stay_flat(pair, jax_counts, paged,
                                                   mode):
    _, tnet = pair
    eng = TEngine(tnet, device="cpu", engine_type=mode, **_kw(paged))
    got = _traffic(eng, TBatcher, device="cpu")
    # buckets 8 and 16 in the first round, then nothing new: 2 + 1, flat
    assert got == jax_counts[paged] == [3, 3, 3]
    want = {("prefill", 8), ("prefill", 16),
            ("decode", 3) + (("paged",) if paged else ())}
    assert eng._signatures == want
    # one program per signature under either engine type ("naive" runs
    # the same program uncaptured); the CPU never captures
    assert {sig for sig, _ in eng._programs} == want
    assert not any(p.capture for p in eng._programs.values())


def _run_engine(eng, prompts, steps):
    """Prefill ``prompts`` into slots 0.. (several at one bucket), then
    ``steps`` decode steps; the first tokens, the prefill logits, and per
    step the tokens, done flags and a held reference to the logits."""
    first = [eng.prefill(p, i) for i, p in enumerate(prompts)]
    last = eng._last_logits
    held = [eng.decode_step() for _ in range(steps)]
    return first, last, held


# slots 0 and 1 share bucket 8, slot 2 takes bucket 16
SLOT_PROMPTS = [_prompt(5, 10), _prompt(7, 11), _prompt(12, 12)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_and_naive_match_jax_and_each_other(pair, paged):
    jnet, tnet = pair
    kw = _kw(paged, eos_id=None)
    jeng = JEngine(jnet, **kw)
    jfirst = [jeng.prefill(p, i) for i, p in enumerate(SLOT_PROMPTS)]
    jsteps = [jeng.decode_step() for _ in range(8)]
    runs = {mode: _run_engine(TEngine(tnet, device="cpu", engine_type=mode,
                                      **kw), SLOT_PROMPTS, 8)
            for mode in MODES}
    for mode, (first, _, held) in runs.items():
        assert first == jfirst, mode
        for (tt, td, tl), (jt, jd, jl) in zip(held, jsteps):
            np.testing.assert_array_equal(tt, np.asarray(jt))
            np.testing.assert_array_equal(td, np.asarray(jd))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
    (gf, gl, gh), (nf, nl, nh) = runs["graph"], runs["naive"]
    assert gf == nf and torch.equal(gl, nl)
    for (gt, _, g_logits), (nt, _, n_logits) in zip(gh, nh):
        np.testing.assert_array_equal(gt, nt)
        assert torch.equal(g_logits, n_logits)  # held: not overwritten
    assert len({float(lg.sum()) for _, _, lg in gh}) == len(gh)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_greedy_tokens_identical_to_jax_with_slot_reuse(pair, paged):
    """Generation and the batcher (slots released and refilled at the same
    bucket) give the JAX tokens under "graph"."""
    jnet, tnet = pair
    kw = _kw(paged, batch_size=2)
    prompts = [_prompt(5, 20), _prompt(6, 21)]
    ref = JEngine(jnet, **kw).generate(prompts, max_new_tokens=10)
    eng = TEngine(tnet, device="cpu", engine_type="graph", **kw)
    assert eng.generate(prompts, max_new_tokens=10) == ref
    reqs = [(_prompt(4, 30 + i), 5 + i) for i in range(5)]
    jb, tb = JBatcher(JEngine(jnet, **kw)), TBatcher(eng, device="cpu")
    jh = [jb.submit(p, max_new_tokens=n) for p, n in reqs]
    th = [tb.submit(p, max_new_tokens=n) for p, n in reqs]
    jb.run_until_idle()
    tb.run()
    assert [h.output for h in th] == [h.output for h in jh]
    assert eng.compiled_programs == 2  # bucket 8 and the decode step


def test_stochastic_graph_engine_draws_as_naive(pair):
    """Sampling runs after the program, from the engine's own generator:
    the seeded top-k stream is the same under both modes."""
    _, tnet = pair
    kw = _kw(True, sampling="top_k")
    got = {mode: TEngine(tnet, device="cpu", engine_type=mode, **kw)
           .generate(SLOT_PROMPTS, max_new_tokens=8) for mode in MODES}
    assert got["graph"] == got["naive"]


@pytest.mark.parametrize("method", ["greedy", "top_k"])
def test_speculative_graph_equals_naive(pair, method):
    """A seeded speculative run through the batcher (a draft of other
    weights, so rounds accept partly) gives the same tokens under "graph"
    and "naive": a sampled round draws its noise before the programs run,
    from the engine's generator. The programs: buckets used + draft +
    verify, + the plain decode program when the batcher's speculation
    governor fell back (a windowed accept rate under its floor)."""
    from mxnet_tpu_torch.inference import SamplingConfig

    _, tnet = pair
    draft = tgpt2.GPT2Model(**SMALL, device="cpu", seed=3)
    sampling = SamplingConfig(method=method, top_k=8, seed=2)
    reqs = [(_prompt(4 + 3 * i, 300 + i), 4 + i) for i in range(5)]
    got = {}
    for mode in MODES:
        eng = TEngine(tnet, device="cpu", engine_type=mode, draft_net=draft,
                      speculate_k=3, sampling=sampling, **_kw(True))
        bat = TBatcher(eng, device="cpu")
        hs = [bat.submit(p, max_new_tokens=n) for p, n in reqs]
        bat.run()
        got[mode] = [(h.output, h.finish_reason) for h in hs]
        fallback = {("decode", 3, "paged")} if bat.governor.fallbacks \
            else set()
        assert eng._signatures == {("prefill", 8), ("prefill", 16),
                                   ("draft", 3, 3), ("verify", 3, 3)} | fallback
        assert {sig for sig, _ in eng._programs} == eng._signatures
    assert got["graph"] == got["naive"]
    assert all(len(out) == n for (out, _), (_, n) in zip(got["graph"], reqs))


SCHED = dict(max_update=10, warmup_steps=2, warmup_begin_lr=1e-4)


@pytest.fixture(scope="module")
def jax_scheduled():
    """Initial weights, and the JAX TrainStep's per-step losses and final
    weights over 3 Adam steps on a warm-up cosine schedule."""
    jnet = _jax_net()
    init = {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}
    ids = np.random.RandomState(0).randint(0, VOCAB, (2, 24)).astype(np.int32)
    labels = np.roll(ids, -1, 1)
    jts = JTrainStep(jnet, jgpt2.lm_loss, jopt.Adam(
        learning_rate=1e-3, lr_scheduler=jls.CosineScheduler(**SCHED)),
        mesh=None, amp=None)
    losses = [float(np.asarray(jts(nd.array(ids, dtype="int32"),
                                   nd.array(labels, dtype="int32"))))
              for _ in range(3)]
    jts.sync()
    final = {k: np.asarray(p.data().asnumpy())
             for k, p in jnet._collect_params_with_prefix().items()}
    return init, (ids, labels), losses, final


def _scheduled_step(init, mode):
    net = tgpt2.GPT2Model(**SMALL, device="cpu", seed=5)
    tser.load_mxnet_params(net, init)
    return net, TrainStep(net, tgpt2.lm_loss, topt.Adam(
        learning_rate=1e-3, lr_scheduler=tls.CosineScheduler(**SCHED)),
        amp=None, engine_type=mode)


@pytest.mark.parametrize("mode", MODES)
def test_scheduled_train_step_matches_jax(jax_scheduled, mode):
    """The rate moves every step; under "graph" it reaches the step through
    the static (N,) rate buffers. Losses to 1e-5 relative and the masters
    within the Adam bound of tests/test_torch_train_step.py."""
    init, (ids, labels), jl, jfinal = jax_scheduled
    net, ts = _scheduled_step(init, mode)
    held = [ts(ids, labels) for _ in range(3)]
    np.testing.assert_allclose([float(x) for x in held], jl, rtol=1e-5)
    assert ts.optimizer.num_update == 3 and int(ts.step_count) == 3
    assert ts.compiled_programs == 1  # "naive" runs it uncaptured
    final = tser.mxnet_params(net)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel() for k in jfinal])
    assert err.max() <= 2 * 1e-3 * 3


def test_held_losses_keep_their_values(jax_scheduled):
    """Losses returned by a "graph" TrainStep and kept across later steps
    equal the "naive" run's, step by step: a returned static output would
    make every held loss the last one."""
    init, (ids, labels), _, _ = jax_scheduled
    runs = {}
    for mode in MODES:
        _, ts = _scheduled_step(init, mode)
        runs[mode] = [ts(ids, labels) for _ in range(3)]
    assert [float(x) for x in runs["graph"]] == \
        [float(x) for x in runs["naive"]]
    assert len({float(x) for x in runs["graph"]}) == 3


def test_moved_parameter_is_recaptured_and_counted(jax_scheduled):
    init, (ids, labels), _, _ = jax_scheduled
    nets = {}
    for mode in MODES:
        net, ts = _scheduled_step(init, mode)
        ts(ids, labels)
        ts(ids, labels)
        with torch.no_grad():  # new storage, same values
            net.ln_f.gamma.data = net.ln_f.gamma.data.clone()
        losses = [float(ts(ids, labels)) for _ in range(2)]
        nets[mode] = (net, ts, losses)
    g_net, g_ts, g_losses = nets["graph"]
    n_net, n_ts, n_losses = nets["naive"]
    # either engine type drops the program built over the old storage
    assert g_ts.recaptures == 1 and g_ts.compiled_programs == 1
    assert n_ts.recaptures == 1 and n_ts.compiled_programs == 1
    assert g_losses == n_losses
    for (name, a), (_, b) in zip(sorted(g_net.named_parameters()),
                                 sorted(n_net.named_parameters())):
        assert torch.equal(a, b), name


def test_new_batch_shape_is_a_new_program():
    net = tgpt2.GPT2Model(num_layers=1, units=32, num_heads=2, max_length=16,
                          vocab_size=VOCAB, dropout=0.0, device="cpu", seed=1)
    ts = TrainStep(net, tgpt2.lm_loss, topt.Adam(learning_rate=1e-2),
                   engine_type="graph")
    ids = np.random.RandomState(3).randint(0, VOCAB, (2, 16))
    for n in (16, 16, 8, 16):
        loss = ts(ids[:, :n], np.roll(ids[:, :n], -1, 1))
        assert np.isfinite(float(loss))
    assert ts.compiled_programs == 2 and ts.recaptures == 0
    with pytest.raises(MXNetError, match="batch tensor on"):
        ts(torch.zeros((2, 16), dtype=torch.int64, device="meta"),
           np.roll(ids, -1, 1))


@pytest.fixture
def fresh_knob():
    tconfig._values.pop("engine_type", None)
    yield
    tconfig._values.pop("engine_type", None)


def test_engine_type_knob(pair, fresh_knob, monkeypatch):
    _, tnet = pair
    monkeypatch.delenv("MXNET_ENGINE_TYPE", raising=False)
    assert tconfig.get("engine_type") == "graph"
    assert TEngine(tnet, device="cpu", **_kw(True)).engine_type == "graph"
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "naive")
    assert tconfig.get("engine_type") == "naive"
    eng = TEngine(tnet, device="cpu", **_kw(True))
    assert eng.engine_type == "naive"
    ts = TrainStep(tnet, tgpt2.lm_loss, topt.Adam())
    assert ts.engine_type == "naive"
    # the argument wins over the knob; config.set over the alias
    assert TEngine(tnet, device="cpu", engine_type="graph",
                   **_kw(True)).engine_type == "graph"
    tconfig.set("engine_type", "graph")
    assert tconfig.get("engine_type") == "graph"
    with pytest.raises(ValueError, match="engine_type"):
        tconfig.set("engine_type", "threaded")
    # an argument is checked as the knob's values are, in one place
    with pytest.raises(ValueError, match="engine_type"):
        TEngine(tnet, device="cpu", engine_type="eager", **_kw(True))
    with pytest.raises(ValueError, match="engine_type"):
        TrainStep(tnet, tgpt2.lm_loss, topt.Adam(), engine_type="xla")
    tconfig._values.pop("engine_type")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "bogus")
    with pytest.raises(ValueError, match="engine_type"):
        tconfig.get("engine_type")


def test_launch_counts_cover_every_kernel_wrapper():
    """The counters a capture takes back and a replay adds again: one per
    kernel wrapper (dicts by key)."""
    names = {(m.split(".")[-1], k) for m, k in tcg.launch_counts()}
    assert names == {("layernorm", "fwd"), ("layernorm", "bwd"),
                     ("layernorm", "bwd_merge"), ("optimizer", None),
                     ("flash_attention", "fwd"), ("flash_attention", "dkv"),
                     ("flash_attention", "dq"), ("paged_attention", "decode"),
                     ("paged_attention", "prefill"), ("softmax_xent", "fwd"),
                     ("softmax_xent", "bwd"), ("quantization", "int8_gemm"),
                     ("quantization", "int8_gemm_wgmma"),
                     ("quantization", "int8_gemm_mma"),
                     ("quantization", "int8_im2col")}
    before = tcg.launch_counts()
    delta = {k: 2 for k in before}
    tcg._add_launches(delta)
    assert tcg.launch_counts() == {k: v + 2 for k, v in before.items()}
    tcg._add_launches(delta, -1)
    assert tcg.launch_counts() == before
    assert not tcg.capturing()
    with pytest.raises(MXNetError, match="outside a StepGraph capture"):
        tcg.after_capture(lambda: None)


def test_each_graph_owns_its_arrival_counters(monkeypatch):
    """The paged read's split-merge counters: eager reads share one buffer
    per stream; a capture takes counters of its own, held by its graph, so
    that two graphs (two engines' decode steps, replayed on two streams)
    never share them, and a capture that needs more keeps the smaller
    buffer its earlier reads were captured with."""
    from mxnet_tpu_torch.ops import paged_attention as tpa

    dev = torch.device("cpu")
    # a CPU stand-in for the device allocation persistent_empty makes
    monkeypatch.setattr(tcg, "persistent_empty", lambda shape, dtype: (
        tcg._active._held.append(torch.full(shape, 7, dtype=dtype))
        or tcg._active._held[-1]))
    monkeypatch.setattr(tpa, "_arrivals", {})
    eager = tpa._arrival_counters(dev, "s", 64)
    assert eager.numel() == 1024 and not eager.any()
    graphs = [tcg.StepGraph(lambda: (), ("decode", i), dev) for i in (0, 1)]
    owned = []
    for g in graphs:
        monkeypatch.setattr(tcg, "_active", g)
        a = tpa._arrival_counters(dev, "s", 64)
        assert tpa._arrival_counters(dev, "s", 512) is a  # one per capture
        big = tpa._arrival_counters(dev, "s", 4096)
        assert big is not a and big.numel() == 4096
        assert g._held == [a, big]  # the graph keeps both alive
        for fn in g._after:  # zeroed after the capture, before a replay
            fn()
        assert not a.any() and not big.any()
        owned.append(big)
    monkeypatch.setattr(tcg, "_active", None)
    assert owned[0] is not owned[1]
    assert tpa._arrivals == {(dev, "s"): eager}
    with pytest.raises(MXNetError, match="outside a StepGraph capture"):
        tcg.owned()


def test_capture_streams_are_owned_then_reused(monkeypatch):
    """Each owner (engine, TrainStep) captures on a stream of its own, so
    that two owners' graphs never share a cuBLAS workspace; a dead owner's
    stream serves the next owner instead of a new one."""
    import gc

    made = []
    monkeypatch.setattr(tcg, "_new_stream",
                        lambda device: made.append(object()) or made[-1])
    monkeypatch.setattr(tcg, "_free_streams", {})

    class Owner:
        pass

    dev = torch.device("cuda", 0)
    a, b = Owner(), Owner()
    sa, sb = tcg.capture_stream(a, dev), tcg.capture_stream(b, dev)
    assert sa is not sb and len(made) == 2
    del a
    gc.collect()
    c = Owner()
    assert tcg.capture_stream(c, dev) is sa and len(made) == 2
    with pytest.raises(MXNetError, match="capture_stream"):
        tcg.StepGraph(lambda: (), ("decode", 1), dev)


@pytest.mark.parametrize("ended", [False, True],
                         ids=["left-routed", "already-ended"])
def test_failed_capture_gives_the_allocator_back(monkeypatch, ended):
    """After a failed capture the allocator's routing to the graph's pool
    is ended (PyTorch ends it only after a successful end of capture) and
    the pool's use given back; if the routing was already ended, only the
    use is given back."""
    calls = []

    def end(index, pool):
        calls.append(("end", index, pool))
        if ended:
            raise RuntimeError("endAllocatePool: not currently recording")

    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool", end)
    monkeypatch.setattr(torch._C, "_cuda_releasePool",
                        lambda index, pool: calls.append(("release", index,
                                                          pool)))
    tcg._abandon_pool(torch.device("cuda", 1), (0, 5))
    assert calls == [("end", 1, (0, 5)), ("release", 1, (0, 5))]


@pytest.mark.parametrize("ended", [True, False],
                         ids=["capture-ended", "capture-failed"])
def test_step_that_raises_during_capture(monkeypatch, ended):
    """A step that raises while it is captured gives MXNetError. When the
    capture still ended (the step raised on the host, nothing illegal was
    queued), the graph holds its use of the pool and gives it back when it
    is freed, so the step must not give it back too: PyTorch then aborts
    the process as the graph is destroyed (the use count below zero); only
    a capture that did not end is abandoned, and its generators taken out
    of capture mode (PyTorch does that only at a successful end, and every
    eager draw from the default generator then raises). The card's capture
    calls are stood in for on the CPU (the ``meta`` device takes the
    allocation)."""
    import contextlib

    events = []

    class Graph:
        def __init__(self, keep_graph=False):
            pass

        def capture_begin(self, pool=None):
            events.append(("begin", pool))

        def capture_end(self):
            events.append(("end",))
            if not ended:
                raise RuntimeError("operation not permitted when stream is "
                                   "capturing")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 9))
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(tcg, "_keep_stream", lambda device: None)
    monkeypatch.setattr(tcg, "_abandon_pool", lambda device, pool:
                        events.append(("abandon", pool)))
    monkeypatch.setattr(tcg, "_close_generators", lambda stream:
                        events.append(("close generators",)))

    def step():
        raise ValueError("a check on the host")

    g = tcg.StepGraph(step, ("probe",), torch.device("meta"), capture=False)
    g.capture, g.stream = True, object()
    with pytest.raises(MXNetError, match="probe.*ValueError"):
        g._capture()
    assert events[:2] == [("begin", (0, 9)), ("end",)]
    assert events[2:] == ([] if ended else [("abandon", (0, 9)),
                                            ("close generators",)])
    assert g.graph is None and not tcg.capturing()

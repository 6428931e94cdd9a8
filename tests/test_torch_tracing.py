"""The port's request tracing and SLO ledger against the JAX package's
(``mxnet_tpu_torch/observability/tracing.py`` vs
``mxnet_tpu/observability/tracing.py``), on the same inputs:

  - the tail sampler's keep decisions and reasons, call by call, under
    several policies (anomalies, redistribution, margin floor, the slow
    percentile, the deterministic healthy-sampling hash);
  - span JSONL written by either package's Tracer reads record for record
    in the other's ``read_span_records`` / ``collect_records`` (torn final
    lines skipped), kept traces flush spans and verdict, dropped ones only
    the verdict;
  - ``assemble`` / ``check_trace`` / ``trace_phases`` / ``slo_ledger`` /
    ``parse_windows`` give equal results on the same records;
  - the batcher's span hooks: a scripted run through both batchers on a
    tiny GPT-2 (weights crossed through ``.params``) gives equal span
    records (the real-clock ``service_s`` aside) and equal split-TTFT
    histograms; tracing off leaves ``tracer`` None.
"""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.observability import REGISTRY as JREG
from mxnet_tpu.observability import tracing as jtr
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.observability import REGISTRY as TREG
from mxnet_tpu_torch.observability import tracing as ttr

SIDES = {"jax": jtr, "port": ttr}
VOCAB = 97


def _decisions(mod, policy, script):
    s = mod.TailSampler(**policy)
    return [s.decide(tid, outcome, e2e=e2e, margin=margin,
                     redistributed=redist)
            for tid, outcome, e2e, margin, redist in script]


def _script(seed=0, n=200):
    rs = np.random.RandomState(seed)
    outcomes = ["eos", "length"] * 6 + ["deadline", "shed", "cancelled",
                                       "page_exhausted"]
    out = []
    for i in range(n):
        out.append((f"t{i}", outcomes[rs.randint(len(outcomes))],
                    float(rs.exponential(2.0)),
                    None if rs.rand() < 0.3 else float(rs.randn()),
                    bool(rs.rand() < 0.05)))
    return out


@pytest.mark.parametrize("policy", [
    dict(sample=0.0, seed=0, slow_pct=95.0, margin_floor=0.0),
    dict(sample=0.3, seed=0, slow_pct=95.0, margin_floor=0.0),
    dict(sample=0.3, seed=7, slow_pct=90.0, margin_floor=0.5),
    dict(sample=1.0, seed=0, slow_pct=100.0, margin_floor=0.0),
    dict(sample=0.5, seed=3, slow_pct=50.0, margin_floor=0.2, history=32,
         min_history=4),
], ids=["anomalies_only", "sampled", "margin_floor", "keep_all", "slow"])
def test_sampler_decisions_equal_jax(policy):
    script = _script()
    got = _decisions(ttr, policy, script)
    assert got == _decisions(jtr, policy, script)
    reasons = {why for _, why in got}
    # every policy keeps the anomalies and drops or samples the rest
    assert "outcome:deadline" in reasons
    assert any(k for k, _ in got)


def test_sampler_hash_and_bounds_equal_jax():
    for seed in (0, 1, 99):
        for tid in ("0", "17", "b3", "router-42"):
            assert ttr._hash_unit(seed, tid) == jtr._hash_unit(seed, tid)
    for mod in SIDES.values():
        with pytest.raises(ValueError):
            mod.TailSampler(sample=1.5)
        with pytest.raises(ValueError):
            mod.TailSampler(slow_pct=0.0)


def _emit(mod, path, owner, clock_t=5.0):
    """One scripted emission sequence: a kept trace, a dropped one, a
    discarded one, an anomalous one; returns the tracer's counts."""
    tr = mod.Tracer(str(path), "h0", owner=owner, clock=lambda: clock_t,
                    sampler=mod.TailSampler(sample=0.0, seed=0,
                                            slow_pct=100.0,
                                            margin_floor=1.0))
    tr.span("a", "router.backlog", 0.0, 1.0, cls="normal")
    tr.span("a", "router.attempt", 1.0, 3.0, replica=1)
    keep_a = tr.finish("a", "length", 0.0, 3.0, cls="normal", deadline=3.5)
    tr.span("b", "router.backlog", 0.0, 2.0)
    keep_b = tr.finish("b", "eos", 0.0, 2.0, cls="batch", deadline=100.0)
    tr.span("c", "router.backlog", 0.0, 2.0)
    tr.discard("c")
    tr.span("d", "replica.queue", 1.0, 4.0, outcome="shed", req=3)
    keep_d = tr.finish("d", "shed", 1.0, 4.0, hops=0, req=3)
    tr.close()
    return keep_a, keep_b, keep_d, tr.kept, tr.dropped


@pytest.mark.parametrize("owner", [True, False], ids=["owner", "replica"])
def test_span_files_read_both_ways(tmp_path, owner):
    paths = {}
    for name, mod in SIDES.items():
        d = tmp_path / name / "router"
        paths[name] = d / "spans-g0.jsonl"
        counts = _emit(mod, paths[name], owner)
        # margin 0.5 < floor 1.0: kept; healthy b dropped; shed kept
        assert counts == (True, False, True, 2, 1)
    with open(paths["jax"]) as a, open(paths["port"]) as b:
        assert a.read() == b.read()
    for name in SIDES:
        # a torn final line (crash mid-write) is skipped by both readers
        with open(paths[name], "a") as f:
            f.write('{"kind": "span", "trace": "x", "na')
        for mod in SIDES.values():
            recs = mod.read_span_records(str(paths[name]))
            assert recs == jtr.read_span_records(str(paths["jax"]))
            kinds = [r["kind"] for r in recs]
            assert kinds.count("end" if owner else "local_end") == 3
            assert not any(r["trace"] == "c" for r in recs)
        for mod in SIDES.values():
            got = mod.collect_records(str(tmp_path / name))
            assert got == jtr.collect_records(str(tmp_path / name))


def _mk_end(tid, outcome="eos", t0=0.0, t1=10.0, deadline=None, cls=None,
            hops=0):
    margin = None if deadline is None else deadline - t1
    return {"kind": "end", "trace": tid, "outcome": outcome, "cls": cls,
            "t0": t0, "t1": t1, "e2e": t1 - t0, "deadline": deadline,
            "margin": margin, "hops": hops, "keep": True, "why": "sampled",
            "src": "router"}


def _span(tid, name, t0, t1, **attrs):
    rec = {"kind": "span", "trace": tid, "name": name, "t0": t0, "t1": t1,
           "src": "router"}
    rec.update(attrs)
    return rec


TRACES = {
    "telescoping": [
        _span("t", "router.backlog", 0.0, 2.0),
        _span("t", "router.attempt", 2.0, 5.0, replica=0),
        _span("t", "redistribution", 5.0, 5.0, hop=1),
        _span("t", "router.backlog", 5.0, 6.0),
        _span("t", "router.attempt", 6.0, 10.0, replica=1),
        _span("t", "prefill", 6.5, 7.0),
        _mk_end("t", t1=10.0, hops=1)],
    "gap": [_span("t", "router.backlog", 0.0, 2.0),
            _span("t", "router.attempt", 3.0, 10.0), _mk_end("t")],
    "drift": [_span("t", "router.backlog", 0.0, 8.0), _mk_end("t")],
    "hops": [_span("t", "router.backlog", 0.0, 10.0), _mk_end("t", hops=2)],
    "orphan": [_span("t", "router.backlog", 0.0, 1.0)],
    "two_ends": [_span("t", "router.backlog", 0.0, 10.0),
                 _mk_end("t", t1=9.0), _mk_end("t", t1=10.0),
                 dict(_mk_end("t"), kind="local_end")],
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_assemble_and_check_equal_jax(name):
    recs = TRACES[name]
    got, want = ttr.assemble(recs), jtr.assemble(recs)
    assert got == want
    for tid in got:
        assert ttr.check_trace(got[tid]) == jtr.check_trace(want[tid])
        assert ttr.trace_phases(got[tid]) == jtr.trace_phases(want[tid])
    chk = ttr.check_trace(got["t"])
    assert chk["ok"] == (name in ("telescoping", "two_ends"))


def test_slo_ledger_and_windows_equal_jax():
    ends = [
        _mk_end("a", t1=10.0, deadline=14.0, cls="interactive"),
        _mk_end("b", t1=20.0, deadline=22.0, cls="interactive"),
        _mk_end("c", outcome="deadline", t1=30.0, deadline=29.0,
                cls="interactive"),
        _mk_end("d", outcome="cancelled", t1=30.0, cls="interactive"),
        _mk_end("e", outcome="length", t1=30.0, deadline=40.0, cls="batch",
                hops=2),
        _span("t", "router.backlog", 0, 1),
    ]
    for kw in (dict(windows=[100.0], target=0.9, now=30.0),
               dict(windows=[5.0, 15.0], target=0.99),
               dict()):
        got = ttr.slo_ledger(ends, **kw)
        assert got == jtr.slo_ledger(ends, **kw)
    led = ttr.slo_ledger(ends, windows=[100.0], target=0.9, now=30.0)
    assert led["classes"]["interactive"]["eligible"] == 3
    assert led["classes"]["interactive"]["burn"]["100s"] == \
        pytest.approx((1 / 3) / 0.1, abs=1e-3)
    assert ttr.slo_ledger([]) == jtr.slo_ledger([]) == {}
    for spec in ("60, 300,junk,-5,", "", "1.5", None):
        assert ttr.parse_windows(spec) == jtr.parse_windows(spec)


def test_maybe_tracer_none_unless_knob_on(tmp_path, monkeypatch):
    monkeypatch.delenv("MXNET_TPU_TRACE", raising=False)
    assert ttr.maybe_tracer(str(tmp_path / "s.jsonl"), "h0") is None
    monkeypatch.setenv("MXNET_TPU_TRACE", "1")
    tr = ttr.maybe_tracer(str(tmp_path / "s.jsonl"), "h0", owner=True)
    assert isinstance(tr, ttr.Tracer) and tr.owner
    assert tr.sampler.sample == 0.01 and tr.sampler.slow_pct == 95.0


# -- the batcher's span hooks -------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(num_layers=2, units=64, num_heads=4,
                           max_length=64, vocab_size=VOCAB, dropout=0.0)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    w = {k: np.asarray(p.data().asnumpy())
         for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tgpt2.GPT2Model(num_layers=2, units=64, num_heads=4,
                           max_length=64, vocab_size=VOCAB, dropout=0.0,
                           device="cpu")
    tser.load_mxnet_params(tnet, w)
    return jnet, tnet


def _prompt(n, seed):
    return [int(t) for t in np.random.RandomState(seed).randint(1, VOCAB, n)]


def _hist(reg, name):
    h = reg.get(name)
    s = h.stats() if h is not None else None
    return (0, 0.0) if s is None else (s["count"], s["sum"])


def _batcher_run(side, net, path):
    """A scripted run: a queue wait, two deadlines, a cancellation, a shed,
    a forked pair and a withdrawal, with a keep-everything tracer."""
    mod, Engine, Batcher, reg = {
        "jax": (jtr, JEngine, JBatcher, JREG),
        "port": (ttr, TEngine, TBatcher, TREG)}[side]
    kw = dict(batch_size=2, prefill_buckets=(8,), eos_id=None, pad_id=0,
              paged=True, page_size=4, num_pages=16)
    if side == "port":
        kw["device"] = "cpu"
    eng = Engine(net, **kw)
    clock = FakeClock()
    bkw = dict(clock=clock, max_queue=3, queue_policy="reject")
    if side == "port":
        bkw["device"] = "cpu"
    bat = Batcher(eng, **bkw)
    assert bat.tracer is None
    bat.tracer = mod.Tracer(str(path), "h0", clock=clock,
                            sampler=mod.TailSampler(
                                sample=1.0, seed=0, slow_pct=100.0,
                                margin_floor=0.0))
    before = {n: _hist(reg, n) for n in ("ttft_queue_seconds",
                                         "ttft_seconds")}
    svc0 = _hist(reg, "ttft_service_seconds")[0]
    reqs = [bat.submit(_prompt(4, 3), max_new_tokens=3, samples=2),
            bat.submit(_prompt(5, 1), max_new_tokens=4, trace_id="r1"),
            bat.submit(_prompt(6, 2), max_new_tokens=6, deadline_s=3.0)]
    reqs.append(bat.submit(_prompt(4, 4), max_new_tokens=3))  # shed
    clock.advance(2.0)
    for i in range(40):
        if i == 2:
            reqs.append(bat.submit(_prompt(7, 5), max_new_tokens=5,
                                   deadline_s=1.0))
        if i == 3:
            bat.cancel(reqs[1])
        if i == 5:
            reqs.append(bat.submit(_prompt(3, 6), max_new_tokens=2))
            bat.withdraw(reqs[-1])
        clock.advance(1.0)
        if not bat.step() and i > 6:
            break
    bat.tracer.close()
    recs = mod.read_span_records(str(path))
    for r in recs:
        r.pop("service_s", None)
    out = {"reasons": [r.finish_reason for r in reqs],
           "outputs": [list(map(int, r.output)) for r in reqs],
           "records": recs,
           # what this run added (rounded: the registries hold earlier
           # tests' observations, summed in another order)
           "ttft": {n: tuple(round(a - b, 6)
                             for a, b in zip(_hist(reg, n), before[n]))
                    for n in before},
           "service_count": _hist(reg, "ttft_service_seconds")[0] - svc0}
    return out


def test_batcher_spans_equal_jax(nets, tmp_path):
    jnet, tnet = nets
    want = _batcher_run("jax", jnet, tmp_path / "j.jsonl")
    got = _batcher_run("port", tnet, tmp_path / "t.jsonl")
    assert got["reasons"] == want["reasons"]
    assert got["outputs"] == want["outputs"]
    assert got["records"] == want["records"]
    assert got["ttft"] == want["ttft"]
    assert got["service_count"] == want["service_count"]
    names = {r["name"] for r in got["records"] if r["kind"] == "span"}
    assert {"replica.queue", "prefill", "fork", "decode",
            "decode.round"} <= names
    outcomes = {r["outcome"] for r in got["records"]
                if r["kind"] == "local_end"}
    assert {"length", "shed", "cancelled", "redistributed"} <= outcomes
    assert got["ttft"]["ttft_queue_seconds"][1] >= 2.0
    # the direct client's trace ids: the given one, then b{id}
    tids = {r["trace"] for r in got["records"]}
    assert "r1" in tids and "b1" in tids
    assert json.dumps(got["records"], sort_keys=True)

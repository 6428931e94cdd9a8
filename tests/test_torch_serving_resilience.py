"""The port's serving resilience against the JAX package's, with the same
weights: every scenario of tests/test_serving_resilience.py (deadlines,
cancellation, overload control, starvation aging, the speculation
governor, the dispatch watchdog, the serving fault sites with retry) runs
on the JAX batcher and on the port's, with the same fake clock and a
constant draft of each side; finish reasons, outputs, the gen_* / ttft /
retry telemetry (counter and gauge values, histogram counts) and
``compiled_programs`` must be equal, and each scenario's own assertions
hold on both sides. Then the chaos drill: tools/torch_servedrill.py's
evidence equals tools/servedrill.py's (wall time and the port-only entry
aside), its gate passes, and JAX's three planted faults (a page leak,
corrupted tokens, a missing fallback) each make it fail."""
import copy
import importlib.util
import itertools
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import observability as jobs
from mxnet_tpu import resilience as jres
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.inference import ContinuousBatcher as TBatcher
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)
_FAST_RETRY = dict(base_delay=0.001, jitter=0.0, seed=0)
#: the telemetry both sides must agree on
PREFIXES = ("gen_", "ttft", "decode_tokens", "retry_")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def _port_net(jnet, cfg, weights=None):
    """A port net holding ``jnet``'s weights (or ``weights``)."""
    weights = weights or {k: np.asarray(p.data().asnumpy())
                          for k, p in jnet._collect_params_with_prefix().items()}
    tnet = tgpt2.GPT2Model(**cfg, device="cpu")
    tser.load_mxnet_params(tnet, weights)
    return tnet


class JConstDraft:
    """The JAX drafts' duck type: always proposes ``token``."""

    def __init__(self, token, vocab=VOCAB, max_length=64):
        self._token, self._vocab, self._max_length = token, vocab, max_length

    def collect_params(self):
        return {}

    def init_paged_cache(self, num_pages, page_size, dtype="float32"):
        return [(jnp.zeros((num_pages + 1, 1, page_size, 1), jnp.float32),
                 jnp.zeros((num_pages + 1, 1, page_size, 1), jnp.float32))]

    def __call__(self, tokens, cache=None, start_pos=None, page_table=None):
        shape = (tokens._data.shape[0], tokens._data.shape[1])
        logits = jax.nn.one_hot(jnp.full(shape, self._token), self._vocab,
                                dtype=jnp.float32) * 10.0
        return NDArray(logits), cache


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Side:
    """One package's serving stack behind one interface, so that a
    scenario runs unchanged on both."""

    def __init__(self, name, net, engine, batcher, draft, obs, res):
        self.name, self.net = name, net
        self._engine, self._batcher, self._draft = engine, batcher, draft
        self.obs, self.res = obs, res
        self.faults, self.retry = res.faults, res.retry

    def engine(self, paged=True, **kw):
        kw.setdefault("batch_size", 2)
        kw.setdefault("prefill_buckets", (8, 16))
        kw.setdefault("eos_id", None)
        kw.setdefault("pad_id", PAD)
        if paged:
            kw.setdefault("page_size", 8)
        return self._engine(self.net, paged=paged, **kw)

    def batcher(self, eng, **kw):
        return self._batcher(eng, **kw)

    def draft(self, token):
        return self._draft(token)


@pytest.fixture(scope="module")
def sides():
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    weights = _lively_weights(jnet)
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(nd.array(weights[name]))
    tnet = _port_net(jnet, SMALL, weights)
    return {
        "jax": Side("jax", jnet, JEngine, JBatcher, JConstDraft, jobs, jres),
        "port": Side("port", tnet,
                     lambda net, **kw: TEngine(net, device="cpu", **kw),
                     lambda eng, **kw: TBatcher(eng, device="cpu", **kw),
                     lambda token: _drill().AdversarialDraft(
                         VOCAB, 64, token, device="cpu"),
                     tobs, tres),
    }


def _prompt(n, seed, lo=1, hi=EOS):
    return list(np.random.RandomState(seed).randint(lo, hi, n))


def _telemetry(registry):
    """Counter and gauge values and histogram counts, by name and labels,
    of the metrics both sides record (series recorded since the reset)."""
    out = {}
    for name, m in registry.snapshot().items():
        if not name.startswith(PREFIXES) or not m["series"]:
            continue
        out[name] = sorted(
            (tuple(sorted(s["labels"].items())),
             s["value"]["count"] if m["kind"] == "histogram" else s["value"])
            for s in m["series"])
    return out


# ---------------------------------------------------------------------------
# the scenarios of tests/test_serving_resilience.py, side-generic: each
# asserts what the JAX test asserts and returns what must match across sides
# ---------------------------------------------------------------------------
def deadline_expired_in_queue(s):
    clock = FakeClock()
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, clock=clock)
    r1 = bat.submit(_prompt(5, 1), max_new_tokens=12)
    bat.step()
    assert r1.slot == 0
    r2 = bat.submit(_prompt(5, 2), max_new_tokens=4, deadline_s=3.0)
    clock.advance(5.0)
    bat.step()
    assert r2.finish_reason == "deadline" and r2.output == []
    assert r2.slot is None  # never admitted
    assert not r1.done  # the active row was untouched
    return dict(out=[r1.output, r2.output], reasons=[r1.finish_reason,
                                                     r2.finish_reason],
                programs=eng.compiled_programs)


def deadline_expired_in_slot(s):
    clock = FakeClock()
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, clock=clock)
    r = bat.submit(_prompt(9, 3), max_new_tokens=20, deadline_s=3.0)
    bat.step()
    assert r.slot == 0 and eng.pages_in_use == 2
    clock.advance(5.0)
    # the boundary that expires the slot frees its pages in time for this
    # same boundary's admission
    r2 = bat.submit(_prompt(5, 4), max_new_tokens=2)
    bat.step()
    assert r.finish_reason == "deadline" and len(r.output) >= 1
    assert r2.slot == 0
    bat.run_until_idle(max_steps=20)
    assert eng.free_pages == eng.num_pages
    return dict(out=[r.output, r2.output], reasons=[r.finish_reason,
                                                    r2.finish_reason],
                programs=eng.compiled_programs)


def default_deadline(s):
    clock = FakeClock()
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, default_deadline_s=4.0, clock=clock)
    r = bat.submit(_prompt(5, 5), max_new_tokens=50)
    assert r.deadline_t == pytest.approx(4.0)
    bat.step()
    clock.advance(10.0)
    bat.step()
    assert r.finish_reason == "deadline"
    return dict(out=r.output, deadline_t=r.deadline_t,
                programs=eng.compiled_programs)


def cancel_queued(s):
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng)
    r1 = bat.submit(_prompt(5, 10), max_new_tokens=12)
    bat.step()
    r2 = bat.submit(_prompt(5, 11), max_new_tokens=4)
    assert bat.cancel(r2.id)
    bat.step()
    assert r2.finish_reason == "cancelled" and r2.output == []
    return dict(out=[r1.output, r2.output], programs=eng.compiled_programs)


def cancel_active_releases_pages(s):
    eng = s.engine(batch_size=2)
    bat = s.batcher(eng)
    r = bat.submit(_prompt(9, 12), max_new_tokens=30)
    bat.step()
    assert r.slot is not None and eng.pages_in_use > 0
    assert bat.cancel(r)
    bat.step()
    assert r.finish_reason == "cancelled" and len(r.output) >= 1
    assert eng.free_pages == eng.num_pages
    assert not bat.cancel(99999) and not bat.cancel(r.id)
    return dict(out=r.output, programs=eng.compiled_programs)


def cancel_then_page_reuse(s):
    # the cancelled row's next (masked) writes land in the trash page, so
    # the request that takes its pages streams as a solo run does
    ref = s.engine(paged=False, batch_size=1)
    p1 = _prompt(10, 81)
    want = [ref.prefill(p1, slot=0)]
    for _ in range(5):
        tok, _, _ = ref.decode_step()
        want.append(int(tok[0]))
    eng = s.engine(batch_size=2, num_pages=3)
    bat = s.batcher(eng)
    ra = bat.submit(_prompt(6, 80), max_new_tokens=30)
    bat.step()
    bat.step()
    bat.cancel(ra)
    rb = bat.submit(p1, max_new_tokens=6)  # needs 2 of the 3 pages
    bat.run_until_idle(max_steps=50)
    assert ra.finish_reason == "cancelled" and rb.finish_reason == "length"
    assert rb.result() == want
    return dict(out=[ra.output, rb.output], want=want,
                programs=[ref.compiled_programs, eng.compiled_programs])


def reject_policy(s):
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, max_queue=1, queue_policy="reject")
    r0 = bat.submit(_prompt(5, 20), max_new_tokens=20)
    bat.step()
    q1 = bat.submit(_prompt(5, 21), max_new_tokens=4)
    q2 = bat.submit(_prompt(5, 22), max_new_tokens=4)
    assert q2.done and q2.finish_reason == "shed"
    assert not q1.done and not r0.done
    bat.run_until_idle(max_steps=50)
    return dict(out=[r.output for r in (r0, q1, q2)],
                reasons=[r.finish_reason for r in (r0, q1, q2)],
                programs=eng.compiled_programs)


def shed_policy(s):
    clock = FakeClock()
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, max_queue=1, queue_policy="shed", clock=clock)
    bat.submit(_prompt(5, 23), max_new_tokens=20)
    bat.step()
    q1 = bat.submit(_prompt(5, 24), max_new_tokens=4, deadline_s=1.0)
    clock.advance(5.0)  # q1 is now past its deadline, still queued
    q2 = bat.submit(_prompt(5, 25), max_new_tokens=4)
    assert q1.finish_reason == "shed" and not q2.done
    # queue full again, nothing expired: the NEW request is shed
    q3 = bat.submit(_prompt(5, 26), max_new_tokens=4)
    assert q3.finish_reason == "shed"
    return dict(reasons=[r.finish_reason for r in (q1, q2, q3)],
                programs=eng.compiled_programs)


def page_floor(s):
    eng = s.engine(batch_size=2, num_pages=4)
    bat = s.batcher(eng, shed_page_floor=4)
    r0 = bat.submit(_prompt(9, 27), max_new_tokens=20)  # 2 pages
    bat.step()
    # free pages (2) below the floor but a slot is open: not overload
    r1 = bat.submit(_prompt(9, 28), max_new_tokens=20)
    assert not r1.done
    bat.step()
    assert r1.slot is not None
    r2 = bat.submit(_prompt(5, 29), max_new_tokens=4)
    assert r2.finish_reason == "shed"
    assert not r0.done and not r1.done
    return dict(out=[r0.output, r1.output], programs=eng.compiled_programs)


def _starve_setup(s, aging):
    eng = s.engine(batch_size=2, prefill_buckets=(8, 16, 32), num_pages=3)
    bat = s.batcher(eng, head_aging_steps=aging)
    smalls = [bat.submit(_prompt(3, 100), max_new_tokens=2),
              bat.submit(_prompt(3, 101), max_new_tokens=3)]
    bat.step()  # both admitted: 2 pages held, 1 free
    big = bat.submit(_prompt(17, 99), max_new_tokens=3)  # 3 pages
    return eng, bat, big, smalls


def _starve_drive(bat, big, smalls, steps):
    seeds = itertools.count(200)
    for _ in range(steps):
        while bat.pending < 3:  # keep the small stream flowing
            smalls.append(bat.submit(_prompt(3, next(seeds)),
                                     max_new_tokens=3))
        bat.step()
        if big.done:
            break
    return smalls


def head_starves_with_guard_off(s):
    eng, bat, big, smalls = _starve_setup(s, aging=0)
    smalls = _starve_drive(bat, big, smalls, steps=30)
    assert not big.done and big.slot is None  # starved
    assert sum(r.done for r in smalls) >= 8
    assert eng.reserved_pages == 0
    return dict(out=[r.output for r in smalls], programs=eng.compiled_programs)


def aging_guard_admits_head(s):
    eng, bat, big, smalls = _starve_setup(s, aging=3)
    smalls = _starve_drive(bat, big, smalls, steps=60)
    assert big.finish_reason == "length" and eng.reserved_pages == 0
    return dict(out=[big.output] + [r.output for r in smalls],
                programs=eng.compiled_programs)


def tracker_window(s):
    t = s.res.AcceptRateTracker(window=3)
    rates = [t.rate]
    t.observe(2, 4)
    t.observe(0, 0)  # no-signal round ignored
    t.observe(1, 4)
    rates.append(t.rate)
    t.observe(0, 4)
    rates.append(t.rate)
    assert rates == [None, None, pytest.approx(3 / 12)]
    t.reset()
    assert t.rate is None
    return dict(rates=rates)


def governor_state_machine(s):
    g = s.res.SpeculationGovernor(window=2, floor=0.5, cooldown=3)
    modes = [g.mode]
    for acc in (3, 0, 0):
        g.observe_round(acc, 3)
        modes.append(g.mode)
    for _ in range(3):
        g.observe_plain_step()
        modes.append(g.mode)
    assert modes == ["spec", "spec", "spec", "fallback", "fallback",
                     "fallback", "spec"]
    assert g.fallbacks == 1 and g.rearms == 1 and g.tracker.rate is None
    return dict(modes=modes)


def plain_step_on_spec_engine(s):
    spec = s.engine(draft_net=s.draft(7), speculate_k=3)
    spec.prefill(_prompt(5, 40), slot=0)
    with pytest.raises(RuntimeError):
        spec.decode_step()
    n0 = spec.compiled_programs
    spec.plain_step()
    assert spec.compiled_programs == n0 + 1
    spec.plain_step()
    assert spec.compiled_programs == n0 + 1  # built once
    return dict(programs=[n0, spec.compiled_programs],
                last=spec.last_tokens.tolist())


def collapse_falls_back_rearms(s):
    prompts = [_prompt(5, 41), _prompt(9, 42)]
    ref = s.engine(batch_size=2).generate(prompts, max_new_tokens=16)
    spec = s.engine(batch_size=2, draft_net=s.draft(7), speculate_k=3)
    bat = s.batcher(spec, spec_window=3, spec_floor=0.5, spec_cooldown=2)
    reqs = [bat.submit(p, max_new_tokens=16) for p in prompts]
    modes = []
    while bat.step():
        modes.append(bat.governor.mode)
    assert "fallback" in modes and "spec" in modes[modes.index("fallback"):]
    assert bat.governor.fallbacks >= 1 and bat.governor.rearms >= 1
    assert [r.result() for r in reqs] == ref  # flapping never changes tokens
    return dict(modes=modes, out=[r.output for r in reqs],
                counts=[bat.governor.fallbacks, bat.governor.rearms],
                programs=spec.compiled_programs)


def watchdog_fires_on_stall(s):
    wd = s.res.DispatchWatchdog(timeout_s=0.05)
    with wd.guard("decode", step_id=7):
        time.sleep(0.25)
    assert wd.stalls == 1
    stall = {k: wd.last_stall[k] for k in ("family", "step_id", "timeout_s")}
    assert stall == {"family": "decode", "step_id": 7, "timeout_s": 0.05}
    return stall


def watchdog_silent(s):
    wd = s.res.DispatchWatchdog(timeout_s=5.0)
    with wd.guard("decode", step_id=1):
        pass
    off = s.res.DispatchWatchdog(timeout_s=0.0)
    with off.guard("decode", step_id=1):
        time.sleep(0.02)
    assert wd.stalls == 0 and off.stalls == 0 and not off.enabled
    return dict(stalls=[wd.stalls, off.stalls])


def batcher_detects_stall(s):
    # one intra-op thread while the watchdog is armed: on a loaded CPU
    # (other test workers) PyTorch's pool of 8 threads waits at its
    # barriers for descheduled threads, and the tiny prefill then takes
    # 0.6-0.7 s instead of 1 ms, past the 0.5 s budget: a second, unplanted
    # stall event. With one thread it stays within 10 ms under the same load
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _batcher_detects_stall(s)
    finally:
        torch.set_num_threads(threads)


def _batcher_detects_stall(s):
    eng = s.engine(batch_size=1)
    # a first prefill outside the guard: the JAX side's first call of a
    # program compiles it, which the budget would read as a stall. The
    # budget (0.5 s against a 1 s stall) leaves a loaded CPU's prefill
    # far inside it
    eng.prefill(_prompt(5, 50), slot=0)
    eng.release_slot(0)
    bat = s.batcher(eng, watchdog_s=0.5)
    real = eng.decode_step

    def stalled():
        time.sleep(1.0)
        return real()

    eng.decode_step = stalled
    r = bat.submit(_prompt(5, 50), max_new_tokens=2)
    bat.run_until_idle(max_steps=10)
    assert r.finish_reason == "length"  # the request still completed
    assert bat.watchdog.stalls >= 1
    assert bat.watchdog.last_stall["family"] == "decode"
    return dict(out=r.output, stalls=bat.watchdog.stalls,
                victims=bat.watchdog.last_stall["victims"])


def prefill_fault_absorbed(s):
    eng = s.engine(batch_size=1)
    want = s.engine(batch_size=1).generate([_prompt(5, 60)],
                                           max_new_tokens=5)[0]
    bat = s.batcher(eng, retry_policy=s.res.RetryPolicy(**_FAST_RETRY))
    with s.faults.inject("gen.prefill", every=1, times=1):
        r = bat.submit(_prompt(5, 60), max_new_tokens=5)
        bat.run_until_idle(max_steps=20)
    assert r.result() == want  # the retried admission replayed cleanly
    log = s.retry.attempt_log("gen.prefill")
    assert [a["ok"] for a in log[-2:]] == [False, True]
    return dict(out=r.output, log=[(a["attempt"], a["ok"], a["delay"])
                                   for a in log])


def decode_fault_absorbed(s):
    eng = s.engine(batch_size=1)
    want = s.engine(batch_size=1).generate([_prompt(5, 61)],
                                           max_new_tokens=6)[0]
    bat = s.batcher(eng, retry_policy=s.res.RetryPolicy(**_FAST_RETRY))
    r = bat.submit(_prompt(5, 61), max_new_tokens=6)
    bat.step()
    with s.faults.inject("gen.decode", every=1, times=1):
        bat.step()
    bat.run_until_idle(max_steps=20)
    assert r.result() == want
    return dict(out=r.output, log=[(a["attempt"], a["ok"], a["delay"])
                                   for a in s.retry.attempt_log("gen.decode")])


def verify_fault_absorbed(s):
    prompts = [_prompt(5, 62), _prompt(9, 63)]
    ref = s.engine(batch_size=2).generate(prompts, max_new_tokens=8)
    spec = s.engine(batch_size=2, draft_net=s.net, speculate_k=4)
    bat = s.batcher(spec, retry_policy=s.res.RetryPolicy(**_FAST_RETRY))
    with s.faults.inject("gen.verify", every=2, times=1):
        reqs = [bat.submit(p, max_new_tokens=8) for p in prompts]
        bat.run_until_idle(max_steps=50)
    assert [r.result() for r in reqs] == ref
    return dict(out=[r.output for r in reqs],
                programs=spec.compiled_programs,
                log=[(a["attempt"], a["ok"], a["delay"])
                     for a in s.retry.attempt_log("gen.verify")])


def injected_crash_passes_through(s):
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, retry_policy=s.res.RetryPolicy(**_FAST_RETRY))
    bat.submit(_prompt(5, 64), max_new_tokens=10)
    bat.step()
    with s.faults.inject("gen.decode", every=1, times=1, crash=True):
        with pytest.raises(s.faults.InjectedCrash):
            bat.step()  # process death is never absorbed into a retry
    return dict(log=[(a["attempt"], a["ok"])
                     for a in s.retry.attempt_log("gen.decode")])


def queue_policy_validated(s):
    with pytest.raises(ValueError):
        s.batcher(s.engine(), queue_policy="drop-everything")
    return {}


# the batcher's drain hooks (tests/test_fleet_serving.py's
# TestRedistributed): the fleet tier's router calls them; the port holds
# them against the JAX batcher before that tier is ported
def withdraw_queued_request(s):
    clock = FakeClock()
    bat = s.batcher(s.engine(batch_size=1), clock=clock)
    r1 = bat.submit(_prompt(5, 1), max_new_tokens=8)
    bat.step()  # r1 takes the only slot
    assert r1.slot == 0
    r2 = bat.submit(_prompt(5, 2), max_new_tokens=8)
    assert bat.withdraw(r2) is True
    assert r2.finish_reason == "redistributed" and r2.output == []
    assert bat.pending == 0
    # idempotent: a finished request cannot be withdrawn again
    assert bat.withdraw(r2) is False
    # active rows hold cache state: never withdrawable
    assert bat.withdraw(r1) is False
    assert r1.finish_reason is None
    return dict(out=[r1.output, r2.output],
                reasons=[r1.finish_reason, r2.finish_reason])


def abandon_marks_queue_and_slots(s):
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, clock=FakeClock())
    r1 = bat.submit(_prompt(5, 3), max_new_tokens=8)
    bat.step()
    r2 = bat.submit(_prompt(5, 4), max_new_tokens=8)
    lost = bat.abandon()
    assert [r.id for r in lost] == [r2.id, r1.id]  # the queue, then slots
    assert r1.finish_reason == r2.finish_reason == "redistributed"
    assert bat.active == 0 and bat.pending == 0
    # bookkeeping only: the abandoned engine keeps the row's pages
    return dict(out=[r1.output, r2.output], pages_in_use=eng.pages_in_use)


def drain_stops_admission_and_sheds_submits(s):
    eng = s.engine(batch_size=1)
    bat = s.batcher(eng, clock=FakeClock())
    r1 = bat.submit(_prompt(5, 5), max_new_tokens=3)
    bat.step()
    r2 = bat.submit(_prompt(5, 6), max_new_tokens=3)
    bat.begin_drain()
    r3 = bat.submit(_prompt(5, 7), max_new_tokens=3)
    assert r3.done and r3.finish_reason == "shed"
    withdrawn = bat.withdraw_queued()
    assert withdrawn == [r2]
    # in-flight work still finishes normally under drain
    bat.run_until_idle(max_steps=10)
    assert r1.finish_reason == "length"
    assert bat.active == 0 and bat.pending == 0
    assert eng.free_pages == eng.num_pages
    return dict(out=[r.output for r in (r1, r2, r3)],
                reasons=[r.finish_reason for r in (r1, r2, r3)])


def queue_age_p95_tracks_live_queue(s):
    clock = FakeClock()
    bat = s.batcher(s.engine(batch_size=1), clock=clock)
    assert bat.queue_age_p95() == 0.0
    bat.submit(_prompt(5, 8), max_new_tokens=4)
    bat.step()  # admitted; the queue is empty again
    bat.submit(_prompt(5, 9), max_new_tokens=4)
    clock.advance(2.0)
    bat.submit(_prompt(5, 10), max_new_tokens=4)
    clock.advance(1.0)
    assert sorted(bat.queue_ages()) == [1.0, 3.0]
    assert bat.queue_age_p95() == 3.0
    return dict(ages=bat.queue_ages(), p95=bat.queue_age_p95(),
                at_5=bat.queue_age_p95(now=5.0))


SCENARIOS = {f.__name__: f for f in (
    deadline_expired_in_queue, deadline_expired_in_slot, default_deadline,
    cancel_queued, cancel_active_releases_pages, cancel_then_page_reuse,
    reject_policy, shed_policy, page_floor, queue_policy_validated,
    head_starves_with_guard_off, aging_guard_admits_head, tracker_window,
    governor_state_machine, plain_step_on_spec_engine,
    collapse_falls_back_rearms, watchdog_fires_on_stall, watchdog_silent,
    batcher_detects_stall, prefill_fault_absorbed, decode_fault_absorbed,
    verify_fault_absorbed, injected_crash_passes_through,
    withdraw_queued_request, abandon_marks_queue_and_slots,
    drain_stops_admission_and_sheds_submits,
    queue_age_p95_tracks_live_queue)}


@pytest.mark.chaos
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(sides, name):
    """The scenario holds on both sides, and the two sides' results and
    telemetry are equal."""
    got, telemetry = {}, {}
    for key, side in sides.items():
        side.obs.REGISTRY.reset()
        side.faults.reset()
        side.retry.clear_log()
        got[key] = SCENARIOS[name](side)
        telemetry[key] = _telemetry(side.obs.REGISTRY)
    assert got["port"] == got["jax"]
    assert telemetry["port"] == telemetry["jax"]


def test_stuck_dispatch_event_names_family_step_and_victims(sides,
                                                            tmp_path):
    """The watchdog's event, read back from the port's event log, carries
    the family, the step id and the victims, as the JAX event does."""
    events = {}
    for key, side in sides.items():
        d = tmp_path / key
        side.obs.enable(str(d), run_id="stall")
        try:
            batcher_detects_stall(side)
        finally:
            side.obs.disable()
        events[key] = [{k: e[k] for k in ("family", "step_id", "victims",
                                          "timeout_s")}
                       for e in side.obs.read_events(str(d))
                       if e["event"] == "gen_stuck_dispatch"]
    assert events["port"] == events["jax"] and events["port"]
    assert events["port"][0]["family"] == "decode"


# ---------------------------------------------------------------------------
# the chaos drill: tools/torch_servedrill.py against tools/servedrill.py
# ---------------------------------------------------------------------------
_DRILL = {}


def _drill():
    if "port" not in _DRILL:
        _DRILL["port"] = _load("torch_servedrill",
                               os.path.join(REPO, "tools",
                                            "torch_servedrill.py"))
    return _DRILL["port"]


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The JAX drill and the port's tiny-plan drill on the same weights
    (the JAX drill's own ``build_net``, crossed over)."""
    jdrill = _load("servedrill_ref", os.path.join(REPO, "tools",
                                                   "servedrill.py"))
    jnet = jdrill.build_net()
    tnet = _port_net(jnet, dict(num_layers=2, units=64, num_heads=4,
                                max_length=64, vocab_size=jdrill.VOCAB,
                                dropout=0.0))
    try:
        jres.faults.reset()
        ref = jdrill.run_drill(
            telemetry_dir=str(tmp_path_factory.mktemp("jax_drill")))
    finally:
        jobs.disable()
    tres.faults.reset()
    port = _drill()
    got = port.run_drill(tnet, port.AdversarialDraft(jdrill.VOCAB, 64,
                                                     device="cpu"),
                         device="cpu",
                         telemetry_dir=str(tmp_path_factory.mktemp("drill")))
    return ref, got


def test_drill_evidence_equals_jax(drills):
    ref, got = drills
    strip = lambda r: {k: v for k, v in r.items()  # noqa: E731
                       if k not in ("wall_s", "port")}
    assert strip(got) == strip(ref)
    assert got["port"]["shed_causes"] == {"queue_full": 2.0}
    assert got["port"]["watchdog_stalls"] == 0


def test_drill_gate_green(drills):
    assert _drill().validate(drills[1]) == []


def test_drill_page_leak_fails_gate(drills):
    bad = copy.deepcopy(drills[1])
    bad["drained"]["free_pages"] -= 1
    assert any("page leak" in p for p in _drill().validate(bad))


def test_drill_corrupted_tokens_fail_gate(drills):
    bad = copy.deepcopy(drills[1])
    key = next(k for k, v in bad["requests"].items()
               if v["reason"] == "length" and k in bad["baseline"])
    bad["requests"][key]["output"][0] ^= 1
    assert any("diverge" in p or "prefix" in p
               for p in _drill().validate(bad))


def test_drill_missing_fallback_fails_gate(drills):
    bad = copy.deepcopy(drills[1])
    bad["counters"]["fallbacks"] = 0
    assert any("fallbacks" in p for p in _drill().validate(bad))


def test_drill_required_shed_cause_gates(drills):
    """A plan that requires a shed cause the run never produced fails
    (the full-width plan requires queue_full and page_floor)."""
    bad = copy.deepcopy(drills[1])
    bad["port"]["require_causes"] = ["queue_full", "page_floor"]
    assert any("page_floor" in p for p in _drill().validate(bad))
    assert _drill().serve_plan().require_causes == ("queue_full",
                                                    "page_floor")


def test_drill_defaults_to_the_card(monkeypatch):
    """Without a device the drill's net, draft and runs are built on the
    card, and without a card they raise; the CPU is taken only on request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    drill = _drill()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        drill.tiny_net()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        drill.AdversarialDraft(VOCAB, 64)
    net = drill.tiny_net(device="cpu")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        drill.baseline_outputs(net, drill.tiny_plan())
    with pytest.raises(MXNetError, match="CUDA is not available"):
        drill.run_drill(net, drill.AdversarialDraft(61, 64, device="cpu"))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        drill.main([])

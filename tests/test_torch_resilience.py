"""The port's fault injection and retry layer against the JAX package's:
the same ``load_spec`` strings fire at the same invocation numbers (and
``p=`` triggers draw the same seeded stream), ``inject`` restores what was
armed, and ``RetryPolicy(seed=0)`` gives the same delays, attempt logs and
``retry_attempts_total`` counts. Port only: a failure of the card (a
sticky CUDA error, ``torch.AcceleratorError``) or of the program on it
(``MXNetError``: a kernel that failed to build or launch, a failed capture)
passes through ``retry_call`` at the first attempt, as does
``InjectedCrash``; inside the batcher such a failure is raised, never
absorbed."""
import numpy as np
import pytest
import torch

from mxnet_tpu import observability as jobs
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import observability as tobs
from mxnet_tpu_torch.inference import ContinuousBatcher, GenerationEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.resilience import retry as tretry

SIDES = (("jax", jfaults, jretry, jobs), ("port", tfaults, tretry, tobs))


@pytest.fixture(autouse=True)
def _clean():
    for _, faults, retry, _ in SIDES:
        faults.reset()
        retry.clear_log()
    yield
    for _, faults, _, _ in SIDES:
        faults.reset()


def _fire_pattern(faults, sites, n=40):
    """(invocation, site, exception class) of every firing over ``n``
    rounds of calls to each site."""
    out = []
    for i in range(1, n + 1):
        for site in sites:
            try:
                faults.fire(site)
            except faults.InjectedFault as e:
                out.append((i, site, "fault", e.invocation))
            except faults.InjectedCrash as e:
                out.append((i, site, "crash", e.invocation))
    return out


SPECS = [
    "gen.decode:every=3",
    "gen.prefill:on=2",
    "gen.prefill:on=4:times=2",
    "gen.verify:every=2:times=3",
    "gen.decode:p=0.3;seed=7",
    "gen.decode:p=0.5:times=4;gen.verify:p=0.25;seed=1",
    "gen.prefill:on=3:crash;gen.decode:every=4",
    "seed=3;gen.verify:p=0.4:crash",
]


@pytest.mark.parametrize("spec", SPECS)
def test_load_spec_fires_like_jax(spec):
    got = {}
    for key, faults, _, _ in SIDES:
        faults.load_spec(spec)
        assert faults.armed()
        got[key] = _fire_pattern(faults, ("gen.prefill", "gen.decode",
                                          "gen.verify"))
        assert [faults.count(s) for s in ("gen.prefill", "gen.decode")] \
            == [40, 40]
    assert got["port"] == got["jax"] and got["port"]


@pytest.mark.parametrize("bad", ["gen.decode:every=x", "gen.decode:often",
                                 "gen.decode:wait=3", "gen.decode"])
def test_bad_spec_refused_like_jax(bad):
    for _, faults, _, _ in SIDES:
        with pytest.raises(ValueError):
            faults.load_spec(bad)


def test_inject_restores_previous_triggers():
    got = {}
    for key, faults, _, _ in SIDES:
        faults.arm("gen.decode", every=5)
        with faults.inject("gen.decode", every=1, times=1):
            first = _fire_pattern(faults, ("gen.decode",), n=3)
        after = _fire_pattern(faults, ("gen.decode",), n=10)
        faults.disarm()
        assert not faults.armed()
        got[key] = (first, after)
    assert got["port"] == got["jax"]


def test_retry_policy_delays_like_jax():
    for kw in (dict(seed=0), dict(seed=0, base_delay=0.01, max_delay=0.05,
                                  multiplier=3.0, jitter=0.5)):
        j, t = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
        assert [t.delay(a) for a in range(1, 9)] == \
            [j.delay(a) for a in range(1, 9)]
    for _, _, retry, _ in SIDES:
        with pytest.raises(ValueError):
            retry.RetryPolicy(max_attempts=0)


def _flaky(n_fail, exc=IOError):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_fail:
            raise exc(f"transient {len(calls)}")
        return len(calls)

    return fn, calls


@pytest.mark.parametrize("n_fail", [0, 1, 2, 3])
def test_retry_call_attempt_log_like_jax(n_fail):
    """Recovered and exhausted calls: the same results, attempt records,
    RetryError and counters."""
    got = {}
    for key, _, retry, obs in SIDES:
        obs.REGISTRY.reset()
        fn, calls = _flaky(n_fail)
        policy = retry.RetryPolicy(max_attempts=3, base_delay=0.001,
                                   jitter=0.5, seed=0)
        try:
            result = retry.retry_call(fn, site="gen.decode", policy=policy)
        except retry.RetryError as e:
            result = ("RetryError", e.site, len(e.attempts),
                      type(e.__cause__).__name__)
        c = obs.REGISTRY.get("retry_attempts_total")
        got[key] = (result, len(calls), retry.attempt_log("gen.decode"),
                    c.value(site="gen.decode", ok="false"),
                    c.value(site="gen.decode", ok="true"))
    assert got["port"] == got["jax"]


def test_non_retryable_class_raised_like_jax():
    class Corrupt(IOError):
        retryable = False

    for _, _, retry, _ in SIDES:
        fn, calls = _flaky(5, Corrupt)
        with pytest.raises(Corrupt):
            retry.retry_call(fn, site="gen.prefill",
                             policy=retry.RetryPolicy(base_delay=0.001))
        assert len(calls) == 1
        assert [a["ok"] for a in retry.attempt_log("gen.prefill")] == [False]


def _accelerator_error():
    return torch.AcceleratorError("CUDA error: an illegal memory access "
                                  "was encountered")


@pytest.mark.parametrize("make", [
    _accelerator_error,
    lambda: MXNetError("CUDA graph capture of step ('decode', 8, 'paged') "
                       "failed"),
    lambda: MXNetError("paged_attention: CUDA launch failed (700: an "
                       "illegal memory access)"),
], ids=["AcceleratorError", "capture", "launch"])
def test_card_failure_is_not_retried(make):
    """The port-only rule: the first attempt's failure is re-raised as it
    is, recorded once, never retried."""
    tobs.REGISTRY.reset()
    exc = make()
    calls = []

    def fn():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)) as info:
        tretry.retry_call(fn, site="gen.decode",
                          policy=tretry.RetryPolicy(base_delay=0.001))
    assert info.value is exc and len(calls) == 1
    assert [a["ok"] for a in tretry.attempt_log("gen.decode")] == [False]
    c = tobs.REGISTRY.get("retry_attempts_total")
    assert c.value(site="gen.decode", ok="false") == 1.0
    assert isinstance(exc, tretry.device_failures())


def test_injected_crash_and_host_errors():
    """InjectedCrash is a BaseException: it passes through unrecorded; an
    ordinary host-side error (a RuntimeError that is no device failure) is
    retried."""
    def crash():
        raise tfaults.InjectedCrash("gen.decode", 1)

    with pytest.raises(tfaults.InjectedCrash):
        tretry.retry_call(crash, site="gen.decode",
                          policy=tretry.RetryPolicy(base_delay=0.001))
    assert tretry.attempt_log("gen.decode") == []
    fn, calls = _flaky(1, RuntimeError)
    assert tretry.retry_call(fn, site="gen.decode",
                             policy=tretry.RetryPolicy(base_delay=0.001)) == 2
    assert not isinstance(RuntimeError("x"), tretry.device_failures())


def _capture_error():
    return MXNetError("CUDA graph capture of step ('decode', 2, 'paged') "
                      "failed")


@pytest.mark.parametrize("make", [_accelerator_error, _capture_error],
                         ids=["AcceleratorError", "capture"])
@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_batcher_raises_card_failure(where, make):
    """A sticky CUDA error or a failed capture inside a dispatch leaves the
    batcher at once: one attempt, no retry, the request keeps no slot on a
    failed prefill."""
    net = tgpt2.GPT2Model(num_layers=1, units=16, num_heads=2, max_length=32,
                          vocab_size=11, dropout=0.0, device="cpu")
    eng = GenerationEngine(net, batch_size=2, prefill_buckets=(8,),
                           paged=True, page_size=4, device="cpu")
    bat = ContinuousBatcher(eng, device="cpu")
    real = eng._run_program

    exc = make()

    def failing(sig, fn):
        if sig[0] == where:
            raise exc
        return real(sig, fn)

    req = bat.submit(list(np.arange(1, 6)), max_new_tokens=4)
    if where == "decode":
        bat.step()  # admitted
    eng._run_program = failing
    with pytest.raises(type(exc)) as info:
        bat.step()
    assert info.value is exc
    site = f"gen.{where}"
    assert [a["ok"] for a in tretry.attempt_log(site)][-1:] == [False]
    assert sum(not a["ok"] for a in tretry.attempt_log(site)) == 1
    if where == "prefill":
        assert req.slot is None and bat.pending == 1 and bat.active == 0

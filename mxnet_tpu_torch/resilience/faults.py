"""Deterministic fault-injection registry: a copy of
``mxnet_tpu/resilience/faults.py`` with the same trigger semantics.

Call sites are annotated with a named *fault site* (``fire(site)``); this
module decides, fully deterministically, whether that invocation fails.
Arming is programmatic (``arm`` / the ``inject`` context manager, for
tests) or declarative via ``MXNET_TPU_FAULTS`` (the ``faults`` knob), so
every recovery path is testable on the CPU with no real failure.

Two failure flavours:

  - :class:`InjectedFault` (an ``IOError``) — a *transient* failure the
    retry layer (``resilience.retry``) is expected to absorb;
  - :class:`InjectedCrash` (a ``BaseException``) — simulated process death
    mid-operation. It deliberately does NOT derive from ``Exception`` so no
    retry/except block can swallow it.

The port's sites (the JAX package's DCN and kvstore sites come with the
slices that port those paths):

  ======================  ====================================================
  ``ckpt.save``           inside ``save_train_state`` — after the array data
                          is written, before the manifest/commit rename
                          (a crash there leaves a torn ``ckpt-N.tmp``)
  ``ckpt.load``           inside ``load_train_state`` — before reading arrays
  ``data.batch``          one DataLoader batch fetch/batchify
  ``gen.prefill``         ``GenerationEngine.prefill`` — before any page
                          allocation or dispatch, so a retried admission
                          replays cleanly (``ContinuousBatcher`` wraps it
                          in ``retry_call``)
  ``gen.decode``          one serving decode dispatch — fired at the top of
                          ``decode_step``/``plain_step`` and of each
                          speculative round, before any allocator mutation
  ``gen.verify``          the speculative verify dispatch — fired after the
                          draft program ran, retried inside ``spec_step``
                          (the round's host state is re-entrant there)
  ======================  ====================================================

Env grammar (entries separated by ``;``, options by ``:``)::

  MXNET_TPU_FAULTS="gen.prefill:every=3;gen.decode:on=2:times=2;seed=1234"

  on=N      fire on the Nth invocation of the site (1-based)
  every=K   fire on every Kth invocation (periodic transient noise)
  times=M   total number of firings before the trigger disarms (default:
            unlimited for every=, 1 for on=)
  p=F       fire with probability F per invocation, drawn from a
            ``random.Random`` stream seeded by (seed, crc32(site)) —
            deterministic for a fixed seed (the ``seed=N`` entry, default 0)
  crash     raise InjectedCrash instead of InjectedFault
"""
from __future__ import annotations

import contextlib
import logging
import random as _random
import threading
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "InjectedCrash", "arm", "disarm", "reset",
           "fire", "inject", "count", "armed", "load_spec", "reload_from_env"]

logger = logging.getLogger("mxnet_tpu_torch.resilience.faults")


class InjectedFault(IOError):
    """A transient injected failure — the retry layer should absorb it."""

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected fault at site {site!r} (invocation {invocation})")
        self.site = site
        self.invocation = invocation


class InjectedCrash(BaseException):
    """Simulated process death at a fault site.

    Derives from BaseException so that no framework-level ``except
    Exception`` (including the retry layer) can absorb it — exactly like a
    SIGKILL, the operation stops where it stood and only a fresh process
    sees the aftermath.
    """

    def __init__(self, site: str, invocation: int):
        super().__init__(f"injected crash at site {site!r} (invocation {invocation})")
        self.site = site
        self.invocation = invocation


class _Trigger:
    def __init__(self, on: Optional[int] = None, every: Optional[int] = None,
                 p: Optional[float] = None, times: Optional[int] = None,
                 crash: bool = False, seed: int = 0, site: str = ""):
        if sum(x is not None for x in (on, every, p)) != 1:
            raise ValueError("exactly one of on=/every=/p= must be given")
        self.on = on
        self.every = every
        self.p = p
        self.times = times if times is not None else (1 if on is not None else None)
        self.crash = crash
        # per-(seed, site) stream so p= triggers are reproducible and
        # independent across sites; crc32 not hash() — str hashing is
        # randomized per interpreter, which would break the fixed-seed
        # reproducibility contract
        import zlib

        self._rng = _random.Random((seed << 32) ^ zlib.crc32(site.encode())) \
            if p is not None else None

    def matches(self, invocation: int) -> bool:
        if self.times is not None and self.times <= 0:
            return False
        if self.on is not None:
            hit = invocation == self.on
        elif self.every is not None:
            hit = invocation % self.every == 0
        else:
            hit = self._rng.random() < self.p
        if hit and self.times is not None:
            self.times -= 1
        return hit


_triggers: Dict[str, List[_Trigger]] = {}
_counts: Dict[str, int] = {}
_active = False
_env_loaded = False
# fire() may run on other threads while a test thread arms/disarms — one
# lock covers both registries
_lock = threading.Lock()
# guards the one-shot env-spec load (see _ensure_env)
_env_lock = threading.Lock()


def _recompute_active() -> None:
    global _active
    _active = any(_triggers.values())


def armed() -> bool:
    """Fast check used by hot call sites to skip counter bookkeeping."""
    _ensure_env()
    return _active


def arm(site: str, on: Optional[int] = None, every: Optional[int] = None,
        p: Optional[float] = None, times: Optional[int] = None,
        crash: bool = False, seed: int = 0) -> None:
    """Arm ``site`` to fail. See module docstring for trigger semantics."""
    with _lock:
        _triggers.setdefault(site, []).append(
            _Trigger(on=on, every=every, p=p, times=times, crash=crash,
                     seed=seed, site=site))
        _recompute_active()
    logger.info("fault armed: site=%s on=%s every=%s p=%s times=%s crash=%s",
                site, on, every, p, times, crash)


def disarm(site: Optional[str] = None) -> None:
    """Remove triggers for ``site`` (all sites when None); counters stay."""
    with _lock:
        if site is None:
            _triggers.clear()
        else:
            _triggers.pop(site, None)
        _recompute_active()


def reset() -> None:
    """Disarm everything and zero all invocation counters."""
    with _lock:
        _triggers.clear()
        _counts.clear()
        _recompute_active()


def count(site: str) -> int:
    """How many times ``site`` has fired its invocation counter.

    Counting only happens while any trigger is armed (the fast path is a
    single bool check), so this is a debugging/testing aid, not telemetry.
    """
    return _counts.get(site, 0)


def fire(site: str) -> None:
    """Mark one invocation of ``site``; raise if an armed trigger matches."""
    _ensure_env()
    if not _active:
        return
    fired = None
    with _lock:
        n = _counts.get(site, 0) + 1
        _counts[site] = n
        # matches() mutates trigger state (times countdown, RNG draw), so
        # it must run under the same lock as the registries — two threads
        # racing a times=1 trigger would otherwise both see times==1 and
        # fire it twice
        for trig in _triggers.get(site, ()):
            if trig.matches(n):
                fired = trig
                break
    if fired is not None:
        exc = InjectedCrash(site, n) if fired.crash else InjectedFault(site, n)
        logger.warning("fault fired: site=%s invocation=%d kind=%s",
                       site, n, type(exc).__name__)
        raise exc


@contextlib.contextmanager
def inject(site: str, **kwargs):
    """Arm ``site`` for the duration of a ``with`` block, then restore the
    site's previous triggers (counters are left running)."""
    prev = list(_triggers.get(site, ()))
    arm(site, **kwargs)
    try:
        yield
    finally:
        with _lock:
            if prev:
                _triggers[site] = prev
            else:
                _triggers.pop(site, None)
            _recompute_active()


def load_spec(spec: str) -> None:
    """Arm sites from a ``MXNET_TPU_FAULTS``-grammar string."""
    entries = [e.strip() for e in spec.split(";") if e.strip()]
    seed = 0
    body = []
    for entry in entries:  # seed= applies to all p= entries, wherever written
        if entry.startswith("seed="):
            seed = int(entry[5:])
        else:
            body.append(entry)
    for entry in body:
        parts = entry.split(":")
        site, opts = parts[0], parts[1:]
        kw: dict = {"seed": seed}
        for o in opts:
            if o == "crash":
                kw["crash"] = True
            elif "=" in o:
                k, v = o.split("=", 1)
                if k in ("on", "every", "times"):
                    kw[k] = int(v)
                elif k == "p":
                    kw["p"] = float(v)
                else:
                    raise ValueError(f"unknown fault option {o!r} in {entry!r}")
            else:
                raise ValueError(f"unknown fault option {o!r} in {entry!r}")
        arm(site, **kw)


def _ensure_env() -> None:
    global _env_loaded
    # double-checked under its own lock: two worker threads racing the
    # first fire() must not both load the env spec and arm every trigger
    # twice (a times=1 trigger would fire twice, breaking the fixed-seed
    # chaos schedule). A separate lock because load_spec -> arm() takes
    # _lock; the second thread blocks here until the triggers are armed.
    if _env_loaded:
        return
    with _env_lock:
        if _env_loaded:
            return
        # flag flips in the `finally`, AFTER the load: the unlocked
        # fast-path above may only skip the lock once the triggers are
        # fully armed (otherwise an early fire() escapes the fixed-seed
        # schedule); racing threads block on _env_lock until then. The
        # `finally` also makes the load strictly one-shot — a malformed
        # tail entry must not leave the valid head re-armed on every
        # later fire()
        try:
            from .. import config

            spec = config.get("faults")
            if spec:
                load_spec(spec)
        finally:
            _env_loaded = True


def reload_from_env() -> None:
    """Re-read ``MXNET_TPU_FAULTS`` (tests that mutate the env call this)."""
    global _env_loaded
    reset()
    _env_loaded = False
    _ensure_env()

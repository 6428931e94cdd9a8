"""Slot-based continuous batching over a :class:`GenerationEngine`.

Counterpart of ``mxnet_tpu/inference/batcher.py`` (the serving subset).
The decode batch is a fixed (B, ...) shape and a *slot* is one row of it.
Queued requests are admitted FIFO into free slots at step boundaries, by a
batch-1 prefill into one cache row; a request holds its slot only once
its prefill has returned. Finished rows (EOS, token budget, cache end,
page exhaustion) free their slot and pages for the next request.

On a paged engine admission is bounded by pages: the queue head is
admitted when ``available_pages`` (free pages plus prefix-cache pages that
eviction could free) covers ``pages_needed`` (the pages its prefill takes
after adopting a cached prefix). While the head is parked on pages, later
requests that the unreserved free pages cover may bypass it (the head
keeps its place), until the aging guard (``serve_head_aging_steps``
deferred boundaries) stops the bypass and reserves freed pages for the
head (``engine.reserve_pages``). A head whose cached prefix was evicted
while it queued, and that no bucket can take without it, finishes as
``"shed"``.

``submit(..., samples=N)`` asks for N samples of one prompt: the leader
prefills once, and its N - 1 siblings are admitted by copy-on-write fork
(``engine.fork_slot``), each with its own first token drawn from the
leader's prefill logits. A sibling left queued when its leader finished
falls back to an ordinary prefill.

On a speculative engine every step is one draft + verify round
(``engine.spec_step``) that appends up to the row's emitted count to each
request, and finishes a request whose budget ends inside the window.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional, Sequence

from .. import config as _config
from ..base import MXNetError, resolve_device

__all__ = ["ContinuousBatcher", "GenRequest", "FINISH_REASONS"]

#: every way a request of this batcher can terminate
FINISH_REASONS = ("eos", "length", "cache_full", "page_exhausted", "shed")


class GenRequest:
    """Handle for one submitted generation request."""

    def __init__(self, req_id: int, prompt, max_new_tokens: int):
        self.id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.output: List[int] = []
        self.slot: Optional[int] = None
        #: one of FINISH_REASONS once done
        self.finish_reason: Optional[str] = None
        self.submit_t = time.perf_counter()
        self.first_token_t: Optional[float] = None
        #: decode steps (or speculative rounds) this request rode
        self.rounds = 0
        #: ``samples=N``: the leader this sibling forks from at admission
        #: (None = independent), and on the leader the group's handles
        self._fork_of: Optional["GenRequest"] = None
        self.samples: Optional[List["GenRequest"]] = None
        #: True when admitted by a copy-on-write fork instead of a prefill
        self.forked = False

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def result(self) -> List[int]:
        if not self.done:
            raise RuntimeError(f"request {self.id} still running")
        return list(self.output)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submit_t


class ContinuousBatcher:
    """FIFO admission of queued requests into free decode slots.
    ``head_aging_steps`` defaults to the ``serve_head_aging_steps`` knob."""

    def __init__(self, engine, device="cuda",
                 head_aging_steps: Optional[int] = None):
        dev = resolve_device(device)
        if engine.device != dev:
            raise MXNetError(f"engine is on {engine.device}, batcher asked "
                             f"for {dev}")
        self.engine = engine
        self._queue: deque = deque()
        self._slots: List[Optional[GenRequest]] = [None] * engine.batch_size
        self._ids = itertools.count()
        self.head_aging_steps = int(
            head_aging_steps if head_aging_steps is not None
            else _config.get("serve_head_aging_steps"))
        self._head_id: Optional[int] = None
        self._head_deferrals = 0

    # -- client side ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               samples: int = 1) -> GenRequest:
        """Queue a request; with ``samples=N`` (paged engines) N samples of
        one prompt, whose handles land on the returned leader's
        ``samples``. Raises ``ValueError`` for a request that could never
        be served: a token id outside ``[0, vocab)``, no prefill bucket
        (unless a cached prefix shrinks the suffix into one), or more pages
        than the pool."""
        eng = self.engine
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if samples < 1:
            raise ValueError("samples must be >= 1")
        if samples > 1 and not eng.paged:
            raise ValueError("samples > 1 needs a paged engine "
                             "(copy-on-write fork)")
        if not all(0 <= int(t) < eng._vocab for t in prompt):
            raise ValueError(f"prompt token ids must lie in [0, {eng._vocab})")
        try:
            eng.bucket_for(len(prompt))  # reject oversize prompts now
        except ValueError:
            # a prompt longer than every bucket is still admissible when a
            # cached prefix shrinks its suffix into one
            if not (eng.paged and eng.prefix_cache is not None
                    and eng.can_admit(prompt)):
                raise
        if eng.paged and eng.pages_for(len(prompt)) > eng.num_pages:
            raise ValueError(
                f"prompt needs {eng.pages_for(len(prompt))} pages; the "
                f"whole pool holds {eng.num_pages}")
        req = GenRequest(next(self._ids), prompt, max_new_tokens)
        self._queue.append(req)
        if samples > 1:
            req.samples = [req]
            for _ in range(samples - 1):
                sib = GenRequest(next(self._ids), prompt, max_new_tokens)
                sib._fork_of = req
                req.samples.append(sib)
                self._queue.append(sib)
        return req

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slots)

    # -- serving loop --------------------------------------------------------
    def _finish(self, slot: int, reason: str):
        req = self._slots[slot]
        self._slots[slot] = None
        if (reason in ("eos", "length", "cache_full")
                and self.engine.prefix_cache is not None):
            # index the finished sequence's full pages before the release,
            # so that a next turn (prompt + output + more) adopts them
            self.engine.cache_sequence(slot, list(req.prompt)
                                       + [int(t) for t in req.output])
        self.engine.release_slot(slot)
        req.finish_reason = reason

    def _start(self, slot: int, req: GenRequest, tok: int):
        """Seat an admitted request in ``slot`` with its first token."""
        req.slot = slot
        self._slots[slot] = req
        req.first_token_t = time.perf_counter()
        req.output.append(tok)

    def _admit_into(self, slot: int, req: GenRequest):
        """One bucketed batch-1 prefill. The request takes the slot only
        once the prefill has returned: a prefill that raises leaves the slot
        free and puts the request back at the head of the queue."""
        try:
            tok = self.engine.prefill(req.prompt, slot)
        except BaseException:
            self._queue.appendleft(req)
            raise
        self._start(slot, req, tok)
        if (req.samples is not None and self.engine.paged
                and not self.engine.done[slot]):
            # fork before the leader can finish: siblings need its pages
            self._admit_forks(req)
        if self.engine.done[slot]:  # first token was EOS
            self._finish(slot, "eos")
        elif req.max_new_tokens == 1:
            self._finish(slot, "length")

    def _admit_forks(self, leader: GenRequest):
        """Admit the leader's still-queued siblings into free slots by
        copy-on-write fork: refcount bumps and one draw from the leader's
        prefill logits, no prefill and no new pages. Siblings that find no
        free slot stay queued."""
        eng = self.engine
        for sib in [r for r in self._queue if r._fork_of is leader]:
            if eng.done[leader.slot]:
                break  # the leader finished (a sampled EOS on a fork)
            slot = next((s for s in range(eng.batch_size)
                         if self._slots[s] is None), None)
            if slot is None:
                break
            self._queue.remove(sib)
            sib.forked = True
            self._start(slot, sib, eng.fork_slot(leader.slot, slot,
                                                 resample_first=True))
            if eng.done[slot]:  # the resampled first token was EOS
                self._finish(slot, "eos")
            elif sib.max_new_tokens == 1:
                self._finish(slot, "length")

    def _admit(self):
        """Step-boundary admission: fill free slots FIFO, bounded by pages
        on a paged engine (see the module docstring)."""
        eng = self.engine
        if eng.paged and eng.prefix_cache is not None:
            # a head admitted past the bucket check on the strength of a
            # cached prefix may have lost it to eviction while it queued
            while self._queue and not eng.can_admit(self._queue[0].prompt):
                self._queue.popleft().finish_reason = "shed"
        deferral_counted = False
        for slot in range(eng.batch_size):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            head = self._queue[0]
            if not eng.paged:
                self._admit_into(slot, self._queue.popleft())
                continue
            need = eng.pages_needed(head.prompt)
            if eng.available_pages >= need:
                eng.reserve_pages(0)
                self._head_id = None
                self._head_deferrals = 0
                self._admit_into(slot, self._queue.popleft())
                continue
            # the head waits for pages: one deferral a boundary
            if not deferral_counted:
                deferral_counted = True
                if head.id != self._head_id:
                    self._head_id = head.id
                    self._head_deferrals = 0
                self._head_deferrals += 1
            if (self.head_aging_steps > 0
                    and self._head_deferrals > self.head_aging_steps):
                # aging guard: stop the bypass, hold freed pages for the head
                eng.reserve_pages(need)
                break
            # bypass: the first later request the unreserved pool covers
            avail = eng.free_pages - eng.reserved_pages
            cand = next((i for i in range(1, len(self._queue))
                         if eng.pages_needed(self._queue[i].prompt)
                         <= avail), None)
            if cand is None:
                break
            req = self._queue[cand]
            del self._queue[cand]
            self._admit_into(slot, req)
        if not self._queue:
            self._head_id = None
            self._head_deferrals = 0
            if eng.paged and eng.reserved_pages:
                eng.reserve_pages(0)

    def _done_reason(self, slot: int, last_token) -> str:
        """Why the engine marked this row done: a sampled EOS, a forced
        cache-end finish, or (paged) a page-pool eviction."""
        if self.engine.paged and bool(self.engine.page_exhausted[slot]):
            return "page_exhausted"
        if (self.engine.eos_id is not None
                and last_token == self.engine.eos_id):
            return "eos"
        if self.engine.positions[slot] >= self.engine.max_length:
            return "cache_full"
        return "eos"

    def step(self) -> bool:
        """Admit, then run one decode step (one draft + verify round on a
        speculative engine). Returns True while any work (active rows or
        queued requests) remains."""
        self._admit()
        if self.active == 0:
            return bool(self._queue)
        was_active = [s for s, r in enumerate(self._slots) if r is not None]
        if self.engine.speculative:
            toks, counts, done = self.engine.spec_step()
            for slot in was_active:
                req = self._slots[slot]
                req.rounds += 1
                n = int(counts[slot])
                room = req.max_new_tokens - len(req.output)
                req.output.extend(int(t) for t in toks[slot, :min(n, room)])
                if room < n:  # the budget ended inside the window
                    self._finish(slot, "length")
                elif done[slot]:
                    self._finish(slot, self._done_reason(
                        slot, req.output[-1] if req.output else None))
                elif len(req.output) >= req.max_new_tokens:
                    self._finish(slot, "length")
            return bool(self._queue) or self.active > 0
        tok, done, _ = self.engine.decode_step()
        for slot in was_active:
            req = self._slots[slot]
            req.rounds += 1
            if (self.engine.paged and done[slot]
                    and bool(self.engine.page_exhausted[slot])):
                # evicted BEFORE the step: the row emitted pad this step,
                # not a token
                self._finish(slot, "page_exhausted")
                continue
            req.output.append(int(tok[slot]))
            if done[slot]:
                self._finish(slot, self._done_reason(slot, req.output[-1]))
            elif len(req.output) >= req.max_new_tokens:
                self._finish(slot, "length")
        return bool(self._queue) or self.active > 0

    def run(self, max_steps: Optional[int] = None) -> int:
        """Drive steps until queue and slots are empty (or ``max_steps``).
        Returns the number of steps taken."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

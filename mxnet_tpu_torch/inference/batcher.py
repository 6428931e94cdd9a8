"""Slot-based continuous batching over a :class:`GenerationEngine`.

Counterpart of ``mxnet_tpu/inference/batcher.py`` (the serving subset).
The decode batch is a fixed (B, ...) shape and a *slot* is one row of it.
Queued requests are admitted FIFO into free slots at step boundaries, by a
batch-1 prefill into one cache row. On a paged engine the queue head is
admitted only when the free pages cover its prompt; until then it, and
everything behind it, waits. Finished rows (EOS, token budget, cache end,
page exhaustion) free their slot and pages for the next request.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import List, Optional, Sequence

from ..base import MXNetError, resolve_device

__all__ = ["ContinuousBatcher", "GenRequest", "FINISH_REASONS"]

#: every way a request of this batcher can terminate
FINISH_REASONS = ("eos", "length", "cache_full", "page_exhausted")


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
    """FIFO admission of queued requests into free decode slots."""

    def __init__(self, engine, device="cuda"):
        dev = resolve_device(device)
        if engine.device != dev:
            raise MXNetError(f"engine is on {engine.device}, batcher asked "
                             f"for {dev}")
        self.engine = engine
        self._queue: deque = deque()
        self._slots: List[Optional[GenRequest]] = [None] * engine.batch_size
        self._ids = itertools.count()

    # -- client side ---------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32) -> GenRequest:
        """Queue a request. Raises ``ValueError`` for a prompt that could
        never be served (no prefill bucket, or more pages than the pool)."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        self.engine.bucket_for(len(prompt))  # reject oversize prompts now
        if (self.engine.paged
                and self.engine.pages_for(len(prompt)) > self.engine.num_pages):
            raise ValueError(
                f"prompt needs {self.engine.pages_for(len(prompt))} pages; "
                f"the whole pool holds {self.engine.num_pages}")
        req = GenRequest(next(self._ids), prompt, max_new_tokens)
        self._queue.append(req)
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
        self.engine.release_slot(slot)
        req.finish_reason = reason

    def _admit(self):
        eng = self.engine
        for slot in range(eng.batch_size):
            if not self._queue:
                break
            if self._slots[slot] is not None:
                continue
            head = self._queue[0]
            if eng.paged and eng.free_pages < eng.pages_for(len(head.prompt)):
                break  # the head waits for pages; FIFO keeps the rest behind
            req = self._queue.popleft()
            req.slot = slot
            self._slots[slot] = req
            req.output.append(eng.prefill(req.prompt, slot))
            req.first_token_t = time.perf_counter()
            if eng.done[slot]:  # first token was EOS
                self._finish(slot, "eos")
            elif req.max_new_tokens == 1:
                self._finish(slot, "length")

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
        """Admit, then run one decode step. Returns True while any work
        (active rows or queued requests) remains."""
        self._admit()
        if self.active == 0:
            return bool(self._queue)
        was_active = [s for s, r in enumerate(self._slots) if r is not None]
        tok, done, _ = self.engine.decode_step()
        for slot in was_active:
            req = self._slots[slot]
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

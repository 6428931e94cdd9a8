"""KV-cache generation engine over a static decode batch.

Counterpart of ``mxnet_tpu/inference/engine.py`` (the serving subset):

  - **prefill**: the prompt, padded to a bucket length, runs one cached
    causal forward that writes its K/V into one row of the cache and
    samples the first token. Other rows are untouched.
  - **decode**: one token for every row of the static batch: cache update,
    attention over the history, sampling, per-row EOS done-masking.
  - **paged cache** (``paged=True``): K/V live in a global pool of
    fixed-size pages and each row owns a page table. A host allocator
    hands out pages, page 0 is the trash page, rows that cannot cover their
    next write are force-finished (``page_exhausted``), and a released
    row's device table row is zeroed before the next step writes anything.

Where the JAX engine runs each step as one compiled, donated program
(``_prefill_jit`` per prompt bucket, ``_decode_jit``), this one runs it as
one captured CUDA graph per step signature (``ops/cuda_graph.py``), all of
an engine's graphs in one memory pool since they never run at once. The
graphs read static device buffers that each step fills before its replay:
the tokens, the positions, the prefill's page-table row (or, dense, its
slot) and the index of the last prompt token. The caches are updated in
place. Sampling runs after the replay, from a copy of the graph's logits,
with the engine's own ``torch.Generator``. ``compiled_programs`` counts the
signatures as the JAX engine does: ``("prefill", bucket)`` and ``("decode",
B, "paged")`` or ``("decode", B)``. With ``engine_type="naive"`` the same
step functions run eagerly at every call, over the same static buffers;
on the CPU they always do.

The host state (``positions``, ``done``, ``last_tokens``, the allocator)
stays numpy on the host; each step ships only the (B,) vectors to the
device.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as _config
from ..base import MXNetError, resolve_device
from ..ops import cuda_graph as _cg
from ..ops import sampling as _sampling

__all__ = ["GenerationEngine", "SamplingConfig"]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Decode-time sampling."""

    method: str = "greedy"  # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 40
    seed: int = 0

    def __post_init__(self):
        if self.method not in ("greedy", "temperature", "top_k"):
            raise ValueError(f"unknown sampling method {self.method!r}")


def _default_buckets(max_length: int) -> Tuple[int, ...]:
    out, b = [], 16
    while b < max_length:
        out.append(b)
        b *= 2
    return tuple(out) or (max_length - 1,)


class GenerationEngine:
    """Autoregressive generation over a static decode batch.

    Parameters
    ----------
    net : GPT2Model (or a module with the same cached ``forward`` and
        ``init_cache``/``init_paged_cache``), on ``device``.
    batch_size : rows of the static decode batch (= serving slots).
    max_length : per-row sequence capacity (default: the net's).
    prefill_buckets : ascending prompt-length buckets (default: powers of
        two from 16 below ``max_length``).
    eos_id : token that finishes a row; None = rows finish by length only.
    pad_id : token emitted by finished rows and used for prompt padding.
    sampling : SamplingConfig or method name.
    cache_dtype : dtype of the K/V cache.
    paged, page_size, num_pages : the paged cache; ``num_pages`` defaults
        to the dense-equivalent ``batch_size * ceil(max_length/page_size)``.
    device : where the engine runs; the default is the card.
    engine_type : "graph" (one captured CUDA graph per step signature) or
        "naive" (eager steps); None reads the ``engine_type`` knob.
    """

    def __init__(self, net, batch_size: int = 4, max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 sampling=None, cache_dtype: str = "float32",
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda",
                 engine_type: Optional[str] = None):
        self.engine_type = _config.resolve("engine_type", engine_type)
        self.device = resolve_device(device)
        if net.device != self.device:
            raise MXNetError(f"net is on {net.device}, engine on {self.device}")
        self.net = net.eval()
        self.batch_size = int(batch_size)
        self.max_length = int(max_length or net._max_length)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.pad_id = int(pad_id)
        if sampling is None:
            sampling = SamplingConfig()
        elif isinstance(sampling, str):
            sampling = SamplingConfig(method=sampling)
        self.sampling = sampling
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(sampling.seed))
        buckets = tuple(sorted(prefill_buckets or
                               _default_buckets(self.max_length)))
        if not buckets or buckets[-1] >= self.max_length:
            raise ValueError(f"prefill buckets {buckets} must be non-empty "
                             f"and < max_length={self.max_length}")
        self.prefill_buckets = buckets
        self._vocab = int(net.word_embed._input_dim)

        self.paged = bool(paged)
        self.page_size = int(page_size)
        if self.paged:
            if self.page_size < 1:
                raise ValueError("page_size must be >= 1")
            #: page-table width: page slots per row (slot s holds
            #: positions s*ps .. (s+1)*ps - 1)
            self._n_row_pages = -(-self.max_length // self.page_size)
            self.num_pages = int(self.batch_size * self._n_row_pages
                                 if num_pages is None else num_pages)
            if self.num_pages < 1:
                raise ValueError("num_pages must be >= 1")
            #: device per-row page tables (0 = unallocated/trash)
            self.page_table = torch.zeros(
                (self.batch_size, self._n_row_pages), dtype=torch.int32,
                device=self.device)
            self.pools = net.init_paged_cache(self.num_pages, self.page_size,
                                              dtype=cache_dtype)
            self.cache = None
            # host allocator (authoritative; the device table mirrors it)
            self._free_pages: deque = deque(range(1, self.num_pages + 1))
            self._row_pages: List[List[int]] = \
                [[] for _ in range(self.batch_size)]
            self._pending_clear: set = set()
            #: rows force-finished because the pool ran dry
            self.page_exhausted = np.zeros(self.batch_size, bool)
        else:
            self.cache = net.init_cache(self.batch_size, self.max_length,
                                        dtype=cache_dtype)

        self.positions = np.zeros(self.batch_size, np.int32)
        self.done = np.ones(self.batch_size, bool)  # empty slots are "done"
        self.last_tokens = np.full(self.batch_size, self.pad_id, np.int32)

        self._signatures: set = set()  # step signatures run so far
        self._programs = {}  # (signature, capture state) -> StepGraph
        self._init_static()

    def _init_static(self):
        """The device buffers the step programs read, filled before each
        call; under "graph" on the card, the stream the graphs are
        captured on and one memory pool for all of them."""
        dev, b = self.device, self.batch_size
        self._in_tokens = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self._in_positions = torch.zeros(b, dtype=torch.int32, device=dev)
        self._in_prompt = {}  # bucket -> (1, bucket) int64
        self._in_start = torch.zeros(1, dtype=torch.int32, device=dev)
        self._in_last = torch.zeros(1, dtype=torch.int64, device=dev)
        # the prefill's table: the slot's page-table row (paged), or the
        # slot itself over the dense cache viewed as B pages of max_length
        # slots, so that one graph per bucket serves every slot
        self._in_table = torch.zeros(
            (1, self._n_row_pages) if self.paged else (1, 1),
            dtype=torch.int32, device=dev)
        self._capture = self.engine_type == "graph" and dev.type == "cuda"
        self._stream = _cg.capture_stream(self, dev) if self._capture \
            else None
        self._pool = _cg.GraphPool() if self._capture else None

    # -- program accounting --------------------------------------------------
    @property
    def compiled_programs(self) -> int:
        """Step programs this engine has run: the prefill buckets used, plus
        the decode step. Under "graph" each is one captured CUDA graph."""
        return len(self._signatures)

    def _note_program(self, sig) -> None:
        self._signatures.add(sig)

    def _run_program(self, sig, fn):
        """The outputs of the step graph of ``sig`` (built from ``fn`` on
        first use)."""
        key = (sig, _cg.capture_state())
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = _cg.StepGraph(
                fn, sig, self.device, stream=self._stream, pool=self._pool,
                capture=self._capture)
        return prog()

    def _put(self, dst, array) -> None:
        """Copy a host array into a static device buffer: from pinned memory
        without waiting, on the card. Every step ends in a host sync, so the
        copy has landed before the next step writes the same buffer."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            dst.copy_(src.pin_memory(), non_blocking=True)
        else:
            dst.copy_(src)

    # -- page accounting (paged mode) ----------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages) if self.paged else 0

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free_pages) if self.paged else 0

    def pages_for(self, length: int) -> int:
        """Pages a ``length``-token sequence occupies."""
        return -(-int(length) // self.page_size)

    def _reclaim_row(self, slot: int) -> int:
        pages = self._row_pages[slot]
        self._row_pages[slot] = []
        self._free_pages.extend(pages)
        return len(pages)

    def _grow_pages(self, window: int):
        """Allocate pages so every active row's table covers positions
        ``p .. min(p + window, max_length - 1)``; rows that cannot cover
        their next write are force-finished (``page_exhausted``). Returns
        the (row, slot, page) entries to install in the device table."""
        ps = self.page_size
        updates = []
        for row in range(self.batch_size):
            if self.done[row]:
                continue
            p = int(self.positions[row])
            need = min(p + window, self.max_length - 1) // ps + 1
            while len(self._row_pages[row]) < need:
                if not self._free_pages:
                    if len(self._row_pages[row]) * ps <= p:
                        # cannot write the next token: evict the row
                        self.done[row] = True
                        self.page_exhausted[row] = True
                    break
                pid = self._free_pages.popleft()
                updates.append((row, len(self._row_pages[row]), pid))
                self._row_pages[row].append(pid)
        return updates

    def _take_clear_mask(self) -> List[int]:
        """Rows released since the last step: their device table rows are
        zeroed BEFORE any write, so a released row's writes go to the trash
        page and never into a page handed to someone else."""
        rows = sorted(self._pending_clear)
        self._pending_clear.clear()
        return rows

    def _apply_table_updates(self, updates, clear) -> None:
        """Install newly allocated pages, then zero the released rows."""
        if updates:
            idx = torch.tensor(updates, dtype=torch.int64).t().to(self.device)
            self.page_table[idx[0], idx[1]] = idx[2].to(torch.int32)
        if clear:
            self.page_table[torch.tensor(clear, device=self.device)] = 0

    # -- sampling ------------------------------------------------------------
    def _sample(self, logits2d):
        cfg = self.sampling
        if cfg.method == "greedy":
            return torch.argmax(logits2d, dim=-1).to(torch.int32)
        if cfg.method == "temperature":
            return _sampling.temperature_sampling(
                logits2d, temperature=cfg.temperature,
                generator=self._generator)
        return _sampling.top_k_sampling(logits2d, k=cfg.top_k,
                                        temperature=cfg.temperature,
                                        generator=self._generator)

    # -- host API ------------------------------------------------------------
    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(f"prompt length {length} exceeds largest prefill "
                         f"bucket {self.prefill_buckets[-1]}")

    def _cache(self):
        return self.pools if self.paged else self.cache

    @torch.inference_mode()
    def prefill(self, prompt, slot: int) -> int:
        """Admit a prompt into row ``slot``: write its K/V into the cache
        and sample the first new token (returned as a host int: this sync
        is the time-to-first-token point). In paged mode, allocates
        ``pages_for(len(prompt))`` pages up front and raises RuntimeError
        if the pool cannot cover them."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        length = prompt.size
        if not 0 < length:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.batch_size:
            raise ValueError(f"slot {slot} out of range")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            raise ValueError(f"prompt token ids must lie in [0, {self._vocab})")
        bucket = self.bucket_for(length)
        padded = np.full((1, bucket), self.pad_id, np.int64)
        padded[0, :length] = prompt
        new_row = None
        if self.paged:
            if length >= self.max_length:
                raise ValueError(f"prompt length {length} >= max_length="
                                 f"{self.max_length}")
            need = self.pages_for(length)
            # capacity check BEFORE any allocator mutation
            if len(self._free_pages) + len(self._row_pages[slot]) < need:
                raise RuntimeError(
                    f"insufficient free pages for a {length}-token prompt "
                    f"({need} needed, {len(self._free_pages)} free); release "
                    "slots or raise num_pages")
            self._reclaim_row(slot)  # previous occupant's pages, if any
            self._pending_clear.discard(slot)  # the new row replaces it
            self.page_exhausted[slot] = False
            pages = [self._free_pages.popleft() for _ in range(need)]
            self._row_pages[slot] = pages
            new_row = np.zeros(self._n_row_pages, np.int32)
            new_row[:need] = pages
        self._note_program(("prefill", bucket))
        last = self._prefill_program(padded, slot, length, new_row)
        tok = int(self._sample(last[None, :])[0])  # host sync: TTFT
        self.positions[slot] = length
        self.last_tokens[slot] = tok
        self.done[slot] = (self.eos_id is not None and tok == self.eos_id)
        self._last_logits = last
        return tok

    def _prefill_program(self, padded, slot, length, new_row):
        """The prefill's forward as the step program of its bucket, over
        the static buffers; returns a copy of the last prompt token's logits
        (V,). The LM head runs over the whole bucket and the last row is
        taken by a device index, so one program serves every length."""
        bucket = padded.shape[1]
        buf = self._in_prompt.get(bucket)
        if buf is None:
            buf = self._in_prompt[bucket] = torch.zeros(
                (1, bucket), dtype=torch.int64, device=self.device)
        if self.paged:
            self._put(self.page_table[slot], new_row)
            self._in_table.copy_(self.page_table[slot:slot + 1])
        else:
            self._put(self._in_table, np.full((1, 1), slot, np.int32))
        self._put(buf, padded)
        self._put(self._in_last, np.array([length - 1], np.int64))
        # the step reads no attribute of the engine (no cycle through the
        # program, which would keep the graphs' pool alive)
        net, cache, start = self.net, self._cache(), self._in_start
        table, last_idx = self._in_table, self._in_last

        def step():
            logits, _ = net(buf, cache=cache, start_pos=start,
                            page_table=table)
            return (logits[0].index_select(0, last_idx),)

        (last,) = self._run_program(("prefill", bucket), step)
        return last[0].clone()

    @torch.inference_mode()
    def decode_step(self):
        """One step over the whole batch. Returns ``(next_tokens (B,)
        np.int32, done (B,) np.bool_, logits (B, V) device tensor)``. Rows
        that were already done emit ``pad_id`` and keep their frontier."""
        if self.paged:
            updates = self._grow_pages(0)
            clear = self._take_clear_mask()
            self._apply_table_updates(updates, clear)
        active_in = ~self.done  # exhaustion may have finished rows
        sig = ("decode", self.batch_size) + (("paged",) if self.paged else ())
        self._note_program(sig)
        self._put(self._in_tokens, self.last_tokens.astype(np.int64)[:, None])
        self._put(self._in_positions, self.positions)
        net, cache, tokens = self.net, self._cache(), self._in_tokens
        positions = self._in_positions
        table = self.page_table if self.paged else None

        def step():
            logits, _ = net(tokens, cache=cache, start_pos=positions,
                            page_table=table)
            return (logits[:, 0],)

        logits = self._run_program(sig, step)[0].clone()
        sampled = self._sample(logits).cpu().numpy()
        tok = np.where(self.done, np.int32(self.pad_id), sampled) \
            .astype(np.int32)
        done = self.done.copy()
        if self.eos_id is not None:
            done |= sampled == self.eos_id
        # rows active going into the step consumed one cache index
        self.positions = self.positions + active_in.astype(np.int32)
        # a row whose frontier hit the buffer end cannot take another token
        done |= active_in & (self.positions >= self.max_length)
        self.done = done
        self.last_tokens = tok
        return tok, done, logits

    def release_slot(self, slot: int) -> None:
        """Mark a row free (emits pad, frontier frozen). In paged mode the
        row's pages return to the free pool, and its device table row is
        cleared before the next step writes anything."""
        self.done[slot] = True
        self.last_tokens[slot] = self.pad_id
        if self.paged:
            self._reclaim_row(slot)
            self._pending_clear.add(slot)

    def generate(self, prompts, max_new_tokens: int = 32) -> List[List[int]]:
        """Generate up to ``max_new_tokens`` for each prompt (at most
        ``batch_size`` prompts, one slot each). Returns the generated token
        lists; rows stop at EOS, ``max_new_tokens`` or a full cache."""
        if len(prompts) > self.batch_size:
            raise ValueError(f"{len(prompts)} prompts > batch_size="
                             f"{self.batch_size}; use ContinuousBatcher")
        if self.paged:
            for s in range(self.batch_size):  # park rows + reclaim pages
                self.release_slot(s)
        else:
            self.done[:] = True  # park unused rows
        outs: List[List[int]] = []
        for i, p in enumerate(prompts):
            outs.append([self.prefill(p, slot=i)])
        while True:
            active = [i for i in range(len(prompts))
                      if not self.done[i] and len(outs[i]) < max_new_tokens]
            if not active:
                break
            tok, done, _ = self.decode_step()
            for i in active:
                if self.paged and done[i] and bool(self.page_exhausted[i]):
                    # evicted BEFORE the step (pool ran dry): the row
                    # emitted pad this step, not a token
                    continue
                outs[i].append(int(tok[i]))
                if len(outs[i]) >= max_new_tokens and not self.done[i]:
                    self.release_slot(i)  # cap reached: stop advancing
        return outs

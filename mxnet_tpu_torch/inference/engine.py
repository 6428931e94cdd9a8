"""KV-cache generation engine over a static decode batch.

Counterpart of ``mxnet_tpu/inference/engine.py``:

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
  - **page sharing** (paged): the allocator keeps a refcount per page, so
    a page may back several rows and the prefix cache at once. Only
    refcount-0 pages return to the free list. ``fork_slot`` clones a row
    by refcount bumps; the first write into a shared page gives the
    writing row a private copy first (copy-on-write, the ``("cow", W)``
    program).
  - **prefix cache** (``prefix_cache=True``): a radix tree over the token
    ids of full pages (:class:`RadixPrefixCache`). A prefill adopts the
    longest cached prefix by refcount bumps and runs only the suffix,
    through the same per-bucket program with the start offset in a static
    buffer, so a hit adds no program. Under page pressure cache-only
    (refcount-1) pages are evicted, least recently used first.
  - **speculative decoding** (``draft_net=``, ``speculate_k=``): the draft
    model proposes k tokens through its own page pools (which share the
    target's page table) in one ``("draft", B, k)`` program of k + 1 draft
    steps, and one ``("verify", B, k)`` program scores all k + 1 positions
    with the target. Greedy rounds accept the longest drafted prefix the
    target's own argmax agrees with; stochastic rounds accept by rejection
    sampling (``u q < p``, the first rejection resampled from the residual
    ``max(p - q, 0)``, a bonus token from p_k on a full accept), so the
    emitted tokens are distributed as plain sampled decode.

Where the JAX engine runs each step as one compiled, donated program
(``_prefill_jit`` per prompt bucket, ``_decode_jit``, ``_draft_jit``,
``_verify_jit``, ``_cow_jit``), this one runs it as one captured CUDA
graph per step signature (``ops/cuda_graph.py``), all of an engine's
graphs in one memory pool since they never run at once. The graphs read
static device buffers that each step fills before its replay: the tokens,
the positions, the prefill's page-table row (or, dense, its slot), its
start offset and the index of its last prompt token, the verify's room and
done flags, the copy-on-write entries. The caches and the page table are
updated in place. Plain sampling runs after the replay, from a copy of the
graph's logits, with the engine's own ``torch.Generator``. A stochastic
speculative round samples inside its programs instead: before the round
the engine draws uniforms into static buffers with that generator, and the
programs turn them into Gumbel noise and take argmaxes, so "graph" and
"naive" draw the same tokens. ``compiled_programs`` counts the signatures
as the JAX engine does: ``("prefill", bucket)``, ``("decode", B,
"paged")`` or ``("decode", B)``, ``("draft", B, k)``, ``("verify", B,
k)`` and ``("cow", W)``. With ``engine_type="naive"`` the same step
functions run eagerly at every call, over the same static buffers; on the
CPU they always do.

The host state (``positions``, ``done``, ``last_tokens``, the allocator
and its refcounts) stays numpy on the host; each step ships only small
vectors to the device.

Resilience and telemetry, as in the JAX engine: the fault sites
``gen.prefill`` (top of :meth:`prefill`), ``gen.decode`` (top of a plain
step and of a speculative round) fire before any allocator or page-table
change, so the batcher's ``retry_call`` replays them cleanly;
``gen.verify`` fires between the draft and the verify program and is
retried inside the round under ``retry_policy`` (the draft's writes are
deterministic, and a sampled round's uniforms are drawn once per round).
The ``gen_*`` counters and gauges (pages, prefix hits, copy-on-write,
speculative accept stats) always record; the per-step histograms only
under ``observability.enabled()``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import analysis as _analysis
from .. import config as _config
from .. import observability as _obs
from ..base import MXNetError, resolve_device
from ..ops import cuda_graph as _cg
from ..ops import sampling as _sampling
from ..resilience import faults as _faults
from ..resilience import retry as _retry
from .prefix_cache import RadixPrefixCache

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

    @property
    def stochastic(self) -> bool:
        return self.method != "greedy" and self.temperature > 0


#: the JAX engine's family label of each step program (``_note_program``)
_PROGRAM_FAMILY = {"prefill": "prefill_bucket", "decode": "decode",
                   "draft": "decode", "verify": "verify", "cow": "cow_copy"}


def _default_buckets(max_length: int) -> Tuple[int, ...]:
    out, b = [], 16
    while b < max_length:
        out.append(b)
        b *= 2
    return tuple(out) or (max_length - 1,)


def _sample_logits(cfg: SamplingConfig, logits):
    """The exact logit transform of the stochastic samplers
    (``ops/sampling.py``) under ``cfg``: top-k masking, then temperature.
    Its softmax is the sampling distribution, the p and q of the
    rejection test."""
    if cfg.method == "top_k":
        k, vocab = int(cfg.top_k), logits.shape[-1]
        if 0 < k < vocab:
            kth = torch.topk(logits, k, dim=-1).values[..., -1:]
            logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits.float() / float(cfg.temperature)


def _gumbel(u):
    """Gumbel noise from uniforms in [0, 1): ``argmax(logits + g)`` draws
    from ``softmax(logits)``."""
    return -torch.log(-torch.log(u))


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
    draft_net : a small model on ``device`` that drafts ``speculate_k``
        tokens a round through its own page pools (needs ``paged=True``;
        pass ``net`` itself to self-draft). Its ``max_length`` must cover
        the engine's. Greedy sampling verifies by exact prefix match, a
        stochastic config by rejection sampling.
    speculate_k : draft tokens a speculative round.
    prefix_cache : index computed prompts by their full pages so that later
        prompts sharing a prefix adopt its pages (needs ``paged=True``).
    device : where the engine runs; the default is the card.
    engine_type : "graph" (one captured CUDA graph per step signature) or
        "naive" (eager steps); None reads the ``engine_type`` knob.
    """

    def __init__(self, net, batch_size: int = 4, max_length: Optional[int] = None,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 sampling=None, cache_dtype: str = "float32",
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None, draft_net=None,
                 speculate_k: int = 0, prefix_cache: bool = False,
                 device="cuda", engine_type: Optional[str] = None):
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
        self.speculate_k = int(speculate_k)
        self.draft_net = draft_net
        if (self.speculate_k > 0) != (draft_net is not None):
            raise ValueError("speculative decoding needs BOTH draft_net= "
                             "and speculate_k >= 1")
        if draft_net is not None and not self.paged:
            raise ValueError("speculative decoding rides the paged cache; "
                             "pass paged=True")
        if (self.speculate_k and sampling.method != "greedy"
                and not sampling.stochastic):
            # temperature 0 degenerates to argmax, but the residual of the
            # rejection test would be undefined
            raise ValueError("speculative decoding needs greedy sampling "
                             "or a stochastic config (temperature > 0)")
        if prefix_cache and not self.paged:
            raise ValueError("prefix_cache=True rides the paged allocator; "
                             "pass paged=True")
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
            # the device per-row page tables (0 = unallocated/trash), a
            # view of a flat buffer one entry longer: the copy-on-write
            # program repoints its padding entries at that last entry
            n = self.batch_size * self._n_row_pages
            self._table_flat = torch.zeros(n + 1, dtype=torch.int32,
                                           device=self.device)
            self.page_table = self._table_flat[:n].view(
                self.batch_size, self._n_row_pages)
            self.pools = net.init_paged_cache(self.num_pages, self.page_size,
                                              dtype=cache_dtype)
            self.cache = None
            # host allocator (authoritative; the device table mirrors it)
            self._free_pages: deque = deque(range(1, self.num_pages + 1))
            self._row_pages: List[List[int]] = \
                [[] for _ in range(self.batch_size)]
            self._pending_clear: set = set()
            #: free pages the batcher's aging guard holds back from
            #: decode-time growth for a parked queue head
            self._reserved_pages = 0
            #: rows force-finished because the pool ran dry
            self.page_exhausted = np.zeros(self.batch_size, bool)
            #: per-page refcounts (index 0, the trash page, never counted)
            self._page_rc = np.zeros(self.num_pages + 1, np.int32)
            #: copy-on-write entries per program call
            self._cow_width = self.batch_size
            #: per-slot prefill logits (device (V,)): fork_slot's
            #: resample_first draws from them
            self._prefill_logits = {}
            self.prefix_cache = (RadixPrefixCache(self.page_size)
                                 if prefix_cache else None)
            self._page_gauges()
        else:
            self.cache = net.init_cache(self.batch_size, self.max_length,
                                        dtype=cache_dtype)
            self.prefix_cache = None
        if draft_net is not None:
            if draft_net.device != self.device:
                raise MXNetError(f"draft_net is on {draft_net.device}, "
                                 f"engine on {self.device}")
            if draft_net._max_length < self.max_length:
                raise ValueError(f"draft_net.max_length "
                                 f"{draft_net._max_length} < engine "
                                 f"max_length {self.max_length}")
            self.draft_net = draft_net.eval()
            self.draft_pools = draft_net.init_paged_cache(
                self.num_pages, self.page_size, dtype=cache_dtype)

        #: accept stats of the most recent speculative round (read by the
        #: batcher's degradation governor)
        self.last_round_drafted = 0
        self.last_round_accepted = 0
        #: RetryPolicy for the in-round gen.verify retry (None = config
        #: defaults); ContinuousBatcher installs its own policy here so
        #: one knob governs every serving retry
        self.retry_policy = None
        #: a sampled round's uniforms are drawn, and not yet consumed by a
        #: committed round: a retried round reuses them
        self._noise_drawn = False

        self.positions = np.zeros(self.batch_size, np.int32)
        self.done = np.ones(self.batch_size, bool)  # empty slots are "done"
        self.last_tokens = np.full(self.batch_size, self.pad_id, np.int32)

        self._signatures: set = set()  # step signatures run so far
        # their fingerprints: the recompile events, under the JAX engine's
        # family labels by contract
        self._recompile_guard = _analysis.RecompileGuard(
            "gen_recompiles_total",
            "generation program lowerings (cache misses)")
        self._programs = {}  # (signature, capture state) -> StepGraph
        self._init_static()

    def _init_static(self):
        """The device buffers the step programs read, filled before each
        call; under "graph" on the card, the stream the graphs are
        captured on and one memory pool for all of them."""
        dev, b, k = self.device, self.batch_size, self.speculate_k
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
        if self.paged:
            # copy-on-write entries: rows, slots, src and dst pages
            self._in_cow = torch.zeros((4, self._cow_width),
                                       dtype=torch.int64, device=dev)
        if self.speculative:
            self._in_done = torch.zeros(b, dtype=torch.bool, device=dev)
            self._in_room = torch.zeros(b, dtype=torch.int32, device=dev)
            # written by the draft program, read by the verify program
            self._spec_drafted = torch.zeros((b, k), dtype=torch.int64,
                                             device=dev)
            if self.sampling.stochastic:
                v = self._vocab
                self._spec_q = torch.zeros((b, k, v), dtype=torch.float32,
                                           device=dev)
                # the round's uniforms: the draft's k + 1 draws, the accept
                # test's, and the correction draws at each of k + 1 places
                self._noise_draft = torch.zeros((k + 1, b, v), device=dev)
                self._noise_accept = torch.zeros((b, k), device=dev)
                self._noise_resid = torch.zeros((b, k + 1, v), device=dev)
        self._capture = self.engine_type == "graph" and dev.type == "cuda"
        self._stream = _cg.capture_stream(self, dev) if self._capture \
            else None
        self._pool = _cg.GraphPool() if self._capture else None

    # -- program accounting --------------------------------------------------
    @property
    def compiled_programs(self) -> int:
        """Step programs this engine has run: the prefill buckets used, plus
        the decode step (or the draft and verify steps), plus the
        copy-on-write program. Under "graph" each is one captured CUDA
        graph."""
        return len(self._signatures)

    @property
    def speculative(self) -> bool:
        return self.speculate_k > 0

    def _note_program(self, sig) -> None:
        """Count a step program the first time its signature runs, under
        the JAX engine's family labels (``gen_recompiles_total{reason}``
        and a ``recompile`` event), through the engine's
        :class:`~mxnet_tpu_torch.analysis.RecompileGuard`."""
        if sig in self._signatures:
            return
        self._signatures.add(sig)
        family = _PROGRAM_FAMILY[sig[0]]
        self._recompile_guard.observe(
            _analysis.Fingerprint.of((), sig=sig), reason=family,
            group=family, sig=list(map(str, sig)))

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

    def suffix_for(self, prompt) -> int:
        """Tokens a prefill of ``prompt`` computes after prefix adoption
        (the full length without a prefix cache). Probes the radix tree
        without touching its LRU clock."""
        n = len(prompt)
        if self.prefix_cache is None or n == 0:
            return n
        _, mtok = self.prefix_cache.lookup(list(prompt), touch=False)
        return n - min(mtok, n - 1)

    def pages_needed(self, prompt) -> int:
        """NEW pages admitting ``prompt`` takes after prefix reuse: adopted
        full pages are refcount bumps, not allocations."""
        if not self.paged:
            return 0
        n = len(prompt)
        adopted_full = (n - self.suffix_for(prompt)) // self.page_size
        return self.pages_for(n) - adopted_full

    def can_admit(self, prompt) -> bool:
        """Whether a prefill of ``prompt`` has a bucket to run in: the
        suffix after prefix adoption must fit a bucket and the prompt the
        row. A prompt longer than every bucket is admissible when its
        cached prefix shrinks the suffix into one."""
        n = len(prompt)
        if n == 0 or (self.paged and n >= self.max_length):
            return False
        try:
            self.bucket_for(self.suffix_for(prompt))
        except ValueError:
            return False
        return True

    @property
    def available_pages(self) -> int:
        """Free pages plus the prefix-cache pages that eviction could free:
        the admission headroom."""
        if not self.paged:
            return 0
        n = len(self._free_pages)
        if self.prefix_cache is not None:
            n += self.prefix_cache.collectable(
                lambda pid: self._page_rc[pid] == 1)
        return n

    @property
    def reserved_pages(self) -> int:
        """Free pages currently held back for a parked queue head."""
        return self._reserved_pages if self.paged else 0

    def reserve_pages(self, n: int) -> None:
        """Hold ``n`` free pages back from decode-time growth (the
        batcher's aging guard). Reserved pages stay visible to
        :meth:`prefill`, whose admission they are saved for; ``n=0``
        releases the reservation. A row that cannot cover its next write
        because of a reservation finishes as ``page_exhausted``."""
        if not self.paged:
            return
        self._reserved_pages = max(0, int(n))
        _obs.gauge("gen_pages_reserved",
                   "free pages held back for a parked queue head").set(
                       self._reserved_pages)

    def _page_gauges(self):
        free = len(self._free_pages)
        _obs.gauge("gen_pages_free",
                   "free pages in the paged KV pool").set(free)
        _obs.gauge("gen_pages_in_use",
                   "allocated pages in the paged KV pool").set(
                       self.num_pages - free)
        _obs.gauge("gen_page_refcount_max",
                   "highest per-page refcount (sharing depth)").set(
                       int(self._page_rc.max()) if self.num_pages else 0)

    def _unref_pages(self, pages) -> int:
        """Drop one reference from each page; refcount-0 pages return to
        the free list (a page still backing another row or the prefix cache
        stays allocated). Returns the pages freed."""
        freed = 0
        for pid in pages:
            self._page_rc[pid] -= 1
            if self._page_rc[pid] <= 0:
                self._page_rc[pid] = 0
                self._free_pages.append(pid)
                freed += 1
        return freed

    def _reclaim_row(self, slot: int) -> int:
        pages = self._row_pages[slot]
        if not pages:
            return 0
        self._row_pages[slot] = []
        freed = self._unref_pages(pages)
        if freed:
            _obs.counter("gen_pages_reclaimed_total",
                         "pages returned to the free pool").inc(freed)
        self._page_gauges()
        return freed

    def _avail(self) -> int:
        # pages past the reservation are off-limits to growth
        return len(self._free_pages) - self._reserved_pages

    def _evict_prefix(self, n: int, protect=()) -> int:
        """Free up to ``n`` pages by evicting cache-only (refcount-1)
        prefix-cache entries, least recently used first."""
        if self.prefix_cache is None:
            return 0
        evicted = self.prefix_cache.evict(
            n, lambda pid: self._page_rc[pid] == 1, protect=protect)
        if evicted:
            self._unref_pages(evicted)
            _obs.counter("gen_prefix_evictions_total",
                         "prefix-cache pages evicted under free-page "
                         "pressure").inc(len(evicted))
            self._page_gauges()
        return len(evicted)

    def _take_page(self) -> int:
        """One page off the free list (refcount 1), evicting prefix-cache
        entries under pressure; 0 (the trash page id) when nothing can be
        freed."""
        if self._avail() <= 0 and not self._evict_prefix(1):
            return 0
        pid = self._free_pages.popleft()
        self._page_rc[pid] = 1
        return pid

    def _evict_row(self, row: int) -> None:
        self.done[row] = True
        self.page_exhausted[row] = True
        _obs.counter("gen_page_evictions_total",
                     "rows force-finished on page exhaustion").inc(
                         reason="exhausted")

    def _grow_pages(self, window: int):
        """Allocate pages so every active row's table covers positions
        ``p .. min(p + window, max_length - 1)``; rows that cannot cover
        their next write are force-finished (``page_exhausted``). A shared
        (refcount > 1) page inside the write window first gets a private
        copy, by the copy-on-write program, before the step that writes.
        Returns the (row, slot, page) entries to install in the device
        table."""
        ps = self.page_size
        updates, copies = [], []
        allocated = 0
        for row in range(self.batch_size):
            if self.done[row]:
                continue
            p = int(self.positions[row])
            pages = self._row_pages[row]
            need = min(p + window, self.max_length - 1) // ps + 1
            short = False
            for s in range(p // ps, min(need, len(pages))):
                pid = pages[s]
                if self._page_rc[pid] <= 1:
                    continue
                new = self._take_page()
                if not new:
                    short = True
                    break
                allocated += 1
                copies.append((row, s, pid, new))
                self._page_rc[pid] -= 1
                pages[s] = new
            if short:
                # a shared page it cannot copy is a write it cannot make
                self._evict_row(row)
                continue
            while len(pages) < need:
                pid = self._take_page()
                if not pid:
                    if len(pages) * ps <= p:
                        # cannot write the next token: evict the row
                        self._evict_row(row)
                    break
                updates.append((row, len(pages), pid))
                pages.append(pid)
                allocated += 1
        if allocated:
            _obs.counter("gen_page_allocs_total",
                         "pages taken from the free pool").inc(
                             allocated, site="decode")
            self._page_gauges()
        self._dispatch_cow(copies)
        return updates

    def _dispatch_cow(self, copies) -> None:
        """Run the copy-on-write program: each (row, slot, src, dst) entry
        copies pool page ``src`` into the private page ``dst`` in every
        layer (the target's pools, and the draft's on a speculative engine)
        and repoints the row's table entry. Entries go in chunks of
        ``_cow_width``, so the program never changes shape; padding
        entries have ``dst == 0``: their copy lands in the trash page and
        their table write in the flat table's spare last entry."""
        if not copies:
            return
        step = self._cow_step()
        w = self._cow_width
        sig = ("cow", w)
        for i in range(0, len(copies), w):
            entries = np.zeros((4, w), np.int64)
            for j, entry in enumerate(copies[i:i + w]):
                entries[:, j] = entry
            self._note_program(sig)
            self._put(self._in_cow, entries)
            self._run_program(sig, step)
        _obs.counter("gen_cow_copies_total",
                     "copy-on-write page copies").inc(len(copies))

    def _cow_step(self):
        """The ``("cow", W)`` step: each entry of the static ``_in_cow``
        copies a pool page in every layer and repoints a table entry."""
        pool_sets = [self.pools] + ([self.draft_pools] if self.speculative
                                    else [])
        cow, flat, n = self._in_cow, self._table_flat, self._n_row_pages
        spare = flat.numel() - 1

        def step():
            rows, slots, src, dst = cow[0], cow[1], cow[2], cow[3]
            for pools in pool_sets:
                for k_pool, v_pool in pools:
                    k_pool.index_copy_(0, dst, k_pool.index_select(0, src))
                    v_pool.index_copy_(0, dst, v_pool.index_select(0, src))
            at = torch.where(dst > 0, rows * n + slots, spare)
            flat.index_copy_(0, at, dst.to(flat.dtype))
            return ()

        return step

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
        is the time-to-first-token point). In paged mode, adopts the
        longest cached prefix (with a prefix cache), allocates the pages
        the rest needs up front, and raises RuntimeError if the pool
        cannot cover them."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        length = prompt.size
        if not 0 < length:
            raise ValueError("empty prompt")
        if not 0 <= slot < self.batch_size:
            raise ValueError(f"slot {slot} out of range")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            raise ValueError(f"prompt token ids must lie in [0, {self._vocab})")
        # fault site BEFORE any allocator mutation: a retried admission
        # (ContinuousBatcher wraps prefill in retry_call) must replay
        # against untouched page/clear state
        _faults.fire("gen.prefill")
        t0 = time.perf_counter()
        start, new_row = 0, None
        if self.paged:
            if length >= self.max_length:
                raise ValueError(f"prompt length {length} >= max_length="
                                 f"{self.max_length}")
            start, new_row = self._admit_pages(prompt, slot)
        suffix = length - start
        bucket = self.bucket_for(suffix)
        padded = np.full((1, bucket), self.pad_id, np.int64)
        padded[0, :suffix] = prompt[start:]
        self._note_program(("prefill", bucket))
        last = self._prefill_program(padded, slot, start, suffix, new_row)
        tok = int(self._sample(last[None, :])[0])  # host sync: TTFT
        self.positions[slot] = length
        self.last_tokens[slot] = tok
        self.done[slot] = (self.eos_id is not None and tok == self.eos_id)
        if self.paged:
            self._prefill_logits[slot] = last
            if self.prefix_cache is not None:
                # index the prompt's full pages (new entries gain a cache
                # reference; cached prefixes are kept as they are)
                for pid in self.prefix_cache.insert(prompt.tolist(),
                                                    self._row_pages[slot]):
                    self._page_rc[pid] += 1
                self._page_gauges()
        if _obs.enabled():
            _obs.histogram("gen_prefill_seconds", "prompt prefill wall clock",
                           unit="s").observe(time.perf_counter() - t0,
                                             bucket=bucket)
        self._last_logits = last
        return tok

    def _admit_pages(self, prompt, slot):
        """The allocator's side of a paged prefill: adopt the longest
        cached prefix (keeping at least one token to compute, for the first
        token's logits), check the headroom before any allocator change,
        take the row's pages and copy a partially adopted tail page.
        Returns the start offset and the row's page-table row."""
        length, ps = prompt.size, self.page_size
        total = self.pages_for(length)
        adopt: List[int] = []
        tail_src = start = 0
        if self.prefix_cache is not None:
            cpages, mtok = self.prefix_cache.lookup(prompt.tolist())
            start = min(mtok, length - 1)
            adopt = cpages[:start // ps]
            if start % ps:
                # adoption ends inside a cached page: copy it into a private
                # page; its stale positions past `start` stay masked until
                # the suffix overwrites them
                tail_src = cpages[start // ps]
        self.bucket_for(length - start)  # no bucket: refuse before mutating
        need = total - len(adopt)
        protect = set(adopt) | ({tail_src} if tail_src else set())
        own = sum(1 for pid in self._row_pages[slot]
                  if self._page_rc[pid] == 1 and pid not in protect)
        headroom = len(self._free_pages) + own
        if headroom < need and self.prefix_cache is not None:
            headroom += self.prefix_cache.collectable(
                lambda pid: self._page_rc[pid] == 1, protect=protect)
        if headroom < need:
            raise RuntimeError(
                f"insufficient free pages for a {length}-token prompt "
                f"({need} needed, {len(self._free_pages)} free); release "
                "slots or raise num_pages")
        self._reclaim_row(slot)  # previous occupant's pages, if any
        self._pending_clear.discard(slot)  # the new row replaces it
        self.page_exhausted[slot] = False
        short = need - len(self._free_pages)
        if short > 0:
            self._evict_prefix(short, protect=protect)
        for pid in adopt:  # adopted prefix: refcount bumps, no compute
            self._page_rc[pid] += 1
        fresh = []
        for _ in range(need):
            pid = self._free_pages.popleft()
            self._page_rc[pid] = 1
            fresh.append(pid)
        pages = adopt + fresh
        self._row_pages[slot] = list(pages)
        if need:
            _obs.counter("gen_page_allocs_total",
                         "pages taken from the free pool").inc(
                             need, site="prefill")
        if start:
            _obs.counter("gen_prefix_hits_total",
                         "prefills that adopted a cached prefix").inc()
            _obs.counter("gen_prefix_hit_tokens",
                         "prompt tokens served from the prefix "
                         "cache").inc(int(start))
        self._page_gauges()
        if tail_src:
            # the copy lands before the prefill writes the suffix into it
            self._dispatch_cow([(slot, len(adopt), tail_src, fresh[0])])
        new_row = np.zeros(self._n_row_pages, np.int32)
        new_row[:total] = pages
        return start, new_row

    def _prefill_program(self, padded, slot, start, suffix, new_row):
        """The prefill's forward as the step program of its bucket, over
        the static buffers; returns a copy of the last prompt token's logits
        (V,). The LM head runs over the whole bucket and the last row is
        taken by a device index, so one program serves every length and
        every start offset. On a speculative engine the same program writes
        the draft model's pools too."""
        bucket = padded.shape[1]
        buf = self._prompt_buffer(bucket)
        if self.paged:
            self._put(self.page_table[slot], new_row)
            self._in_table.copy_(self.page_table[slot:slot + 1])
        else:
            self._put(self._in_table, np.full((1, 1), slot, np.int32))
        self._put(buf, padded)
        self._put(self._in_start, np.array([start], np.int32))
        self._put(self._in_last, np.array([suffix - 1], np.int64))
        (last,) = self._run_program(("prefill", bucket),
                                    self._prefill_step(bucket))
        return last[0].clone()

    def _prompt_buffer(self, bucket):
        buf = self._in_prompt.get(bucket)
        if buf is None:
            buf = self._in_prompt[bucket] = torch.zeros(
                (1, bucket), dtype=torch.int64, device=self.device)
        return buf

    def _prefill_step(self, bucket):
        """The ``("prefill", bucket)`` step over the static buffers. It
        reads no attribute of the engine (no cycle through the program,
        which would keep the graphs' pool alive)."""
        buf = self._prompt_buffer(bucket)
        net, cache, start_buf = self.net, self._cache(), self._in_start
        table, last_idx = self._in_table, self._in_last
        draft, dcache = (self.draft_net, self.draft_pools) \
            if self.speculative else (None, None)

        def step():
            logits, _ = net(buf, cache=cache, start_pos=start_buf,
                            page_table=table)
            if draft is not None:
                draft(buf, cache=dcache, start_pos=start_buf,
                      page_table=table)
            return (logits[0].index_select(0, last_idx),)

        return step

    @torch.inference_mode()
    def decode_step(self):
        """One step over the whole batch. Returns ``(next_tokens (B,)
        np.int32, done (B,) np.bool_, logits (B, V) device tensor)``. Rows
        that were already done emit ``pad_id`` and keep their frontier. A
        speculative engine decodes in rounds (:meth:`spec_step`)."""
        if self.speculative:
            raise RuntimeError("speculative engine decodes in rounds; "
                               "use spec_step() (or plain_step() for one "
                               "plain step)")
        return self._plain_decode_step()

    @torch.inference_mode()
    def plain_step(self):
        """One plain (non-speculative) decode step on any engine: on a
        speculative engine, the fallback decode program (built on first
        use), greedy-token-identical to the rounds. The draft's cache is
        not written."""
        return self._plain_decode_step()

    def _plain_decode_step(self):
        _faults.fire("gen.decode")
        t0 = time.perf_counter()
        if self.paged:
            updates = self._grow_pages(0)
            clear = self._take_clear_mask()
            self._apply_table_updates(updates, clear)
        active_in = ~self.done  # exhaustion may have finished rows
        sig = self._decode_sig()
        self._note_program(sig)
        self._put(self._in_tokens, self.last_tokens.astype(np.int64)[:, None])
        self._put(self._in_positions, self.positions)
        logits = self._run_program(sig, self._decode_step())[0].clone()
        sampled = self._sample(logits).cpu().numpy()
        tok = np.where(self.done, np.int32(self.pad_id), sampled) \
            .astype(np.int32)
        done = self.done.copy()
        if self.eos_id is not None:
            done |= sampled == self.eos_id
        # rows active going into the step consumed one cache index
        self.positions = self.positions + active_in.astype(np.int32)
        # a row whose frontier hit the buffer end cannot take another token
        full = active_in & (self.positions >= self.max_length)
        if full.any():
            done |= full
            _obs.counter("gen_cache_overflow_total",
                         "rows force-finished at the KV-cache end").inc(
                             int(full.sum()))
        self.done = done
        self.last_tokens = tok
        if _obs.enabled():
            _obs.histogram("gen_decode_step_seconds",
                           "one decode step wall clock",
                           unit="s").observe(time.perf_counter() - t0)
            _obs.gauge("gen_slot_utilization",
                       "fraction of decode slots active this step").set(
                           float(active_in.sum()) / self.batch_size)
        return tok, done, logits

    def _decode_sig(self):
        return ("decode", self.batch_size) + (("paged",) if self.paged
                                              else ())

    def _decode_step(self):
        """The plain decode step: one token a row through the cache."""
        net, cache, tokens = self.net, self._cache(), self._in_tokens
        positions = self._in_positions
        table = self.page_table if self.paged else None

        def step():
            logits, _ = net(tokens, cache=cache, start_pos=positions,
                            page_table=table)
            return (logits[:, 0],)

        return step

    # -- speculative rounds --------------------------------------------------
    def _draft_step(self):
        """The ``("draft", B, k)`` step: k + 1 draft steps through the
        draft pools. Step i consumes token i (t0, d1, ...) and writes its
        K/V at position p + i, so the last drafted token's entry lands at
        p + k too: on a full accept the frontier moves past it, and a
        skipped write would leave a hole below the draft's frontier. The
        k + 1-th drafted token is discarded. Greedy drafts take the argmax;
        stochastic ones sample through the Gumbel noise of the round and
        record the draft distribution q of each drafted token."""
        net, pools, table = self.draft_net, self.draft_pools, self.page_table
        tokens, positions = self._in_tokens, self._in_positions
        drafted, k = self._spec_drafted, self.speculate_k
        cfg, stochastic = self.sampling, self.sampling.stochastic
        if stochastic:
            q, noise = self._spec_q, self._noise_draft

        def step():
            tok = tokens
            for i in range(k + 1):
                logits, _ = net(tok, cache=pools, start_pos=positions + i,
                                page_table=table)
                logits = logits[:, 0]
                if stochastic:
                    logits = _sample_logits(cfg, logits)
                    nxt = torch.argmax(logits + _gumbel(noise[i]), dim=-1)
                    if i < k:
                        q[:, i] = torch.softmax(logits, dim=-1)
                else:
                    nxt = torch.argmax(logits, dim=-1)
                if i < k:
                    drafted[:, i] = nxt
                tok = nxt[:, None]
            return ()

        return step

    def _verify_step(self):
        """The ``("verify", B, k)`` step: one target forward scores the
        k + 1 positions. Greedy: the longest drafted prefix the target's
        argmax agrees with is accepted, plus the target's own next token.
        Stochastic: drafted token x_i is accepted when ``u q_i(x_i) <
        p_i(x_i)``, the first rejection is resampled from the normalized
        residual ``max(p_i - q_i, 0)``, and a full accept earns a bonus
        token from p_k. Emission stops at the first EOS, at ``room`` (the
        page-covered capacity) and for done rows; rejected tails do not
        advance the frontier. Returns the (B, k + 1) emitted tokens padded
        with pad_id, the per-row counts, done and the accept counts."""
        net, pools, table = self.net, self.pools, self.page_table
        tokens, positions = self._in_tokens, self._in_positions
        drafted, done, room = self._spec_drafted, self._in_done, self._in_room
        k, pad, eos = self.speculate_k, self.pad_id, self.eos_id
        cfg, stochastic = self.sampling, self.sampling.stochastic
        if stochastic:
            q = self._spec_q
            u, resid_noise = self._noise_accept, self._noise_resid

        def step():
            x = torch.cat([tokens, drafted], dim=1)  # (B, k + 1)
            logits, _ = net(x, cache=pools, start_pos=positions,
                            page_table=table)
            idx = torch.arange(k + 1, device=x.device)[None, :]
            if stochastic:
                p = torch.softmax(_sample_logits(cfg, logits), dim=-1)
                p_tok = p[:, :k].gather(2, drafted[..., None])[..., 0]
                q_tok = q.gather(2, drafted[..., None])[..., 0]
                accept = (u * q_tok < p_tok).to(torch.int64)
                acc = torch.cumprod(accept, dim=1).sum(dim=1)
                resid = (p[:, :k] - q).clamp_min(0.0)
                rs = resid.sum(dim=-1, keepdim=True)
                # p == q exactly: an empty residual, any draw from p is fair
                resid = torch.where(rs > 0, resid / rs.clamp_min(1e-30),
                                    p[:, :k])
                cand = torch.cat([resid, p[:, k:]], dim=1)  # (B, k + 1, V)
                corr = torch.argmax(torch.log(cand.clamp_min(1e-38))
                                    + _gumbel(resid_noise), dim=-1)
                correction = corr.gather(1, acc[:, None])
                ext = torch.cat([drafted, torch.zeros_like(drafted[:, :1])],
                                dim=1)
                g = torch.where(idx < acc[:, None], ext,
                                torch.where(idx == acc[:, None], correction,
                                            pad))
                seen = idx <= acc[:, None]
            else:
                g = torch.argmax(logits, dim=-1)  # (B, k + 1)
                match = (drafted == g[:, :k]).to(torch.int64)
                acc = torch.cumprod(match, dim=1).sum(dim=1)
                seen = torch.ones_like(g, dtype=torch.bool)
            m = acc + 1
            if eos is not None:
                is_eos = (g == eos) & seen
                first = torch.argmax(is_eos.to(torch.int64), dim=1)
                m = torch.minimum(m, torch.where(is_eos.any(dim=1),
                                                 first + 1, k + 1))
            m = torch.minimum(m, room.clamp_min(0).to(m.dtype))
            m = torch.where(done, 0, m)
            emit = idx < m[:, None]
            out = torch.where(emit, g, pad)
            new_done = done
            if eos is not None:
                new_done = done | (emit & (out == eos)).any(dim=1)
            return out, m, new_done, acc

        return step

    @torch.inference_mode()
    def spec_step(self):
        """One speculative round: the draft program (k tokens through the
        draft pools) and the verify program (the target scores all k + 1
        positions). Returns ``(tokens (B, k+1) np.int32 padded with pad_id,
        counts (B,) np.int32 emitted per row, done (B,) np.bool_)``. Greedy
        output is token-identical to plain decode driven to the same
        length."""
        if not self.speculative:
            raise RuntimeError("spec_step() needs draft_net=/speculate_k=")
        _faults.fire("gen.decode")  # before any allocator mutation: the
        # batcher's retry_call replays the whole round cleanly
        t0 = time.perf_counter()
        k, b = self.speculate_k, self.batch_size
        updates = self._grow_pages(k)
        clear = self._take_clear_mask()
        self._apply_table_updates(updates, clear)
        active_in = ~self.done  # exhaustion may have finished rows
        # committed entries may only land in page-covered positions: the
        # verify program clamps per-row emission to this window
        room = np.array([min(len(self._row_pages[r]) * self.page_size,
                             self.max_length) - int(self.positions[r])
                         for r in range(b)], np.int32)
        self._put(self._in_tokens, self.last_tokens.astype(np.int64)[:, None])
        self._put(self._in_positions, self.positions)
        self._put(self._in_done, self.done)
        self._put(self._in_room, room)
        if self.sampling.stochastic and not self._noise_drawn:
            # once per round: a round replayed after a failure draws the
            # same tokens
            for buf in (self._noise_draft, self._noise_accept,
                        self._noise_resid):
                buf.uniform_(generator=self._generator)
            self._noise_drawn = True
        draft_sig, verify_sig = ("draft", b, k), ("verify", b, k)
        self._note_program(draft_sig)
        self._run_program(draft_sig, self._draft_step())
        # the draft's writes are deterministic overwrites, so the verify
        # dispatch is re-entrant here: retry it inside the round
        self._note_program(verify_sig)

        def _dispatch_verify():
            _faults.fire("gen.verify")
            return self._run_program(verify_sig, self._verify_step())

        outs = _retry.retry_call(_dispatch_verify, site="gen.verify",
                                 policy=self.retry_policy)
        out, m, done, acc = (t.cpu().numpy() for t in outs)
        self._noise_drawn = False
        out, m = out.astype(np.int32), m.astype(np.int32)
        self.positions = self.positions + m
        last = out[np.arange(b), np.maximum(m - 1, 0)]
        self.last_tokens = np.where(m > 0, last, self.last_tokens) \
            .astype(np.int32)
        full = active_in & (self.positions >= self.max_length)
        if full.any():
            done = done | full
            _obs.counter("gen_cache_overflow_total",
                         "rows force-finished at the KV-cache end").inc(
                             int(full.sum()))
        self.done = done
        n_active = int(active_in.sum())
        _obs.counter("gen_spec_rounds_total",
                     "speculative draft+verify rounds").inc()
        self.last_round_drafted = k * n_active
        self.last_round_accepted = int(acc[active_in].sum())
        if n_active:
            accepted = self.last_round_accepted
            _obs.counter("gen_spec_drafted_tokens_total",
                         "draft tokens proposed").inc(k * n_active)
            _obs.counter("gen_spec_accepted_tokens_total",
                         "draft tokens the target accepted").inc(accepted)
            _obs.counter("gen_spec_emitted_tokens_total",
                         "tokens emitted by speculative rounds").inc(
                             int(m.sum()))
            _obs.gauge("gen_spec_accept_rate",
                       "accepted/drafted ratio of the last round").set(
                           accepted / float(k * n_active))
        if _obs.enabled():
            _obs.histogram("gen_spec_round_seconds",
                           "one draft+verify round wall clock",
                           unit="s").observe(time.perf_counter() - t0)
            _obs.gauge("gen_slot_utilization",
                       "fraction of decode slots active this step").set(
                           float(active_in.sum()) / self.batch_size)
        return out, m, done

    # -- forks, sessions, release ---------------------------------------------
    def fork_slot(self, src: int, dst: int,
                  resample_first: bool = False) -> int:
        """Copy-on-write fork: row ``dst`` becomes a live clone of row
        ``src`` sharing every page, by refcount bumps. The first write
        either row makes into a shared page copies it (:meth:`_grow_pages`).
        ``resample_first=True`` draws a new first token from the source
        row's prefill logits with the engine's generator (N-way sampling:
        fork right after :meth:`prefill`). Returns ``dst``'s last token."""
        if not self.paged:
            raise RuntimeError("fork_slot needs a paged engine")
        if src == dst or not (0 <= src < self.batch_size
                              and 0 <= dst < self.batch_size):
            raise ValueError(f"bad fork {src} -> {dst}")
        if self.done[src] or not self._row_pages[src]:
            raise RuntimeError(f"cannot fork finished/empty row {src}")
        self._reclaim_row(dst)  # previous occupant's pages, if any
        self._pending_clear.discard(dst)
        self.page_exhausted[dst] = False
        pages = list(self._row_pages[src])
        for pid in pages:
            self._page_rc[pid] += 1
        self._row_pages[dst] = pages
        row = np.zeros(self._n_row_pages, np.int32)
        row[:len(pages)] = pages
        self._put(self.page_table[dst], row)
        self.positions[dst] = self.positions[src]
        tok = int(self.last_tokens[src])
        if resample_first:
            logits = self._prefill_logits.get(src)
            if logits is None:
                raise RuntimeError(f"row {src} has no prefill logits to "
                                   "resample from")
            tok = int(self._sample(logits[None, :])[0])
            self._prefill_logits[dst] = logits
        self.last_tokens[dst] = tok
        self.done[dst] = (self.eos_id is not None and tok == self.eos_id)
        self._page_gauges()
        _obs.counter("gen_forks_total", "copy-on-write row forks").inc()
        return tok

    def cache_sequence(self, slot: int, tokens) -> int:
        """Index a live row's computed full pages under ``tokens`` (prompt
        and output) in the prefix cache, so that a next turn's prompt
        adopts the whole history. Only positions the row has written count.
        Returns the tokens now served from cache for this sequence."""
        if not self.paged or self.prefix_cache is None:
            return 0
        n = min(len(tokens), int(self.positions[slot]))
        if n < self.page_size:
            return 0
        for pid in self.prefix_cache.insert(list(tokens)[:n],
                                            self._row_pages[slot]):
            self._page_rc[pid] += 1
        self._page_gauges()
        return (n // self.page_size) * self.page_size

    def release_slot(self, slot: int) -> None:
        """Mark a row free (emits pad, frontier frozen). In paged mode the
        row's references are dropped, only refcount-0 pages return to the
        free pool, and its device table row is cleared before the next
        step writes anything."""
        self.done[slot] = True
        self.last_tokens[slot] = self.pad_id
        if self.paged:
            self._reclaim_row(slot)
            self._pending_clear.add(slot)
            self._prefill_logits.pop(slot, None)

    def audit(self, bucket: Optional[int] = None, compile: bool = True,
              program: str = "decode"):
        """Structural :class:`~mxnet_tpu_torch.analysis.ProgramAudit` of a
        serving program: the record of its step on fake tensors
        (``lowered``), the census of the CUDA graph it replays
        (``compiled``; None on the CPU, with ``compile=False``, or before
        the program's graph is captured: ``why_not_compiled`` says which),
        and the carry's input indices. Default: the decode step, whose carry
        is the KV cache it writes in place (the pools, or the dense cache's
        buffers), so ``audit().carry_donation() == 1.0`` is the
        in-place-cache check. ``bucket=`` audits that prefill bucket's
        program (the same carry; on a speculative engine the draft's pools
        too); on a speculative engine ``program="decode"`` audits the draft
        program and ``program="verify"`` the verify pass; on a paged engine
        ``program="cow"`` the copy-on-write program (carry: the pools and
        the page table, no parameters). The page table is an input of the
        decode programs, not their carry: the port installs table updates
        before the step, so no decode program writes it.

        ``audit(...).memory`` is the liveness estimate: cache bytes under
        ``kv_pages`` (paged: the pools and the page table) / ``kv_cache``
        (dense), the weights under ``params``, the static buffers under
        ``io``, the program's own allocations under ``activations`` /
        ``draft_temp`` / ``verify_temp``; ``audit(...).schedule`` the
        roofline DAG (no collective on one card). The audit runs nothing:
        no token, page or random stream changes."""
        if bucket is not None:
            bucket = self.bucket_for(bucket)
            sig, build = ("prefill", bucket), \
                (lambda: self._prefill_step(bucket))
        elif program == "cow":
            if not self.paged:
                raise ValueError("program='cow' needs a paged engine")
            sig, build = ("cow", self._cow_width), self._cow_step
        elif program == "verify":
            if not self.speculative:
                raise ValueError("program='verify' needs a speculative "
                                 "engine (draft_net=/speculate_k=)")
            sig, build = ("verify", self.batch_size, self.speculate_k), \
                self._verify_step
        elif program != "decode":
            raise ValueError(f"no program {program!r}")
        elif self.speculative:
            sig, build = ("draft", self.batch_size, self.speculate_k), \
                self._draft_step
        else:
            sig, build = self._decode_sig(), self._decode_step
        prog = self._programs.get((sig, _cg.capture_state()))
        fn = prog.fn if prog is not None else build()
        draft_side = sig[0] == "draft" or (
            sig[0] in ("prefill", "cow") and self.speculative)
        nets = {"prefill": [self.net] + ([self.draft_net] if
                                         self.speculative else []),
                "cow": [], "draft": [self.draft_net]}.get(sig[0], [self.net])
        # a draft net may be the target itself: each tensor is one input
        params = list({id(p): p for net in nets
                       for p in net.parameters()}.values())
        caches = []
        if sig[0] != "draft":
            caches.append(self._cache())
        if draft_side:
            caches.append(self.draft_pools)
        carry = [t for cache in caches for kv in cache for t in kv]
        if sig[0] == "cow":
            carry.append(self._table_flat)
        kv_extra = [self.page_table] if self.paged and sig[0] in (
            "decode", "draft", "verify") else []
        with torch.no_grad():
            rep = _analysis.audit_program(fn, carry=params + carry,
                                          inputs=kv_extra)
        n_pre, n_carry = len(params), len(carry)
        kv_cat = "kv_pages" if self.paged else "kv_cache"
        cats = {i: "params" for i in range(n_pre)}
        cats.update({i: kv_cat for i in range(
            n_pre, n_pre + n_carry + len(kv_extra))})
        for i in range(n_pre + n_carry + len(kv_extra), len(rep.inputs)):
            cats[i] = "io"
        if sig[0] == "verify":
            default_cat = "verify_temp"
        elif sig[0] == "draft":
            default_cat = "draft_temp"
        else:
            default_cat = "activations"
        compiled, why = None, ""
        if not compile:
            why = "compile=False"
        elif self.device.type != "cuda":
            why = f"the engine runs on {self.device}: no CUDA graph"
        elif not self._capture:
            why = "engine_type='naive': the program is not captured"
        elif prog is None or prog.graph is None:
            why = f"the {sig} program's graph is not captured yet"
        else:
            compiled = prog.census
        memory = _analysis.memory_report(rep, categories=cats,
                                         default_category=default_cat)
        comm = _analysis.comm_report(rep)
        schedule = _analysis.schedule_report(rep, comm=comm)
        return _analysis.ProgramAudit(
            lowered=rep, compiled=compiled,
            carry_indices=tuple(range(n_pre, n_pre + n_carry)), comm=comm,
            memory=memory, schedule=schedule, why_not_compiled=why,
            launches=dict(prog.launches) if compiled is not None else {})

    def profile(self, prompt=None, steps: int = 8, warmup: int = 2,
                trace_dir: Optional[str] = None, calibrate: bool = True,
                band: float = 3.0):
        """Trace ``steps`` real decode steps (speculative rounds on a
        speculative engine) and return the
        :class:`~mxnet_tpu_torch.observability.profiling.Capture`: the
        measured per-op timeline of the serving hot loop, its hot-op
        ranking and the measured step time (each step's device window;
        ``prof_step.busy`` spans hold the card's busy time in it).
        The steps go through the engine's own step graphs, so the traced
        program IS the program continuous batching replays; untraced calls
        run until the step replays its graph, so that no traced step warms
        up or captures. ``prompt`` (default a short synthetic one) is
        prefilled into slot 0 first, outside the traced window, so the
        decode has a live row to extend; the slot is released afterwards.
        On the card a timeline without kernel rows raises.

        With ``calibrate=True`` (default) the capture carries per-op-class
        predicted/measured ratios against :meth:`audit`'s schedule model
        of the same decode program."""
        from ..observability import profiling as _profiling

        if prompt is None:
            prompt = list(range(1, 1 + min(4, self.prefill_buckets[0])))
        self.prefill(prompt, slot=0)
        fn = self.spec_step if self.speculative else self.decode_step
        try:
            cap = _profiling.capture(fn, steps=steps, warmup=warmup,
                                     trace_dir=trace_dir, device=self.device,
                                     replays_only=True)
        finally:
            self.release_slot(0)
        if calibrate:
            cap.schedule = self.audit().schedule
            cap.calibration = _profiling.calibrate(cap.schedule, cap.report,
                                                   band=band)
        return cap

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
            if self.speculative:
                toks, counts, _ = self.spec_step()
                for i in active:
                    room = max_new_tokens - len(outs[i])
                    outs[i].extend(int(t) for t in toks[i, :min(
                        int(counts[i]), room)])
                    if len(outs[i]) >= max_new_tokens and not self.done[i]:
                        self.release_slot(i)  # cap reached: stop advancing
                continue
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

"""One captured CUDA graph per step signature: the port's counterpart of the
JAX package's compiled, donated step programs (``jax.jit`` in
``mxnet_tpu/inference/engine.py`` and ``mxnet_tpu/parallel/train_step.py``).

A :class:`StepGraph` wraps a step function that reads only static inputs
(buffers its owner fills before each call) and returns its outputs as a
tuple of tensors. On the card:

  - the first call runs the function eagerly on its owner's capture stream
    (:func:`capture_stream`; the warm-up that capture needs: cuBLAS
    workspaces, kernel builds), and its result is that call's result;
  - the second call captures the function into a CUDA graph on the same
    side stream and replays it at once, for its own result;
  - every later call replays.

A capture never runs inside a profiler session (the probe that
``observability.profiling`` installs with :func:`set_trace_probe`): while
one is open, a call that would capture runs the function eagerly again,
as the warm-up did, and the capture waits for the first call after the
session. The profile entry points count such eager calls
(:func:`unreplayed_calls`) to trace only replays.

The kernel wrappers count their launches on the host (``launches`` in
``ops/layernorm.py``, ``ops/paged_attention.py``, ``ops/flash_attention.py``,
``ops/optimizer.py``, ``ops/softmax_xent.py`` and
``contrib/quantization.py``). A capture launches nothing, so the counts it
made are taken back and added again at every replay: the counters say what
the card ran, as in the eager step.

Right after a capture, before the graph is instantiated, its nodes are read
once (``analysis.audit.graph_census``) and kept as :attr:`StepGraph.census`:
the program the step replays is the one its audit reads.

There is no fallback: a capture that fails (a host sync or a pageable copy
inside the step, or an error the step raises on the host) raises
:class:`MXNetError` with the step's signature.

A StepGraph built with ``capture=False`` (``engine_type="naive"``), and
every StepGraph on the CPU, never captures: each call runs the same step
function over the same static buffers, eagerly, and copies its outputs into
static output tensors as a replay overwrites them. So "naive" and "graph"
differ only in the capture, and the CPU runs the owner's bookkeeping and
copy-out as the card does.
"""
from __future__ import annotations

import gc
import threading
import warnings
import weakref
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import config as _config
from ..base import MXNetError

__all__ = ["StepGraph", "GraphPool", "capture_stream", "capture_state",
           "launch_counts", "after_capture", "persistent_empty", "owned",
           "capturing", "unreplayed_calls", "set_trace_probe"]

# the StepGraph whose capture is under way (captures are not nested)
_active: Optional["StepGraph"] = None
# calls of capturing StepGraphs that did not replay (warm-ups, captures)
_unreplayed = 0
#: bytes that persistent_empty() may take in one capture: held cached on
#: a side stream before the capture begins, since a capture may not
#: cudaMalloc outside its own pool
KEEP_BYTES = 1 << 20

# device -> the side stream that holds persistent_empty() allocations
_keep_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
# device -> capture streams that no living owner holds
_free_streams: Dict[torch.device, list] = {}
# owners may be built on several threads (serving replicas)
_streams_lock = threading.Lock()


def _keep_stream(device):
    with _streams_lock:
        stream = _keep_streams.get(device)
        if stream is None:
            stream = _keep_streams[device] = torch.cuda.Stream(device)
        return stream


def capture_stream(owner, device) -> "torch.cuda.Stream":
    """The side stream on which the step graphs of ``owner`` (an engine or
    a TrainStep) warm up and are captured: its own while it lives, then
    handed to the next owner. A captured cuBLAS product keeps the workspace
    of the stream it was captured on, so graphs of two owners, which may
    replay at the same time on two streams, must not share a stream (an
    owner's own graphs never run at once). PyTorch keeps a workspace for
    every stream that ran a product, for the life of the process, hence
    the reuse."""
    with _streams_lock:
        free = _free_streams.setdefault(device, [])
        stream = free.pop() if free else None
    if stream is None:
        stream = _new_stream(device)
    weakref.finalize(owner, free.append, stream)
    return stream


def _new_stream(device):
    """A new side stream with its cuBLAS workspaces made at once, in
    segments of their own (a new stream has no cached blocks): the
    workspace of this thread's handle, and, through a backward, that of
    the autograd device thread's handle. Made later, by a warm-up, a
    workspace splits a large block the warm-up cached on the stream and
    keeps that whole segment reserved for the life of the process."""
    stream = torch.cuda.Stream(device)
    with torch.cuda.stream(stream), torch.enable_grad():
        a = torch.ones(16, 16, device=device, requires_grad=True)
        torch.addmm(a[0], a, a).sum().backward()
    stream.synchronize()
    return stream


def capture_state() -> tuple:
    """What a step reads from process state while it is captured: the
    ``contrib.amp.init`` dtype and the kernel knobs. Owners key their
    programs on it beside the signature, so that a change captures anew
    instead of replaying the old choice."""
    from ..contrib import amp as _amp

    return (_amp.amp_dtype(),) + tuple(
        _config.get(k) for k in _config.STEP_KNOBS)


def _counter_modules():
    from ..contrib import quantization
    from . import flash_attention, layernorm, optimizer, paged_attention, \
        softmax_xent

    return (flash_attention, layernorm, optimizer, paged_attention,
            softmax_xent, quantization)


def launch_counts() -> Dict[tuple, int]:
    """Every kernel wrapper's launch count, keyed (module, key): key is
    None for a counter that is one int, the dict key otherwise."""
    out = {}
    for mod in _counter_modules():
        counts = mod.launches
        if isinstance(counts, dict):
            out.update(((mod.__name__, k), v) for k, v in counts.items())
        else:
            out[(mod.__name__, None)] = counts
    return out


def _add_launches(delta: Dict[tuple, int], sign: int = 1) -> None:
    mods = {m.__name__: m for m in _counter_modules()}
    for (name, key), n in delta.items():
        mod = mods[name]
        if key is None:
            mod.launches += sign * n
        else:
            mod.launches[key] += sign * n


def unreplayed_calls() -> int:
    """Calls so far, over every StepGraph that captures, that ran their
    step eagerly or captured it instead of replaying a graph."""
    return _unreplayed


def _no_trace() -> bool:
    return False


#: says whether a profiler session is open (no capture runs inside one);
#: the profiler installs its own through :func:`set_trace_probe`
_trace_open = _no_trace


def set_trace_probe(probe) -> None:
    """Install ``probe() -> bool``, true while a profiler session of this
    process is open."""
    global _trace_open
    _trace_open = probe


def capturing() -> bool:
    """True while a StepGraph captures (host code can then defer work to
    :func:`after_capture`)."""
    return _active is not None


def after_capture(fn: Callable[[], None]) -> None:
    """Run ``fn`` once, on the host, after the capture under way ends and
    before its first replay. For state that a captured kernel reads but
    that must not be a graph node: the Adam kernel's pointer table, whose
    host source a memcpy node would read again at every replay. Raises
    outside a StepGraph's capture."""
    if _active is None:
        raise MXNetError("after_capture() outside a StepGraph capture")
    _active._after.append(fn)


def persistent_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised device tensor that outlives the capture under way,
    for state that :func:`after_capture` fills. It is allocated outside the
    graph's memory pool: an address of the pool that this tensor took
    after an earlier node of the capture freed it would be written again by
    that node at every replay (and by the replays of graphs sharing the
    pool). Raises outside a StepGraph's capture."""
    if _active is None:
        raise MXNetError("persistent_empty() outside a StepGraph capture")
    nbytes = _active._kept + torch.Size(shape).numel() * dtype.itemsize
    if nbytes > KEEP_BYTES:
        raise MXNetError(f"persistent_empty(): {nbytes} bytes in one capture "
                         f"exceed KEEP_BYTES={KEEP_BYTES}")
    _active._kept = nbytes
    # an allocation on a stream that is not capturing comes from the
    # ordinary pool: from the block cached there before the capture
    with torch.cuda.stream(_keep_stream(_active.device)):
        out = torch.empty(shape, dtype=dtype, device=_active.device)
    _active._held.append(out)
    return out


def owned() -> dict:
    """A dict that belongs to the StepGraph under capture, for state its
    kernels share and no other graph may (the paged read's arrival
    counters): graphs replayed on different streams, or beside an eager
    step, then never touch each other's. Raises outside a capture."""
    if _active is None:
        raise MXNetError("owned() outside a StepGraph capture")
    return _active._owned


class GraphPool:
    """The memory pool that the step graphs of one owner share, since they
    never run at once. A capture that fails leaves its pool id unusable
    (PyTorch refuses to capture into it again), so the failure moves the
    owner's later captures to a new pool; graphs captured before keep the
    old one."""

    def __init__(self):
        self.handle = torch.cuda.graph_pool_handle()


class StepGraph:
    """The program of one step signature (see the module docstring).

    Parameters
    ----------
    fn : () -> tuple of tensors; reads static inputs only.
    sig : the signature, named in errors.
    device : the device the step runs on.
    stream : the owner's :func:`capture_stream` (needed to capture).
    pool : a :class:`GraphPool` shared with other graphs that never run
        at the same time as this one, or None for a private pool. Tensors
        that outlive the step must not be allocated inside a capture
        (:func:`persistent_empty`): any node of the capture, or of a graph
        sharing the pool, may write their address at a replay.
    capture : False runs the step eagerly at every call (see the module
        docstring); the CPU never captures.
    """

    def __init__(self, fn: Callable[[], Tuple[torch.Tensor, ...]], sig,
                 device: torch.device, stream=None, pool=None,
                 capture: bool = True):
        self.fn, self.sig, self.device, self.pool = fn, sig, device, pool
        self.stream = stream
        self.capture = bool(capture) and device.type == "cuda"
        if self.capture and stream is None:
            raise MXNetError(f"step {sig}: capturing needs the owner's "
                             f"capture_stream()")
        self.graph = None
        self.outputs: Optional[Tuple[torch.Tensor, ...]] = None
        #: calls so far (warm-up, capture-and-replay, replays)
        self.calls = 0
        #: launches one replay makes, per counter (recorded at capture)
        self.launches: Dict[tuple, int] = {}
        self._census = None  # the graph's node census, read at capture
        self._after = []
        self._kept = 0
        self._held = []  # persistent_empty() tensors the graph reads
        self._owned = {}

    @property
    def census(self):
        """The captured graph's :class:`~mxnet_tpu_torch.analysis.audit.
        ProgramReport` (``dialect="graph"``), or None before a capture.
        Raises what the graph walk raised at capture."""
        if isinstance(self._census, BaseException):
            raise RuntimeError(f"the census of step {self.sig}'s graph "
                               f"failed at capture") from self._census
        return self._census

    @property
    def replays_next(self) -> bool:
        """True when the next call replays a graph or, never capturing,
        runs the step as every call does."""
        return not self.capture or self.graph is not None

    def __call__(self) -> Tuple[torch.Tensor, ...]:
        global _unreplayed
        self.calls += 1
        if not self.capture:
            outs = tuple(self.fn())
            if self.outputs is None:
                self.outputs = tuple(o.detach().clone() for o in outs)
            else:
                for dst, o in zip(self.outputs, outs):
                    dst.copy_(o)
            return self.outputs
        if self.graph is None:
            _unreplayed += 1
            if self.calls == 1 or _trace_open():
                return self._warm_up()
            self._capture()
        self.graph.replay()
        _add_launches(self.launches)
        return self.outputs

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.device)
        side = self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = tuple(self.fn())
        cur.wait_stream(side)
        for o in outs:
            o.record_stream(cur)
        return outs

    def _capture(self):
        global _active
        # as torch.cuda.graph does: collect garbage now (a CUDA graph freed
        # during a capture invalidates it) and hand cached memory back, so
        # that the graph's pool can take it
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        with torch.cuda.stream(_keep_stream(self.device)):
            # cached for persistent_empty()
            torch.empty(KEEP_BYTES, dtype=torch.uint8, device=self.device)
        self._kept, self._after, self._held, self._owned = 0, [], [], {}
        before = launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = torch.cuda.graph_pool_handle() if self.pool is None \
            else self.pool.handle
        err = outs = None
        ended = False
        _active = self
        collecting = gc.isenabled()
        gc.disable()  # and no collection while it runs
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=pool)
                try:
                    outs = tuple(self.fn())
                except Exception as e:  # the first error is the cause
                    err = e
                try:
                    graph.capture_end()
                    ended = True
                except Exception as e:
                    err = err or e
        finally:
            _active = None
            if collecting:
                gc.enable()
            after = launch_counts()
            delta = {k: after[k] - before.get(k, 0) for k in after}
            # the capture launched nothing: take its counts back
            _add_launches(delta, -1)
        if err is not None:
            self._after, self._held, self._owned = [], [], {}
            if not ended:
                # a capture that ended (the step raised on the host, with
                # nothing illegal queued) holds its use of the pool and
                # gives it back when the graph is freed: releasing it here
                # too would free the pool under the graph, and PyTorch
                # aborts the process when the graph is destroyed
                _abandon_pool(self.device, pool)
                _close_generators(self.stream)
                if self.pool is not None:
                    self.pool.handle = torch.cuda.graph_pool_handle()
            raise MXNetError(f"CUDA graph capture of step {self.sig} failed "
                             f"(a host sync or a pageable copy inside the "
                             f"step?): {type(err).__name__}: {err}") from err
        self.launches = {k: n for k, n in delta.items() if n}
        from ..analysis import audit as _audit

        try:
            self._census = _audit.graph_census(graph)
        except Exception as e:  # raised again when an audit reads it
            self._census = e
        graph.instantiate()
        for fn in self._after:
            fn()
        self._after = []
        self.graph, self.outputs = graph, outs


def _close_generators(stream):
    """After a capture that did not end: PyTorch takes the CUDA generators
    out of their capture mode only at a successful end of capture, so
    every later eager draw from the default generator (a Dropout under
    ``TrainStep(engine_type="naive")``) raises "Offset increment outside
    graph capture". An empty capture on ``stream`` begins and ends that
    mode, and its graph is dropped."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "The CUDA Graph is empty"
        graph.capture_begin()
        graph.capture_end()
    del graph


def _abandon_pool(device, pool):
    """After a capture into ``pool`` that did not end (``capture_end``
    raised; a capture that ended belongs to its graph, which gives the
    pool's use back when it is freed). PyTorch stops sending
    allocations to the pool only once ``cudaStreamEndCapture`` succeeded,
    so a failed capture leaves the allocator believing a capture is under
    way, and it then defers, for good, the free of every block used on a
    second stream (memory that ``empty_cache`` never returns). End that
    here, and give back the pool's use that the capture took."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:  # "not currently recording": the capture ended it
        pass
    torch._C._cuda_releasePool(index, pool)

"""Structural analysis of the port's own step programs: the counterpart of
``mxnet_tpu/analysis/hlo_audit.py``.

The JAX auditor parses the two texts a jitted program passes through. The
port has no program text: what stands in for them is what the port runs.

  - **the record** (JAX's *lowered* program): one call of a step program's
    function traced under a ``TorchDispatchMode`` inside ``FakeTensorMode``
    (:func:`audit_program`). Every aten op the call dispatches (autograd's
    backward ops included) becomes one :class:`Op` with its normalized name,
    dtypes, shapes and the operands it writes in place. A hand-written
    kernel records *itself* as one ``custom_call`` op through
    :func:`record_kernel`, the hook each kernel wrapper holds beside its
    launch counter: the kernel's CUDA function, its operands and results,
    what it writes in place, its bytes and the product FLOPs of the function
    it computes (causal flash priced at the full T² of the plain
    composition). While recording, a wrapper launches nothing and runs no
    plain version; it makes its outputs with the right shapes on the fake
    device, so a record on the CPU and one on the card hold the same ops.
    The tensors are fake: shapes and dtypes, no data. The call changes no
    parameter, cache, optimizer state or random generator. Values
    (:class:`ValueDef`) are keyed by storage: a value's definition is the op
    that allocates it, its uses the later ops that read or write it; the
    program's inputs (the real tensors it reads) are pinned parameters.
  - **the captured graph** (JAX's *compiled* program): the CUDA graph a
    :class:`~mxnet_tpu_torch.ops.cuda_graph.StepGraph` replays, read once
    right after its capture through libcuda's graph API
    (:func:`graph_census`): kernel nodes (function, grid, block, dynamic
    shared memory), memcpy nodes (kind, bytes), memset, host and other
    nodes, and the edges between them. The runtime API cannot be used for
    it: ``cudaGraphKernelNodeGetParams`` does not know the functions of
    another library's statically linked runtime (the port's kernels) and
    fails with ``cudaErrorInvalidDeviceFunction``, which PyTorch's next
    error check then reports. On the CPU there is no graph.

A :class:`ProgramReport` is queried as the JAX one is (``count``,
``dot_dtypes``, ``ops_with_dtype("f64")``, ``host_transfers``,
``has_tensor``, ``summary``); :class:`ProgramAudit` pairs the record with
the graph, and ``carry_donation() == 1.0`` is the in-place-carry check: a
carry input is *aliased* when the program writes its storage in place and
allocates no replacement for it.

Also here, as in the JAX module: :class:`Fingerprint`,
:func:`fingerprint_diff` and :class:`RecompileGuard`, which explain each
new step program by the change that forced it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import re
from collections import Counter as _Counter
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Op", "DonationReport", "ProgramReport", "ProgramAudit",
           "ValueDef", "audit_program", "graph_census", "record_kernel",
           "recording", "Fingerprint", "fingerprint_diff", "RecompileGuard",
           "DTYPE_BYTES", "KERNEL_FUNCTIONS", "kernel_base_name",
           "census_mismatches"]

#: element width in bytes per dtype token (pred stored as one byte)
DTYPE_BYTES: Dict[str, int] = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8, "f8e4m3fn": 1, "f8e5m2": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "c64": 8, "c128": 16,
}


def tensor_bytes(dtype: Optional[str], shape: Sequence[int]) -> int:
    """Logical bytes of one tensor (4-byte fallback for unknown dtypes)."""
    n = 1
    for d in shape:
        n *= d
    return n * DTYPE_BYTES.get(dtype or "", 4)


@functools.lru_cache(maxsize=None)
def dtype_token(dtype) -> str:
    """The JAX package's dtype token of a torch dtype (``f32``, ``bf16``)."""
    import torch

    return {torch.float32: "f32", torch.bfloat16: "bf16",
            torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
            torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
            torch.int64: "s64", torch.bool: "pred", torch.complex64: "c64",
            torch.complex128: "c128", torch.float8_e4m3fn: "f8e4m3fn",
            torch.float8_e5m2: "f8e5m2"}.get(
                dtype, str(dtype).replace("torch.", ""))


#: ops that move data between the host and the card: a step program must
#: never hold one (a host read of a value, or a copy across the bus)
HOST_TRANSFER_OPS = frozenset({"copy_to_host", "copy_from_host",
                               "memcpy_dtoh", "memcpy_htod"})

#: collective ops (none on one card; the names are NCCL's families)
COLLECTIVE_OPS = frozenset({
    "all_reduce", "all_gather", "reduce_scatter", "collective_permute",
    "all_to_all", "collective_broadcast",
})

#: aten products: everything that lands on the tensor cores or SGEMM
DOT_OPS = frozenset({"mm", "addmm", "bmm", "baddbmm", "linear", "matmul",
                     "addmv", "mv", "dot", "_int_mm", "_scaled_mm",
                     "convolution", "convolution_backward",
                     "cudnn_convolution", "_convolution"})

#: aten ops whose result shares its input's storage (views, in the census
#: like any op, free in the schedule)
VIEW_OPS = frozenset({"view", "_unsafe_view", "reshape", "t", "transpose",
                      "permute", "expand", "slice", "select", "unsqueeze",
                      "squeeze", "as_strided", "detach", "alias", "unbind",
                      "split", "split_with_sizes", "narrow", "diagonal",
                      "view_as_real", "view_as_complex", "unfold", "lift_fresh",
                      "_reshape_alias", "chunk", "indices", "values",
                      "_indices", "_values"})

#: the CUDA functions behind each launch counter
#: (``ops.cuda_graph.launch_counts`` keys): a graph's kernel nodes are
#: matched to the counters by these names
KERNEL_FUNCTIONS: Dict[Tuple[str, Optional[str]], Tuple[str, ...]] = {
    ("mxnet_tpu_torch.ops.flash_attention", "fwd"): ("flash_fwd_tc_kernel",),
    ("mxnet_tpu_torch.ops.flash_attention", "dkv"):
        ("flash_bwd_dkv_tc_kernel",),
    ("mxnet_tpu_torch.ops.flash_attention", "dq"): ("flash_bwd_dq_tc_kernel",),
    ("mxnet_tpu_torch.ops.layernorm", "fwd"):
        ("layernorm_fwd_warp_kernel", "layernorm_fwd_block_kernel"),
    ("mxnet_tpu_torch.ops.layernorm", "bwd"):
        ("layernorm_bwd_warp_kernel", "layernorm_bwd_block_kernel"),
    ("mxnet_tpu_torch.ops.layernorm", "bwd_merge"):
        ("layernorm_bwd_merge_kernel",),
    ("mxnet_tpu_torch.ops.optimizer", None): ("adam_kernel",),
    ("mxnet_tpu_torch.ops.paged_attention", "decode"):
        ("paged_attention_kernel",),
    ("mxnet_tpu_torch.ops.paged_attention", "prefill"):
        ("paged_prefill_tc_kernel",),
    ("mxnet_tpu_torch.ops.softmax_xent", "fwd"): ("xent_fwd_kernel",),
    ("mxnet_tpu_torch.ops.softmax_xent", "bwd"): ("xent_bwd_kernel",),
    ("mxnet_tpu_torch.contrib.quantization", "int8_im2col"):
        ("int8_im2col_kernel",),
    ("mxnet_tpu_torch.contrib.quantization", "int8_gemm_wgmma"):
        ("int8_gemm_wgmma_kernel",),
    ("mxnet_tpu_torch.contrib.quantization", "int8_gemm_mma"):
        ("int8_gemm_kernel",),
    ("mxnet_tpu_torch.contrib.quantization", "int8_gemm"):
        ("int8_gemm_wgmma_kernel", "int8_gemm_kernel"),
}

#: every function name of the port's kernels
PORT_KERNELS = frozenset(n for names in KERNEL_FUNCTIONS.values()
                         for n in names)


def kernel_base_name(name: str) -> str:
    """The unqualified function name of a kernel as a graph node, a trace
    row or a record names it: ``_Z25layernorm_fwd_warp_kernelIffLi8EE...``,
    ``void at::native::vectorized_elementwise_kernel<4, ...>(...)`` and
    ``layernorm_fwd_warp_kernel`` give ``layernorm_fwd_warp_kernel`` and
    ``vectorized_elementwise_kernel``."""
    if name.startswith("_Z"):
        s = name[2:]
        if s.startswith("N"):  # nested name: the last component
            s = s[1:]
        last = ""
        while s and s[0].isdigit():
            m = re.match(r"(\d+)", s)
            n = int(m.group(1))
            last = s[m.end():m.end() + n]
            s = s[m.end() + n:]
            if not s or s[0] in "IE":
                break
        return last or name
    base = name.replace("(anonymous namespace)", "")
    base = base.split("(", 1)[0].split("<", 1)[0].rsplit("::", 1)[-1]
    words = base.split()
    return words[-1] if words else name


def _normalize_op(name: str) -> str:
    """``aten.mm.default`` / ``aten::mm`` / ``mm`` -> ``mm``."""
    name = name.replace("aten::", "").replace("aten.", "")
    return name.split(".", 1)[0]


@dataclasses.dataclass
class Op:
    """One recorded op or graph node: normalized name, result dtype and
    shape, and every operand and result dtype and shape (operands first:
    ``shapes[:n_in]``). A hand-written kernel is ``custom_call`` with its
    CUDA function in ``kernel`` and its launch counter in ``counter``."""

    name: str
    dtype: Optional[str]
    shape: Tuple[int, ...]
    dtypes: Tuple[str, ...]
    line: int
    shapes: Tuple[Tuple[int, ...], ...] = ()
    n_in: int = 0                       # operands among dtypes/shapes
    mutated: Tuple[int, ...] = ()       # operand positions written in place
    kernel: Optional[str] = None        # CUDA function (kernels, graph nodes)
    counter: Optional[tuple] = None     # launch counter of a port kernel
    flops: Optional[float] = None       # product FLOPs of a kernel record
    bytes: int = 0                      # bytes read once + written once
    attrs: Dict = dataclasses.field(default_factory=dict)
    # the parsed contraction dims of a JAX-vocabulary op (``dot_general``),
    # priced by observability.goodput as the JAX package prices it
    dot_meta: Optional[dict] = None

    def __repr__(self):
        dims = "x".join(map(str, self.shape)) or "scalar"
        what = f" {self.kernel}" if self.kernel else ""
        return f"Op({self.name}{what}: {self.dtype}[{dims}] @L{self.line})"



@dataclasses.dataclass
class ValueDef:
    """One value definition: the def/use record the liveness pass
    (:mod:`.memory`) and the schedule (:mod:`.schedule`) sweep, as in the
    JAX module. In a record, a value is one op's new storages (their bytes
    summed, each result's dtype and shape in ``results``); a row with an
    empty ``vid`` allocates nothing (a view, an in-place write) but its
    uses extend its operands' lives. ``scratch`` is what a kernel allocates
    for its launch alone: live at its own row only."""

    vid: str
    op: str
    bytes: int
    results: Tuple[Tuple[str, Tuple[int, ...]], ...]
    uses: Tuple[str, ...]
    line: int
    param: Optional[int] = None
    scratch: int = 0

    def __repr__(self):
        return f"ValueDef(%{self.vid}: {self.op} {self.bytes}B @L{self.line})"


@dataclasses.dataclass
class DonationReport:
    """Which program inputs the program updates in place: the port's
    counterpart of donated, aliased inputs."""

    n_inputs: int
    aliased: Dict[int, str]  # input index -> "in-place"

    @property
    def n_aliased(self) -> int:
        return len(self.aliased)

    def coverage(self, indices: Optional[Sequence[int]] = None) -> float:
        """Fraction of ``indices`` (default: all inputs) that are aliased:
        1.0 means every carry buffer is updated in place."""
        idx = range(self.n_inputs) if indices is None else list(indices)
        n = len(idx)
        if n == 0:
            return 1.0
        return sum(1 for i in idx if i in self.aliased) / n

    def missing(self, indices: Sequence[int]) -> List[int]:
        return [i for i in indices if i not in self.aliased]


@dataclasses.dataclass
class ProgramReport:
    """Structured view of one recorded program (``dialect="record"``) or
    captured graph (``dialect="graph"``)."""

    dialect: str
    ops: List[Op]
    collectives: List[Op]
    custom_calls: List[str]  # kernel functions, in program order
    donation: DonationReport
    inputs: List[Tuple[str, Tuple[int, ...]]]
    n_lines: int
    values: List[ValueDef] = dataclasses.field(default_factory=list)
    output_ids: Tuple[str, ...] = ()
    #: graph edges (from node, to node), by node index
    edges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    device: str = ""
    #: what the real tensors behind ``inputs`` hold: the sum of their
    #: storages' ``nbytes``, read when they were recorded (0 for a graph)
    input_storage_bytes: int = 0

    # -- census --------------------------------------------------------------
    def op_census(self) -> Dict[str, int]:
        return dict(_Counter(o.name for o in self.ops))

    def count(self, op: str) -> int:
        op = _normalize_op(op)
        return sum(1 for o in self.ops if o.name == op)

    def has(self, op: str) -> bool:
        return self.count(op) > 0

    def dtype_census(self) -> Dict[str, int]:
        """How many ops *mention* each dtype (operands included): the
        f64-promotion-leak detector reads this."""
        c: _Counter = _Counter()
        for o in self.ops:
            for dt in set(o.dtypes):
                c[dt] += 1
        return dict(c)

    def ops_with_dtype(self, dtype: str) -> List[Op]:
        return [o for o in self.ops if dtype in o.dtypes]

    # -- products ------------------------------------------------------------
    def dots(self) -> List[Op]:
        return [o for o in self.ops if o.name in DOT_OPS]

    def dot_dtypes(self) -> Dict[str, int]:
        """Result-dtype census of every aten product (the AMP coverage
        check: ``dot_dtypes() == {"bf16": len(dots())}``)."""
        return dict(_Counter(o.dtype for o in self.dots() if o.dtype))

    # -- kernels -------------------------------------------------------------
    def kernels(self) -> List[Op]:
        """The port's kernels: custom_call records, or the graph's kernel
        nodes of a port kernel function."""
        if self.dialect == "graph":
            return [o for o in self.ops if o.name == "kernel" and
                    kernel_base_name(o.kernel or "") in PORT_KERNELS]
        return [o for o in self.ops if o.name == "custom_call"]

    def kernel_counts(self) -> Dict[tuple, int]:
        """Port kernel launches by launch counter key, as
        ``ops.cuda_graph.launch_counts`` keys them."""
        out: Dict[tuple, int] = {}
        if self.dialect == "graph":
            names = [kernel_base_name(o.kernel or "") for o in self.kernels()]
            for key, funcs in KERNEL_FUNCTIONS.items():
                n = sum(1 for nm in names if nm in funcs)
                if n:
                    out[key] = n
            return out
        for o in self.kernels():
            out[o.counter] = out.get(o.counter, 0) + 1
            if o.counter and o.counter[1] in ("int8_gemm_wgmma",
                                              "int8_gemm_mma"):
                agg = (o.counter[0], "int8_gemm")
                out[agg] = out.get(agg, 0) + 1
        return out

    # -- collectives ---------------------------------------------------------
    def collective_counts(self) -> Dict[str, int]:
        return dict(_Counter(c.name for c in self.collectives))

    # -- host traffic --------------------------------------------------------
    def host_transfers(self) -> List[Op]:
        return [o for o in self.ops if o.name in HOST_TRANSFER_OPS]

    # -- shape queries -------------------------------------------------------
    def has_tensor(self, shape: Tuple[int, ...],
                   dtype: Optional[str] = None,
                   suffix: bool = False) -> bool:
        """Does any op mention a tensor of exactly ``shape`` (or, with
        ``suffix=True``, any tensor whose trailing dims equal it)? The
        flash contract check: no [.., L, L] buffer."""
        shape = tuple(shape)
        n = len(shape)
        for o in self.ops:
            for dt, s in zip(o.dtypes, o.shapes):
                if dtype is not None and dt != dtype:
                    continue
                if s == shape or (suffix and len(s) >= n
                                  and tuple(s[-n:]) == shape):
                    return True
        return False

    def summary(self) -> dict:
        """JSON-safe digest (``tools/torch_audit.py`` prints this)."""
        out = {
            "dialect": self.dialect,
            "n_ops": len(self.ops),
            "op_census": self.op_census(),
            "dtype_census": self.dtype_census(),
            "dots": self.dot_dtypes(),
            "collectives": self.collective_counts(),
            "custom_calls": list(self.custom_calls),
            "kernels": {f"{k[0].rsplit('.', 1)[-1]}:{k[1]}": v
                        for k, v in sorted(self.kernel_counts().items(),
                                           key=str)},
            "host_transfers": [o.name for o in self.host_transfers()],
            "donation": {"n_inputs": self.donation.n_inputs,
                         "n_aliased": self.donation.n_aliased},
        }
        if self.dialect == "graph":
            out["n_edges"] = len(self.edges)
        return out


@dataclasses.dataclass
class ProgramAudit:
    """The record (``lowered``) and the captured graph (``compiled``) of
    one step program, the flat input indices of its carry and the reports
    built over the record. ``compiled`` is None on the CPU and before the
    program's graph is captured; ``why_not_compiled`` says which.
    Returned by ``TrainStep.audit()`` / ``GenerationEngine.audit()``."""

    lowered: ProgramReport
    compiled: Optional[ProgramReport]
    carry_indices: Tuple[int, ...] = ()
    comm: Optional[object] = None
    memory: Optional[object] = None
    schedule: Optional[object] = None
    why_not_compiled: str = ""
    #: the launch counters' delta over the graph's capture (one replay)
    launches: Dict[tuple, int] = dataclasses.field(default_factory=dict)

    def carry_donation(self) -> float:
        """In-place coverage of the carry (parameters, masters and
        optimizer states of a TrainStep; the KV pools of an engine): 1.0 =
        every carry buffer is updated in place. Read from the record: a
        graph holds no tensor identities, and it replays the recorded
        function over the same storage."""
        return self.lowered.donation.coverage(self.carry_indices)

    def carry_missing(self) -> List[int]:
        return self.lowered.donation.missing(self.carry_indices)

    def census(self) -> Dict[str, Dict]:
        """Port kernels per launch counter in the record, the graph and the
        counters' delta over the capture: three equal columns when the
        audit sees every kernel the program launches."""
        rec = self.lowered.kernel_counts()
        out = {"record": rec}
        if self.compiled is not None:
            out["graph"] = self.compiled.kernel_counts()
            out["launches"] = {k: v for k, v in self.launches.items() if v}
        return out

    def summary(self) -> dict:
        out = {"lowered": self.lowered.summary(),
               "carry": {"n": len(self.carry_indices),
                         "donation_coverage": self.carry_donation(),
                         "missing": self.carry_missing()}}
        if self.compiled is not None:
            out["compiled"] = self.compiled.summary()
        else:
            out["why_not_compiled"] = self.why_not_compiled
        if self.comm is not None:
            out["comm"] = self.comm.summary()
        if self.memory is not None:
            out["memory"] = self.memory.summary()
        if self.schedule is not None:
            out["schedule"] = self.schedule.summary()
        return out


def census_mismatches(audit: ProgramAudit) -> List[str]:
    """Counter keys on which the record, the graph and the launch counters
    disagree ([] when they agree, or when there is no graph and the record
    is all there is)."""
    cols = audit.census()
    keys = set().union(*(set(c) for c in cols.values()))
    out = []
    for k in sorted(keys, key=str):
        vals = {name: col.get(k, 0) for name, col in cols.items()}
        if len(set(vals.values())) > 1:
            out.append(f"{k[0].rsplit('.', 1)[-1]}:{k[1]} {vals}")
    return out


# -- the record ----------------------------------------------------------------
#: recordings under way in the process: while 0, :func:`recording` is one
#: global read (the kernel wrappers ask at every launch)
_active = 0


def _recorder():
    """The record of the recording mode on this thread's dispatch stack
    (autograd's device threads inherit it), or None."""
    if not _active:
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        rec = getattr(mode, "mx_record", None)
        if rec is not None:
            return rec
    return None


def recording() -> bool:
    """True while :func:`audit_program` records the calling code (a kernel
    wrapper then records itself through :func:`record_kernel` and launches
    nothing)."""
    rec = _recorder()
    return rec is not None and not rec.paused


@contextlib.contextmanager
def not_a_product(reason: str):
    """Ops recorded inside stay in the census but are no product of the
    FLOPs model (``observability.goodput``): for a product that computes
    what the model's math has as something else, as a one-hot product
    computes a gather's scatter-add."""
    rec = _recorder()
    if rec is None:
        yield
        return
    prev, rec.tag = rec.tag, reason
    try:
        yield
    finally:
        rec.tag = prev


def _storage_key(t) -> int:
    return t.untyped_storage()._cdata


def _flat_tensors(obj, out):
    import torch

    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _flat_tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _flat_tensors(o, out)
    return out


class _Record:
    """The state of one recording: the fake mode, the inputs (real tensors
    the program reads), the ops and the def/use rows."""

    def __init__(self, fake_mode):
        self.fake = fake_mode
        self.paused = False
        self.ops: List[Op] = []
        self.values: List[ValueDef] = []
        self.inputs: List[Tuple[str, Tuple[int, ...]]] = []
        self.input_of: Dict[int, int] = {}   # storage key -> input index
        self.vid_of: Dict[int, str] = {}     # storage key -> value id
        self.written: set = set()            # input indices written
        self.keep: list = []                 # storages alive while recording
        self.memo: Dict[int, object] = {}    # id(real) -> fake
        self.device = ""                     # the first input's device
        self.storage_bytes = 0               # the inputs' real storages
        self.tag = None                      # set by not_a_product()

    def fake_of(self, t):
        """The fake tensor standing for ``t``; a real tensor becomes an
        input of the program (once per storage)."""
        from torch._subclasses.fake_tensor import FakeTensor

        if isinstance(t, FakeTensor):
            return t
        f = self.memo.get(id(t))
        if f is None:
            f = self.fake.from_tensor(t)
            self.memo[id(t)] = f
            self.keep.append((t, f))
        key = _storage_key(f)
        if key not in self.vid_of:
            self.device = self.device or str(t.device)
            self.storage_bytes += t.untyped_storage().nbytes()
            idx = len(self.inputs)
            self.input_of[key] = idx
            self.inputs.append((dtype_token(t.dtype), tuple(t.shape)))
            self.vid_of[key] = f"arg{idx}"
            self.values.append(ValueDef(
                vid=f"arg{idx}", op="parameter",
                bytes=tensor_bytes(dtype_token(t.dtype), t.shape),
                results=((dtype_token(t.dtype), tuple(t.shape)),), uses=(),
                line=0, param=idx))
        return f

    def add(self, name, operands, results, written, kernel=None,
            counter=None, flops=None, attrs=None, nbytes=None, scratch=0):
        """Record one op over fake ``operands`` (read, or written in place
        when their position is in ``written``) and fake ``results``."""
        line = len(self.ops) + 1
        uses, seen = [], set()
        for t in operands:
            key = _storage_key(t)
            vid = self.vid_of.get(key)
            if vid is not None and vid not in seen:
                seen.add(vid)
                uses.append(vid)
        for i in written:
            key = _storage_key(operands[i])
            if key in self.input_of:
                self.written.add(self.input_of[key])
        new, new_res, nb = {}, [], 0
        for t in results:
            key = _storage_key(t)
            if key in self.vid_of or key in new:
                continue
            new[key] = t
            nb += t.untyped_storage().nbytes()
            new_res.append((dtype_token(t.dtype), tuple(t.shape)))
        vid = ""
        if new:
            vid = f"v{line}"
            for key, t in new.items():
                self.vid_of[key] = vid
                self.keep.append(t)
        self.values.append(ValueDef(vid=vid, op=name, bytes=nb,
                                    results=tuple(new_res), uses=tuple(uses),
                                    line=line, scratch=scratch))
        if self.tag is not None:
            attrs = dict(attrs or {}, not_a_product=self.tag)
        tensors = list(operands) + list(results)
        dts = tuple(dtype_token(t.dtype) for t in tensors)
        shs = tuple(tuple(t.shape) for t in tensors)
        if nbytes is None:
            nbytes = 0 if name in VIEW_OPS else (
                sum(tensor_bytes(dtype_token(t.dtype), t.shape)
                    for t in operands)
                + sum(tensor_bytes(dtype_token(t.dtype), t.shape)
                      for t in results)
                + sum(tensor_bytes(dtype_token(operands[i].dtype),
                                   operands[i].shape) for i in written))
        if results:
            rdt, rsh = dts[len(operands)], shs[len(operands)]
        elif written:
            rdt = dtype_token(operands[written[0]].dtype)
            rsh = tuple(operands[written[0]].shape)
        else:
            rdt, rsh = None, ()
        self.ops.append(Op(name, rdt, rsh, dts, line, shapes=shs,
                           n_in=len(operands), mutated=tuple(written),
                           kernel=kernel, counter=counter, flops=flops,
                           bytes=int(nbytes), attrs=dict(attrs or {})))


def _dispatch_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _RecordMode(TorchDispatchMode):
        """Records each aten op the call dispatches (see the module
        docstring); real tensor arguments become the program's inputs."""

        def __init__(self, rec: _Record):
            super().__init__()
            self.rec = rec
            self.mx_record = rec  # what _recorder() looks for

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch
            from torch.utils._pytree import tree_map

            kwargs = kwargs or {}
            rec = self.rec

            def conv(x):
                return rec.fake_of(x) if isinstance(x, torch.Tensor) else x

            args, kwargs = tree_map(conv, (args, kwargs))
            name = _normalize_op(func.__name__)
            if name == "_local_scalar_dense" and not rec.paused:
                # a host read of a value: recorded, and answered with a
                # zero of the value's kind (a fake tensor holds no value)
                t = args[0]
                rec.add("copy_to_host", [t], [], ())
                return (False if t.dtype == torch.bool else
                        0 if not t.is_floating_point() else 0.0)
            out = func(*args, **kwargs)
            if rec.paused or func.namespace == "prim":
                return out  # prim ops query metadata (device, dim)
            operands, written = [], []
            for i, a in enumerate(func._schema.arguments):
                val = args[i] if i < len(args) else kwargs.get(a.name)
                tens = _flat_tensors(val, []) if val is not None else []
                if a.alias_info is not None and a.alias_info.is_write:
                    written.extend(range(len(operands),
                                         len(operands) + len(tens)))
                operands.extend(tens)
            results = _flat_tensors(out, [])
            if not results and not written:
                return out  # a metadata query (sym_size, is_contiguous)
            if name in ("_to_copy", "copy_") and operands and results:
                src = operands[-1] if name == "copy_" else operands[0]
                dst = operands[0] if name == "copy_" else results[0]
                if src.device.type != dst.device.type:
                    name = ("copy_to_host" if dst.device.type == "cpu"
                            else "copy_from_host")
            attrs = {}
            if name in ("convolution", "convolution_backward"):
                # (transposed, groups) sit at 6, 8 of the forward's
                # arguments and 7, 9 of the backward's, before its mask
                at = 6 if name == "convolution" else 7
                attrs["transposed"] = bool(args[at])
                attrs["groups"] = int(args[at + 2])
                if name == "convolution_backward":
                    attrs["output_mask"] = tuple(bool(m) for m in args[10])
            rec.add(name, operands, results, tuple(written), attrs=attrs)
            return out

    return _RecordMode


def record_kernel(counter: Tuple[str, Optional[str]], kernel: str, inputs,
                  outputs=(), written=(), flops: float = 0.0, scratch=()):
    """The record hook of a kernel wrapper: called instead of the launch
    while :func:`recording`. ``inputs`` are the kernel's operand tensors,
    ``outputs`` ``(shape, dtype)`` of the tensors it makes, ``written`` the
    positions in ``inputs`` it writes in place, ``flops`` the product FLOPs
    of the function it computes (0 for one without products), ``scratch``
    ``(shape, dtype)`` of the buffers the wrapper allocates for the launch
    alone (live at this op only: ``ValueDef.scratch``). Records one
    ``custom_call`` op and returns the outputs as fake tensors on the
    inputs' device."""
    import torch

    rec = _recorder()
    rec.paused = True  # a view's fake is made by an as_strided: not an op
    try:
        inputs = [rec.fake_of(t) for t in inputs]
        device = inputs[0].device if inputs else None
        with torch.no_grad():
            outs = [torch.empty(tuple(shape), dtype=dtype, device=device)
                    for shape, dtype in outputs]
    finally:
        rec.paused = False
    rec.add("custom_call", inputs, outs, tuple(written), kernel=kernel,
            counter=tuple(counter), flops=float(flops),
            scratch=sum(tensor_bytes(dtype_token(dtype), shape)
                        for shape, dtype in scratch))
    return outs


def audit_program(fn, carry: Sequence = (), inputs: Sequence = (),
                  outputs_of=None) -> ProgramReport:
    """Record one call of ``fn()`` (a step program's function) on fake
    tensors into a :class:`ProgramReport` (``dialect="record"``). The
    tensors of ``carry`` and then of ``inputs`` are the program's first
    inputs, in that order (so the carry is ``range(len(carry))``); any
    other real tensor the call reads becomes a further input. Nothing the
    call touches changes: parameters, caches, optimizer states and random
    generators stay as they were."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    global _active
    if _recorder() is not None:
        raise RuntimeError("audit_program: a recording is already under way "
                           "on this thread")
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    rec = _Record(fake_mode)
    mode = _dispatch_mode()(rec)
    cpu_rng = torch.random.get_rng_state()
    cuda_rng = torch.cuda.get_rng_state_all() \
        if torch.cuda.is_available() and torch.cuda.is_initialized() else None
    _active += 1
    try:
        with fake_mode:
            for t in list(carry) + list(inputs):
                rec.fake_of(t)
            with mode:
                out = fn()
    finally:
        _active -= 1
        torch.random.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state_all(cuda_rng)
    outs = _flat_tensors(out if outputs_of is None else outputs_of(out), [])
    output_ids = tuple(rec.vid_of.get(_storage_key(t), "") for t in outs)
    return ProgramReport(
        dialect="record", ops=rec.ops, collectives=[
            o for o in rec.ops if o.name in COLLECTIVE_OPS],
        custom_calls=[o.kernel for o in rec.ops if o.name == "custom_call"],
        donation=DonationReport(n_inputs=len(rec.inputs),
                                aliased={i: "in-place"
                                         for i in sorted(rec.written)}),
        inputs=rec.inputs, n_lines=len(rec.ops), values=rec.values,
        output_ids=output_ids, device=rec.device,
        input_storage_bytes=rec.storage_bytes)


# -- the captured graph ----------------------------------------------------------
#: CUgraphNodeType -> census name
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "child_graph", 5: "empty", 6: "event_wait",
               7: "event_record", 8: "semaphore_signal",
               9: "semaphore_wait", 10: "mem_alloc", 11: "mem_free",
               12: "batch_mem_op", 13: "conditional"}
#: CUmemorytype -> letter of a memcpy's kind (host, device, array, unified)
_MEM_KIND = {1: "h", 2: "d", 3: "a", 4: "d"}


class _KernelParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("gridDimX", ctypes.c_uint),
                ("gridDimY", ctypes.c_uint), ("gridDimZ", ctypes.c_uint),
                ("blockDimX", ctypes.c_uint), ("blockDimY", ctypes.c_uint),
                ("blockDimZ", ctypes.c_uint),
                ("sharedMemBytes", ctypes.c_uint),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


class _Memcpy3D(ctypes.Structure):  # CUDA_MEMCPY3D
    _fields_ = [("srcXInBytes", ctypes.c_size_t), ("srcY", ctypes.c_size_t),
                ("srcZ", ctypes.c_size_t), ("srcLOD", ctypes.c_size_t),
                ("srcMemoryType", ctypes.c_int), ("srcHost", ctypes.c_void_p),
                ("srcDevice", ctypes.c_void_p), ("srcArray", ctypes.c_void_p),
                ("reserved0", ctypes.c_void_p), ("srcPitch", ctypes.c_size_t),
                ("srcHeight", ctypes.c_size_t),
                ("dstXInBytes", ctypes.c_size_t), ("dstY", ctypes.c_size_t),
                ("dstZ", ctypes.c_size_t), ("dstLOD", ctypes.c_size_t),
                ("dstMemoryType", ctypes.c_int), ("dstHost", ctypes.c_void_p),
                ("dstDevice", ctypes.c_void_p), ("dstArray", ctypes.c_void_p),
                ("reserved1", ctypes.c_void_p), ("dstPitch", ctypes.c_size_t),
                ("dstHeight", ctypes.c_size_t),
                ("WidthInBytes", ctypes.c_size_t), ("Height", ctypes.c_size_t),
                ("Depth", ctypes.c_size_t)]


class _MemsetParams(ctypes.Structure):  # CUDA_MEMSET_NODE_PARAMS
    _fields_ = [("dst", ctypes.c_void_p), ("pitch", ctypes.c_size_t),
                ("value", ctypes.c_uint), ("elementSize", ctypes.c_uint),
                ("width", ctypes.c_size_t), ("height", ctypes.c_size_t)]


_libcuda_handle = None


def _libcuda():
    global _libcuda_handle
    if _libcuda_handle is None:
        _libcuda_handle = ctypes.CDLL("libcuda.so.1")
    return _libcuda_handle


def _check(rc, what):
    if rc != 0:
        raise RuntimeError(f"graph census: {what} failed with CUresult {rc}")


def graph_census(cuda_graph) -> ProgramReport:
    """Read a captured graph (a ``torch.cuda.CUDAGraph`` built with
    ``keep_graph=True``, before or after ``instantiate()``) into a
    :class:`ProgramReport` (``dialect="graph"``): one op a node, in the
    graph's node order, and the edges. Raises when libcuda refuses a
    query: a failed walk never returns an empty census."""
    lib = _libcuda()
    g = ctypes.c_void_p(cuda_graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    _check(lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    index = {}
    ops: List[Op] = []
    get_kernel = getattr(lib, "cuGraphKernelNodeGetParams_v2", None) or \
        lib.cuGraphKernelNodeGetParams
    for i in range(n.value):
        node = ctypes.c_void_p(nodes[i])
        index[nodes[i]] = i
        t = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(t)),
               "cuGraphNodeGetType")
        kind = _NODE_TYPES.get(t.value, f"node{t.value}")
        op = Op(kind, None, (), (), i + 1)
        if kind == "kernel":
            kp = _KernelParams()
            _check(get_kernel(node, ctypes.byref(kp)),
                   "cuGraphKernelNodeGetParams")
            name = ctypes.c_char_p()
            _check(lib.cuFuncGetName(ctypes.byref(name),
                                     ctypes.c_void_p(kp.func)),
                   "cuFuncGetName")
            op.kernel = kernel_base_name(name.value.decode())
            op.attrs = {"function": name.value.decode(),
                        "grid": (kp.gridDimX, kp.gridDimY, kp.gridDimZ),
                        "block": (kp.blockDimX, kp.blockDimY, kp.blockDimZ),
                        "smem": kp.sharedMemBytes}
        elif kind == "memcpy":
            mp = _Memcpy3D()
            _check(lib.cuGraphMemcpyNodeGetParams(node, ctypes.byref(mp)),
                   "cuGraphMemcpyNodeGetParams")
            src = _MEM_KIND.get(mp.srcMemoryType, "?")
            dst = _MEM_KIND.get(mp.dstMemoryType, "?")
            op.name = f"memcpy_{src}to{dst}"
            op.bytes = int(mp.WidthInBytes * max(1, mp.Height)
                           * max(1, mp.Depth))
            op.attrs = {"kind": f"{src.upper()}to{dst.upper()}"}
        elif kind == "memset":
            ms = _MemsetParams()
            _check(lib.cuGraphMemsetNodeGetParams(node, ctypes.byref(ms)),
                   "cuGraphMemsetNodeGetParams")
            op.bytes = int(ms.elementSize * ms.width * max(1, ms.height))
        ops.append(op)
    ne = ctypes.c_size_t(0)
    _check(lib.cuGraphGetEdges(g, None, None, ctypes.byref(ne)),
           "cuGraphGetEdges")
    edges: List[Tuple[int, int]] = []
    if ne.value:
        frm = (ctypes.c_void_p * ne.value)()
        to = (ctypes.c_void_p * ne.value)()
        _check(lib.cuGraphGetEdges(g, frm, to, ctypes.byref(ne)),
               "cuGraphGetEdges")
        edges = [(index[frm[j]], index[to[j]]) for j in range(ne.value)]
    return ProgramReport(
        dialect="graph", ops=ops, collectives=[],
        custom_calls=[o.kernel for o in ops if o.name == "kernel"
                      and kernel_base_name(o.kernel or "") in PORT_KERNELS],
        donation=DonationReport(n_inputs=0, aliased={}), inputs=[],
        n_lines=len(ops), edges=edges, device="cuda")


# -- program fingerprints & the recompile guard ------------------------------
@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Stable identity of one program signature: per-array shapes/dtypes +
    the static arguments the program is built for. Two equal fingerprints
    name the same program; the *diff* between two unequal ones is the
    cause of a new one."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[str, ...]
    static: Tuple[Tuple[str, str], ...]  # sorted (name, repr) pairs

    @classmethod
    def of(cls, arrays: Sequence, **static) -> "Fingerprint":
        shapes, dtypes = [], []
        for a in arrays:
            shapes.append(tuple(getattr(a, "shape", ())))
            dt = getattr(a, "dtype", type(a).__name__)
            dtypes.append(str(dt).replace("torch.", ""))
        return cls(tuple(shapes), tuple(dtypes),
                   tuple(sorted((str(k), repr(v)) for k, v in static.items())))

    def describe(self) -> dict:
        return {"shapes": [list(s) for s in self.shapes],
                "dtypes": list(self.dtypes),
                "static": {k: v for k, v in self.static}}


def fingerprint_diff(old: Fingerprint, new: Fingerprint):
    """Explain ``old -> new``: ``(cause, detail)`` where cause is
    ``"shape"`` | ``"dtype"`` | ``"static"`` | ``"arity"`` (first
    difference wins in that order of specificity) and detail a short
    string naming exactly what changed."""
    if len(old.shapes) != len(new.shapes):
        return "arity", (f"{len(old.shapes)} -> {len(new.shapes)} "
                         "batch arrays")
    for i, (a, b) in enumerate(zip(old.shapes, new.shapes)):
        if a != b:
            return "shape", f"arg{i}: {list(a)} -> {list(b)}"
    for i, (a, b) in enumerate(zip(old.dtypes, new.dtypes)):
        if a != b:
            return "dtype", f"arg{i}: {a} -> {b}"
    do, dn = dict(old.static), dict(new.static)
    for k in sorted(set(do) | set(dn)):
        if do.get(k) != dn.get(k):
            return "static", f"{k}: {do.get(k)} -> {dn.get(k)}"
    return "identical", ""


class RecompileGuard:
    """Fingerprint-keyed detector of new programs, with *causes*, as the
    JAX one: ``observe(fp)`` returns None for a signature already seen;
    for a new one it diffs against the closest previous fingerprint of the
    same ``group``, increments ``<counter>{reason=<cause>}`` and writes a
    ``recompile`` event whose ``cause``/``detail`` say what changed.
    ``label_map`` renames causes for the counter label; ``reason=``
    overrides the diffed cause (fixed labels by contract)."""

    def __init__(self, counter_name: str, help: str = "",
                 label_map: Optional[Dict[str, str]] = None,
                 event: str = "recompile"):
        self.counter_name = counter_name
        self.help = help
        self.label_map = label_map or {}
        self.event = event
        self._seen: List[Tuple[Optional[str], Fingerprint]] = []
        self._seen_set = set()

    def __len__(self):
        return len(self._seen)

    def seen(self, fp: Fingerprint, group: Optional[str] = None) -> bool:
        return (group, fp) in self._seen_set

    def diff_cause(self, fp: Fingerprint, group: Optional[str] = None):
        """(cause, detail) of ``fp`` against the closest seen fingerprint
        of the same ``group``: the one reachable by the smallest class of
        edit (static beats dtype beats shape beats arity)."""
        candidates = [f for g, f in self._seen if g == group]
        if not candidates:
            return "first", ""
        best = None
        rank = {"static": 0, "dtype": 1, "shape": 2, "arity": 3}
        for prev in candidates:
            cause, detail = fingerprint_diff(prev, fp)
            r = rank.get(cause, 4)
            if best is None or r < best[0]:
                best = (r, cause, detail)
        return best[1], best[2]

    def observe(self, fp: Fingerprint, reason: Optional[str] = None,
                group: Optional[str] = None,
                **event_fields) -> Optional[str]:
        if (group, fp) in self._seen_set:
            return None
        cause, detail = self.diff_cause(fp, group)
        self._seen_set.add((group, fp))
        self._seen.append((group, fp))
        label = reason if reason is not None else \
            self.label_map.get(cause, cause)
        from .. import observability as _obs

        _obs.counter(self.counter_name, self.help).inc(reason=label)
        _obs.emit(self.event, reason=label, cause=cause, detail=detail,
                  **{**fp.describe(), **event_fields})
        return label

"""Hazard linter of the port's source: custom AST rules, the port of
``mxnet_tpu/analysis/astlint.py`` with the port's hazards.

Rules:

  JH001 host-sync-in-hot-path   ``.item()``/``.tolist()``/``.cpu()``/
                                ``.numpy()``/``.nonzero()``, ``float()/
                                int()/bool()`` of a traced value,
                                ``np.asarray``/``np.array``,
                                ``torch.cuda.synchronize`` inside a hot
                                path (a step graph's capture fails on one;
                                an eager step waits on the card).
  JH002 traced-branch           Python ``if``/``while`` testing an argument
                                of a hot path (a tensor's truth value is a
                                host sync; use ``torch.where``).
  JH003 nondeterminism          ``time.time``/``datetime.now``/global
                                ``np.random.*``/stdlib ``random.*`` in op
                                modules or hot paths.
  JH004 mutable-default-arg     ``def f(x=[], y={}, z=set())``.
  JH005 unlocked-global-mutation  mutating a module-global dict/list/set
                                outside any ``with <lock>:`` block (a
                                kernel wrapper's ``launches`` counter
                                excepted: see :data:`LAUNCH_COUNTER`).
  JH007 traced-constant-capture  a step-graph closure reading a name bound
                                to a host ``np.ndarray`` (or a large
                                literal): a host-to-device copy at every
                                call, and a pageable copy fails a capture.
  JH008 sync-per-dispatch       a host loop dispatching a step program
                                (a ``StepGraph``, ``_run_program``) and
                                materializing its result in the same loop
                                body: the host waits on the card at every
                                step.

JH006 (mesh-axis names) reads the vocabulary of a mesh, which the port
gains with its multi-GPU slice.

**Hot paths** are found two ways: structurally — a function handed to
``StepGraph`` (its first argument) or to ``_run_program`` (its second),
a lambda's callee included, and everything lexically nested inside it —
and by registration (:data:`EXTRA_HOT_PATHS`: the helpers a step program
calls, e.g. ``TrainStep._step``, and the step-boundary probes).

**Suppressions** are per-rule and inline, JAX's syntax::

    x = float(y)  # lint: disable=JH001  -- TTFT sync point, documented

on the flagged line (or the line above). A comment on a ``def`` line
suppresses the rule for the whole function body. File-level:
``# lint: disable-file=JH005`` anywhere in the file. Suppressing takes a
rule list (``disable=JH001,JH004``) or ``all``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = ["LintRule", "Violation", "lint_source", "lint_file",
           "lint_paths", "list_rules", "RULES", "EXTRA_HOT_PATHS"]


RULES: Dict[str, str] = {
    "JH001": "host-sync-in-hot-path: host transfer/sync call inside a "
             "step program (a failed capture, or a wait on the card per "
             "step)",
    "JH002": "traced-branch: Python if/while on an argument of a step "
             "program (a tensor's truth value is a host sync — use "
             "torch.where)",
    "JH003": "nondeterminism: wall clock or global RNG in op/compiled code "
             "(breaks replay, fingerprints and the compile cache)",
    "JH004": "mutable-default-arg: shared mutable state across calls",
    "JH005": "unlocked-global-mutation: module-global registry mutated "
             "outside a lock (loader/dispatch threads also import/mutate)",
    "JH007": "traced-constant-capture: a step program closes over a host "
             "np.ndarray or large Python literal — a host-to-device copy "
             "at every call (a pageable one fails a capture); keep it in "
             "a device buffer",
    "JH008": "sync-per-dispatch: a host loop dispatches a step program "
             "and materializes its result (.item()/.cpu()/float()/"
             "np.asarray) in the same loop body — the host waits on the "
             "card at every step; keep device results and read them once "
             "after the loop",
}

#: helpers a step program calls but that are not lexically inside the
#: function a StepGraph is handed — registered hot paths, keyed by a path
#: suffix. Extend when adding a program whose body calls such a helper.
EXTRA_HOT_PATHS: Dict[str, Tuple[str, ...]] = {
    # the step body every TrainStep program runs (StepGraph takes a lambda
    # over _steps; the helpers it calls are reached by the call, not by
    # nesting)
    "parallel/train_step.py": (
        "TrainStep._steps", "TrainStep._step", "TrainStep._loss_and_grads",
        "TrainStep._forward_loss", "TrainStep._finite_all",
        "TrainStep._grad_norm", "TrainStep._next_amp_state",
    ),
    # fleet telemetry snapshot writer: maybe_snapshot runs at every step
    # boundary (throttled, but the gate itself is hot)
    "observability/fleet.py": (
        "FleetSnapshotter.maybe_snapshot",
    ),
    # measured profiling's step-boundary probe (armed once per step)
    "observability/profiling.py": (
        "step_capture_begin", "CaptureController.begin_if_due",
        "CaptureController._consume_request",
    ),
    # request-tracing emission probes: span() on every serving dispatch
    # round, finish()/decide() per terminal request — held to the
    # injected clock (no wall clock, no global RNG)
    "observability/tracing.py": (
        "Tracer.span", "Tracer.finish", "TailSampler.decide",
    ),
}

#: callables whose argument at the given position becomes a step program
_PROGRAM_TAKERS: Dict[str, int] = {"StepGraph": 0, "_run_program": 1}


# JH007: numpy constructors that materialize a HOST array — a name bound
# to one of these and read inside a jitted closure is baked into the
# program as a constant
_NP_ARRAY_MAKERS = frozenset({
    "array", "asarray", "zeros", "ones", "arange", "full", "eye",
    "linspace", "empty", "identity", "tri", "ascontiguousarray",
})
# JH007: a literal list/tuple/dict this big folded into a traced program
# is a constant worth flagging too
_LARGE_LITERAL_ELEMS = 32

# JH001: attribute calls that synchronize with or copy to the host
_SYNC_ATTRS = frozenset({"item", "asnumpy", "tolist", "__array__", "cpu",
                         "numpy", "nonzero", "synchronize"})
# JH001: module-level calls that wait on the card
_SYNC_CALLS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
# JH008: constructors whose result is a step program
_DISPATCH_WRAPPERS = frozenset({"StepGraph"})
# JH008: calls that dispatch a step program and return its outputs
_DISPATCH_CALLS = frozenset({"_run_program"})
# JH008: attribute calls that force the dispatched result on host
_JH008_SYNC_ATTRS = _SYNC_ATTRS
# JH001: numpy namespace calls that materialize on host
_NP_HOST_FNS = frozenset({"asarray", "array", "asnumpy", "ascontiguousarray"})
_BUILTIN_SYNCS = frozenset({"float", "int", "bool"})

# JH003: nondeterminism sources
_TIME_FNS = frozenset({"time", "time_ns", "monotonic", "perf_counter",
                       "perf_counter_ns", "monotonic_ns"})
_NP_RANDOM_FNS = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "sample",
    "normal", "uniform", "choice", "shuffle", "permutation", "seed",
    "standard_normal", "beta", "binomial", "poisson", "exponential",
})
#: the module-global a kernel wrapper counts its launches in (the modules
#: of ``ops.cuda_graph._counter_modules``): a diagnostic tally, read as a
#: delta around a capture or a driven path, so JH005 does not apply to it
LAUNCH_COUNTER = "launches"

_MUTATING_METHODS = frozenset({
    "update", "append", "add", "pop", "popitem", "clear", "extend",
    "remove", "discard", "insert", "setdefault", "__setitem__",
})

_DISABLE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\s]+|all)")
_DISABLE_FILE = re.compile(r"#\s*lint:\s*disable-file=([A-Za-z0-9_,\s]+|all)")


@dataclasses.dataclass
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclasses.dataclass(frozen=True)
class LintRule:
    rule_id: str
    summary: str


def list_rules() -> List[LintRule]:
    return [LintRule(k, v) for k, v in sorted(RULES.items())]


# -- suppression parsing -----------------------------------------------------
def _suppressions(source: str):
    """(line -> set of rules disabled on that line, file-wide set).

    Directives are honored only in real COMMENT tokens — a docstring or
    string literal that merely *documents* the syntax (this module's own
    docstring quotes ``disable-file``) must not activate it."""
    per_line: Dict[int, Set[str]] = {}
    file_wide: Set[str] = set()

    def rules_of(spec: str) -> Set[str]:
        spec = spec.strip()
        if spec == "all":
            return set(RULES)
        return {r.strip().upper() for r in spec.split(",") if r.strip()}

    import io
    import tokenize

    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE.search(tok.string)
            if m:
                per_line.setdefault(tok.start[0], set()).update(
                    rules_of(m.group(1)))
            m = _DISABLE_FILE.search(tok.string)
            if m:
                file_wide.update(rules_of(m.group(1)))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # source already parsed via ast before this runs, so tokenize
        # failures are effectively unreachable; fail open (no suppressions)
        pass
    return per_line, file_wide


# -- hot-path discovery ------------------------------------------------------
def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for Attribute/Name chains, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _callee_names(node: ast.AST, assignments: Dict[str, List[ast.AST]],
                  depth: int = 0) -> Set[str]:
    """Resolve an expression to the local function names it may denote:
    handles Name, `a if c else b`, a lambda's callee (`lambda:
    owner()._steps(...)`), and local reassignment (`fn = a if c else b;
    StepGraph(fn, ...)`)."""
    out: Set[str] = set()
    if depth > 4:
        return out
    if isinstance(node, ast.Name):
        out.add(node.id)
        for rhs in assignments.get(node.id, []):
            out |= _callee_names(rhs, assignments, depth + 1)
    elif isinstance(node, ast.IfExp):
        out |= _callee_names(node.body, assignments, depth + 1)
        out |= _callee_names(node.orelse, assignments, depth + 1)
    elif isinstance(node, ast.Attribute):
        # StepGraph(self._step_fn, ...) -> method name in the class
        out.add(node.attr)
    elif isinstance(node, ast.Lambda):
        # StepGraph(lambda: owner()._steps(...)) -> the called function
        if isinstance(node.body, ast.Call):
            out |= _callee_names(node.body.func, assignments, depth + 1)
    elif isinstance(node, ast.Call):
        # functools.partial(fn, ...) wrappers
        if node.args:
            out |= _callee_names(node.args[0], assignments, depth + 1)
    return out


def _program_arg(node: ast.Call) -> Optional[ast.AST]:
    """The step-program function a ``StepGraph(...)`` or
    ``_run_program(...)`` call is handed, or None."""
    pos = _PROGRAM_TAKERS.get(_dotted(node.func).rsplit(".", 1)[-1])
    if pos is None:
        return None
    if len(node.args) > pos:
        return node.args[pos]
    for kw in node.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


class _HotPathFinder(ast.NodeVisitor):
    """Mark FunctionDef nodes that become step programs: referenced
    (possibly through a local alias, a lambda or ``functools.partial``) as
    the function a ``StepGraph`` or ``_run_program`` is handed."""

    def __init__(self, extra_qualnames: Sequence[str]):
        self.extra = set(extra_qualnames)
        self.hot: Set[ast.AST] = set()
        self._scope: List[ast.AST] = []
        self._qualname: List[str] = []
        self._defs: Dict[str, List[ast.AST]] = {}  # name -> def nodes (any scope)
        self._assigns: Dict[str, List[ast.AST]] = {}

    # pass 1: collect defs/assigns + decorator-marked hot roots
    def visit_FunctionDef(self, node):
        qual = ".".join(self._qualname + [node.name])
        self._defs.setdefault(node.name, []).append(node)
        node._lint_qualname = qual
        if qual in self.extra or node.name in self.extra:
            self.hot.add(node)
        self._qualname.append(node.name)
        self.generic_visit(node)
        self._qualname.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self._qualname.append(node.name)
        self.generic_visit(node)
        self._qualname.pop()

    def visit_Assign(self, node):
        for t in node.targets:
            if isinstance(t, ast.Name):
                self._assigns.setdefault(t.id, []).append(node.value)
        self.generic_visit(node)

    def resolve(self, tree: ast.AST) -> Set[ast.AST]:
        """Collect the defs, then mark those a program-taking call is
        handed (a call site may precede the def it names). A function
        handed on from the enclosing function's own parameter (the
        ``StepGraph(fn, ...)`` inside ``_run_program``) is marked where
        that function is called, not resolved by name here."""
        self.visit(tree)
        self._mark(tree, frozenset())
        return self.hot

    def _mark(self, node: ast.AST, params: frozenset):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            params = frozenset(x.arg for x in a.posonlyargs + a.args
                               + a.kwonlyargs)
        elif isinstance(node, ast.Call):
            arg = _program_arg(node)
            if arg is not None and not (isinstance(arg, ast.Name)
                                        and arg.id in params):
                for fname in _callee_names(arg, self._assigns):
                    for d in self._defs.get(fname, []):
                        self.hot.add(d)
        for child in ast.iter_child_nodes(node):
            self._mark(child, params)


# -- the rule engine ---------------------------------------------------------
class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str, is_op_module: bool,
                 hot_defs: Set[ast.AST]):
        self.path = path
        self.lines = source.splitlines()
        self.is_op_module = is_op_module
        self.hot_defs = hot_defs
        self.violations: List[Violation] = []
        self._fn_stack: List[ast.AST] = []   # enclosing FunctionDefs
        self._hot_stack: List[bool] = []
        self._hot_args: List[Set[str]] = []  # traced arg names per hot fn
        self._with_lock_depth = 0
        self._module_globals: Set[str] = set()
        self._suppressed_fn_lines: List[int] = []
        # JH007: names bound to host arrays / large literals, per scope —
        # module level plus one set per enclosing function (closures)
        self._module_host_consts: Set[str] = set()
        self._fn_host_consts: List[Set[str]] = []
        self._jh007_candidates: List[Set[str]] = []
        self._jh007_reported: Set[Tuple[int, str]] = set()
        # JH008: names bound to a step program (StepGraph(...)
        # assignment targets, file-scoped heuristic) and, per enclosing
        # host loop, the names holding a dispatch's device result
        self._compiled_names: Set[str] = set()
        self._loop_results: List[Set[str]] = []

    # -- context helpers ---------------------------------------------------
    @property
    def in_hot(self) -> bool:
        return bool(self._hot_stack and self._hot_stack[-1])

    def _traced_args(self) -> Set[str]:
        return self._hot_args[-1] if self._hot_args else set()

    def report(self, rule: str, node: ast.AST, msg: str):
        self.violations.append(Violation(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", 0), rule, msg))

    # -- module prep --------------------------------------------------------
    def visit_Module(self, node):
        for stmt in node.body:
            targets = []
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets if isinstance(t, ast.Name)]
            elif isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name) and stmt.value:
                targets = [stmt.target]
            if not targets:
                continue
            value = stmt.value
            if isinstance(value, (ast.Dict, ast.List, ast.Set)) or (
                    isinstance(value, ast.Call)
                    and _dotted(value.func) in
                    ("dict", "list", "set", "collections.OrderedDict",
                     "collections.defaultdict", "OrderedDict",
                     "defaultdict")):
                for t in targets:
                    self._module_globals.add(t.id)
            if self._is_host_const_expr(value):
                for t in targets:
                    self._module_host_consts.add(t.id)
            else:
                # a later rebinding to a non-host expression (the common
                # `X = np.arange(n); X = torch.as_tensor(X, device=d)`
                # build-then-transfer pattern) clears the hazard
                for t in targets:
                    self._module_host_consts.discard(t.id)
        self.generic_visit(node)

    # -- JH007 helpers -------------------------------------------------------
    @staticmethod
    def _is_host_const_expr(value: ast.AST) -> bool:
        """An expression that materializes a HOST constant a trace would
        bake in: an ``np.*`` array constructor, or a literal container
        with >= _LARGE_LITERAL_ELEMS scalar elements."""
        if isinstance(value, ast.Call):
            dotted = _dotted(value.func)
            if dotted.startswith(("np.", "numpy.")) and \
                    dotted.rsplit(".", 1)[-1] in _NP_ARRAY_MAKERS:
                return True
            # method chains stay host arrays: np.arange(n).reshape(a, b)
            if isinstance(value.func, ast.Attribute):
                return _Linter._is_host_const_expr(value.func.value)
            return False
        if isinstance(value, (ast.List, ast.Tuple, ast.Dict)):
            n = sum(1 for x in ast.walk(value)
                    if isinstance(x, ast.Constant))
            return n >= _LARGE_LITERAL_ELEMS
        return False

    # -- function scope ------------------------------------------------------
    def visit_FunctionDef(self, node):
        self._check_defaults(node)
        hot = (node in self.hot_defs) or self.in_hot
        self._fn_stack.append(node)
        self._hot_stack.append(hot)
        args = node.args
        names = {a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)} - {"self", "cls"}
        if args.vararg:
            names.add(args.vararg.arg)
        # nested hot fns see enclosing traced names too (closures)
        if hot:
            names |= self._traced_args()
        self._hot_args.append(names if hot else set())
        # JH007: names this hot closure could capture as traced constants
        # — module-level + enclosing-function host arrays, minus anything
        # the function itself binds (args or local stores shadow)
        if hot:
            local_stores = {n.id for n in ast.walk(node)
                            if isinstance(n, ast.Name)
                            and isinstance(n.ctx, ast.Store)}
            cands = set(self._module_host_consts)
            for s in self._fn_host_consts:
                cands |= s
            self._jh007_candidates.append(cands - names - local_stores)
        else:
            self._jh007_candidates.append(set())
        self._fn_host_consts.append(set())
        # a def inside `with lock:` does NOT run under that lock — it runs
        # whenever the callback is invoked, on whatever thread — so JH005
        # must not inherit the enclosing lock depth into the body
        saved_lock_depth = self._with_lock_depth
        self._with_lock_depth = 0
        self.generic_visit(node)
        self._with_lock_depth = saved_lock_depth
        self._fn_host_consts.pop()
        self._jh007_candidates.pop()
        self._hot_args.pop()
        self._hot_stack.pop()
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_defaults(self, node):
        args = node.args
        for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
            bad = isinstance(d, (ast.Dict, ast.List, ast.Set)) or (
                isinstance(d, ast.Call)
                and _dotted(d.func) in ("dict", "list", "set"))
            if bad:
                self.report("JH004", d,
                            f"mutable default argument in {node.name}()")

    # -- JH001 / JH003: calls ------------------------------------------------
    def visit_Call(self, node):
        dotted = _dotted(node.func)
        leaf = dotted.rsplit(".", 1)[-1]
        if self.in_hot:
            if dotted in _SYNC_CALLS:
                self.report("JH001", node,
                            f"{dotted}() waits on the card inside a step "
                            "program")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _SYNC_ATTRS:
                self.report("JH001", node,
                            f".{node.func.attr}() forces a device->host "
                            "sync inside a step program")
            elif dotted.startswith(("np.", "numpy.")) and \
                    leaf in _NP_HOST_FNS:
                self.report("JH001", node,
                            f"{dotted} materializes a host array inside a "
                            "step program (keep it on the device)")
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in _BUILTIN_SYNCS and node.args and \
                    self._mentions_traced(node.args[0]):
                # only when a traced argument feeds the cast: float(topk)
                # on a static op param is legal trace-time specialization
                self.report("JH001", node,
                            f"{node.func.id}() on a tensor argument is a "
                            "host sync inside a step program")
        # JH005 fires on the call wherever it sits — bare statement,
        # assignment RHS (`h = _REG.setdefault(k, [])`), return value —
        # the mutation happens regardless of what the result feeds
        self._visit_mutating_call(node)
        # JH008: a materializer on a dispatch result inside a host loop
        self._check_jh008(node, dotted, leaf)
        if self.in_hot or self.is_op_module:
            if dotted.startswith("time.") and leaf in _TIME_FNS:
                self.report("JH003", node,
                            f"{dotted}() wall clock in op/compiled code")
            elif leaf == "now" and "datetime" in dotted:
                self.report("JH003", node,
                            f"{dotted}() wall clock in op/compiled code")
            elif (dotted.startswith(("np.random.", "numpy.random."))
                  and leaf in _NP_RANDOM_FNS):
                self.report("JH003", node,
                            f"{dotted}() draws from the process-global "
                            "numpy RNG (pass an explicit key/RandomState)")
            elif dotted.startswith("random.") and dotted.count(".") == 1 \
                    and leaf != "RandomState":
                self.report("JH003", node,
                            f"stdlib {dotted}() global RNG in op/compiled "
                            "code")
        self.generic_visit(node)

    def _mentions_traced(self, expr: ast.AST) -> Optional[str]:
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in self._traced_args():
                return n.id
        return None

    # -- JH002: trace-time branches ------------------------------------------
    def _test_on_traced(self, test: ast.AST) -> Optional[str]:
        """Traced name used in a branch test — minus the two *structural*
        comparison idioms that are static under tracing: ``x is (not)
        None`` (a tracer is never None) and ``name (not) in container``
        membership over a pytree container's keys."""
        structural: Set[int] = set()
        for n in ast.walk(test):
            if not isinstance(n, ast.Compare):
                continue
            ops = n.ops
            comparators = n.comparators
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in ops) and all(
                    isinstance(c, ast.Constant) and c.value is None
                    for c in comparators):
                structural.update(id(x) for x in ast.walk(n))
            elif all(isinstance(o, (ast.In, ast.NotIn)) for o in ops):
                for c in comparators:  # the container side only
                    structural.update(id(x) for x in ast.walk(c))
        for n in ast.walk(test):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id in self._traced_args() \
                    and id(n) not in structural:
                return n.id
        return None

    def visit_If(self, node):
        if self.in_hot:
            name = self._test_on_traced(node.test)
            if name:
                self.report("JH002", node,
                            f"Python `if` on step-program argument {name!r} "
                            "(a host sync on a tensor; use torch.where)")
        self.generic_visit(node)

    def visit_While(self, node):
        if self.in_hot:
            name = self._test_on_traced(node.test)
            if name:
                self.report("JH002", node,
                            f"Python `while` on step-program argument "
                            f"{name!r} (a host sync on a tensor)")
        self._loop_results.append(set())
        self.generic_visit(node)
        self._loop_results.pop()

    def visit_For(self, node):
        self._loop_results.append(set())
        self.generic_visit(node)
        self._loop_results.pop()

    visit_AsyncFor = visit_For

    # -- JH008: sync-per-dispatch host loops -------------------------------
    def _is_compiled_callee(self, func_expr: ast.AST) -> bool:
        """Does this call expression dispatch a step program? A name or
        attribute assigned from ``StepGraph(...)`` (tracked file-wide),
        ``_run_program``, or a direct ``StepGraph(f, ...)()`` call."""
        if isinstance(func_expr, ast.Call):
            inner = _dotted(func_expr.func).rsplit(".", 1)[-1]
            return inner in _DISPATCH_WRAPPERS
        leaf = _dotted(func_expr).rsplit(".", 1)[-1]
        if not leaf:
            return False
        return leaf in _DISPATCH_CALLS or leaf in self._compiled_names

    def _expr_is_dispatch(self, expr: ast.AST) -> bool:
        """Is ``expr`` (the materializer's operand) a compiled dispatch's
        result — a tracked result name from an enclosing loop, or the
        dispatch call itself (``float(step(x))``)?"""
        if isinstance(expr, ast.Call) and self._is_compiled_callee(expr.func):
            return True
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and any(n.id in frame for frame in self._loop_results):
                return True
        return False

    def _check_jh008(self, node: ast.Call, dotted: str, leaf: str):
        """Materializer applied to a dispatch result inside a host
        loop: the host waits on the card at every step, and the step's
        host work no longer overlaps the card's."""
        if not self._loop_results or self.in_hot:
            return
        hit = None
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _JH008_SYNC_ATTRS:
            if self._expr_is_dispatch(node.func.value):
                hit = f".{node.func.attr}()"
        elif isinstance(node.func, ast.Name) and \
                node.func.id in _BUILTIN_SYNCS and node.args and \
                self._expr_is_dispatch(node.args[0]):
            hit = f"{node.func.id}()"
        elif dotted.startswith(("np.", "numpy.")) and \
                leaf in _NP_HOST_FNS and node.args and \
                self._expr_is_dispatch(node.args[0]):
            hit = dotted
        if hit:
            self.report(
                "JH008", node,
                f"{hit} materializes a step program's result inside the "
                "host loop — the host waits on the card every "
                "iteration; keep the device result and read it once "
                "after the loop")

    # -- JH005: global registry mutation -------------------------------------
    def visit_With(self, node):
        is_lock = any(
            "lock" in _dotted(item.context_expr.func
                              if isinstance(item.context_expr, ast.Call)
                              else item.context_expr).lower()
            for item in node.items)
        self._with_lock_depth += 1 if is_lock else 0
        self.generic_visit(node)
        self._with_lock_depth -= 1 if is_lock else 0

    def _global_mutation(self, target_expr: ast.AST) -> Optional[str]:
        base = target_expr
        while isinstance(base, (ast.Subscript, ast.Attribute)):
            base = base.value
        if isinstance(base, ast.Name) and base.id in self._module_globals \
                and base.id != LAUNCH_COUNTER:
            return base.id
        return None

    def visit_Assign(self, node):
        # JH008 bookkeeping: `prog = StepGraph(...)` marks a step program;
        # inside a host loop, a call to one marks its result names as
        # device results
        if isinstance(node.value, ast.Call):
            vleaf = _dotted(node.value.func).rsplit(".", 1)[-1]
            if vleaf in _DISPATCH_WRAPPERS:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self._compiled_names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        self._compiled_names.add(t.attr)
            elif self._loop_results and not self.in_hot and \
                    self._is_compiled_callee(node.value.func):
                for t in node.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                        else [t]
                    for e in elts:
                        if isinstance(e, ast.Name):
                            self._loop_results[-1].add(e.id)
        # JH007 bookkeeping: a host-array binding in THIS function is a
        # capture candidate for any closure defined after it; rebinding
        # the name to a non-host expression clears it again
        if self._fn_stack and self._fn_host_consts:
            host = self._is_host_const_expr(node.value)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if host:
                        self._fn_host_consts[-1].add(t.id)
                    else:
                        self._fn_host_consts[-1].discard(t.id)
        if self._fn_stack and not self._with_lock_depth:
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = self._global_mutation(t)
                    if name:
                        self.report("JH005", node,
                                    f"unlocked write to module-global "
                                    f"{name!r} (guard with a threading.Lock"
                                    " or suppress if import-time only)")
        self.generic_visit(node)

    # -- JH007: traced-constant capture --------------------------------------
    def visit_Name(self, node):
        if self.in_hot and isinstance(node.ctx, ast.Load) and \
                self._jh007_candidates and \
                node.id in self._jh007_candidates[-1]:
            key = (id(self._fn_stack[-1]), node.id)
            if key not in self._jh007_reported:
                self._jh007_reported.add(key)
                self.report(
                    "JH007", node,
                    f"host array {node.id!r} is closed over by a step "
                    "program: a host-to-device copy at every call (a "
                    "pageable one fails a capture) — keep it in a device "
                    "buffer")
        self.generic_visit(node)

    def visit_Delete(self, node):
        if self._fn_stack and not self._with_lock_depth:
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    name = self._global_mutation(t)
                    if name:
                        self.report("JH005", node,
                                    f"unlocked del on module-global {name!r}")
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if self._fn_stack and not self._with_lock_depth and \
                isinstance(node.target, ast.Subscript):
            name = self._global_mutation(node.target)
            if name:
                self.report("JH005", node,
                            f"unlocked augmented write to module-global "
                            f"{name!r} (read-modify-write race)")
        self.generic_visit(node)

    def _visit_mutating_call(self, node):
        if not (self._fn_stack and not self._with_lock_depth):
            return
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATING_METHODS:
            name = self._global_mutation(node.func.value)
            if name:
                self.report("JH005", node,
                            f"unlocked .{node.func.attr}() on module-global "
                            f"{name!r}")


def _function_spans(tree: ast.AST) -> List[Tuple[int, int, int]]:
    """(def-line, body-start, body-end) for suppression-on-def semantics."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            end = getattr(node, "end_lineno", node.lineno)
            spans.append((node.lineno, node.lineno, end))
    return spans


def lint_source(source: str, path: str = "<string>") -> List[Violation]:
    """Lint one file's source; returns unsuppressed violations sorted by
    line. ``path`` decides op-module scope (JH003) and registered hot
    paths (JH001/2)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, 0, "JH000",
                          f"syntax error: {e.msg}")]
    posix = path.replace(os.sep, "/")
    extra: List[str] = []
    for suffix, quals in EXTRA_HOT_PATHS.items():
        if posix.endswith(suffix):
            extra.extend(quals)
    hot = _HotPathFinder(extra).resolve(tree)
    is_op_module = "/ops/" in posix or posix.endswith("random.py")
    linter = _Linter(path, source, is_op_module, hot)
    linter.visit(tree)

    per_line, file_wide = _suppressions(source)
    spans = _function_spans(tree)

    def suppressed(v: Violation) -> bool:
        if v.rule in file_wide:
            return True
        for line in (v.line, v.line - 1):
            if v.rule in per_line.get(line, set()):
                return True
        # a suppression on the `def` line covers the whole function body
        for def_line, lo, hi in spans:
            if lo <= v.line <= hi and v.rule in per_line.get(def_line, set()):
                return True
        return False

    return sorted((v for v in linter.violations if not suppressed(v)),
                  key=lambda v: (v.line, v.col, v.rule))


def lint_file(path: str) -> List[Violation]:
    with open(path, encoding="utf-8") as f:
        return lint_source(f.read(), path)


def lint_paths(paths: Iterable[str],
               exclude: Sequence[str] = ()) -> List[Violation]:
    """Lint every ``.py`` under each path (file or directory tree)."""
    out: List[Violation] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                out.extend(lint_file(path))
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs
                       if d != "__pycache__" and not d.startswith(".")]
            for name in sorted(files):
                if not name.endswith(".py"):
                    continue
                full = os.path.join(root, name)
                if any(x in full.replace(os.sep, "/") for x in exclude):
                    continue
                out.extend(lint_file(full))
    return out

"""``mx.nd`` of the port (mxnet_tpu_torch.ndarray over the registry of
ops/core.py, ops/nn.py, ops/attention.py and the rest) against the JAX package's on
the same seeded numpy inputs: every operator that mxnet_tpu/ops/core.py
registers (one case each, by its primary name), reshape's special codes
with and without ``reverse``, getitem/setitem and broadcasting operators,
and ``nd.save`` in one package read by ``nd.load`` in the other."""
import pathlib
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import registry as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import registry as treg

F32 = dict(rtol=1e-5, atol=1e-6)
CORE = pathlib.Path(__file__).resolve().parent.parent / "mxnet_tpu" / "ops" \
    / "core.py"


def _core_names():
    """The primary names mxnet_tpu/ops/core.py registers."""
    src = CORE.read_text()
    names = set(re.findall(r'register\("([^"]+)"', src))
    names |= set(re.findall(r'_binary\("([^"]+)"', src))
    names |= set(re.findall(r'\("(\w+)", (?:jnp|lax|jax|lambda)', src))
    return sorted(names)


def _rs(seed):
    return np.random.RandomState(seed)


def _f(shape, seed=0, lo=-2.0, hi=2.0):
    return _rs(seed).uniform(lo, hi, shape).astype(np.float32)


X = _f((3, 4), 1)
Y = _f((4,), 2)
POS = _f((3, 4), 3, 0.5, 3.0)
UNIT = _f((3, 4), 4, -0.9, 0.9)
X3 = _f((2, 3, 4), 5)
IDS = np.array([[0, 2], [1, 3]], np.int64)
MASK = np.array([1, 0, 1], np.float32)

BINARY = {"add", "subtract", "multiply", "divide", "maximum", "minimum",
          "hypot", "equal", "not_equal", "greater", "greater_equal",
          "lesser", "lesser_equal"}
LOGICAL = {"logical_and", "logical_or", "logical_xor"}
SCALAR = re.compile(r"^_r?\w+_scalar$")
POSITIVE = {"sqrt", "rsqrt", "log", "log10", "log2", "log1p", "gamma",
            "gammaln", "digamma", "reciprocal", "rcbrt", "cbrt"}
IN_UNIT = {"arcsin", "arccos", "arctanh", "erfinv"}

# name -> (inputs, params) for the ops that do not take (3, 4) floats
CASES = {
    "mod": ([X, _f((4,), 6, 0.5, 2.0)], {}),
    "power": ([POS, Y], {}),
    "arccosh": ([POS + 1.0], {}),
    "logical_not": ([np.array([0.0, 1.5, -2.0, 0.0], np.float32)], {}),
    "clip": ([X], {"a_min": -0.5, "a_max": 0.7}),
    "sum": ([X3], {"axis": 1, "keepdims": True}),
    "mean": ([X3], {"axis": (0, 2)}),
    "prod": ([X3], {"axis": 2}),
    "max": ([X3], {"axis": 1}),
    "min": ([X3], {}),
    "nansum": ([np.where(X3 > 1, np.nan, X3).astype(np.float32)],
               {"axis": 1}),
    "nanprod": ([np.where(X3 > 1, np.nan, X3).astype(np.float32)],
                {"axis": 2, "keepdims": True}),
    "norm": ([X3], {"axis": 2}),
    "argmax": ([X3], {"axis": 1}),
    "argmin": ([X3], {"axis": 2, "keepdims": True}),
    "topk": ([X], {"k": 2, "ret_typ": "both"}),
    "sort": ([X], {"axis": 0, "is_ascend": False}),
    "argsort": ([X], {"axis": 1}),
    "dot": ([X, _f((4, 5), 7)], {}),
    "batch_dot": ([X3, _f((2, 5, 4), 8)], {"transpose_b": True}),
    "reshape": ([X3], {"shape": (0, -1)}),
    "reshape_like": ([X, _f((6, 2), 9)], {}),
    "flatten": ([X3], {}),
    "transpose": ([X3], {"axes": (2, 0, 1)}),
    "swapaxes": ([X3], {"dim1": 0, "dim2": 2}),
    "expand_dims": ([X], {"axis": 1}),
    "squeeze": ([_f((3, 1, 4), 10)], {"axis": 1}),
    "broadcast_to": ([_f((1, 4), 11)], {"shape": (3, 0)}),
    "broadcast_like": ([_f((1, 4), 11), X], {}),
    "repeat": ([X], {"repeats": 2, "axis": 1}),
    "tile": ([X], {"reps": (2, 1)}),
    "reverse": ([X3], {"axis": (0, 2)}),
    "depth_to_space": ([_f((1, 8, 2, 3), 12)], {"block_size": 2}),
    "space_to_depth": ([_f((1, 2, 4, 6), 13)], {"block_size": 2}),
    "concat": ([X, POS], {"dim": 0}),
    "stack": ([X, POS], {"axis": 1}),
    "split": ([_f((3, 6), 14)], {"num_outputs": 3, "axis": 1,
                                 "squeeze_axis": False}),
    "slice": ([X3], {"begin": (0, 2, None), "end": (2, None, 1),
                     "step": (1, -1, None)}),
    "arange_like": ([X3], {"axis": 2, "start": 1.5, "step": 0.5}),
    "slice_axis": ([X3], {"axis": 2, "begin": 1, "end": -1}),
    "slice_like": ([X3, _f((1, 2), 15)], {"axes": (0, 1)}),
    "pad": ([_f((1, 2, 3, 4), 16)], {"mode": "reflect",
                                     "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
    "take": ([X, np.array([2, 0, 5, -1], np.int64)], {"axis": 0}),
    "Embedding": ([IDS, _f((4, 3), 17)], {}),
    "one_hot": ([np.array([0, 2, 4, -1], np.int64)], {"depth": 4}),
    "pick": ([X, np.array([0, 3, 9], np.int64)], {"axis": 1}),
    "gather_nd": ([X, np.array([[0, 2], [1, 3]], np.int64)], {}),
    "scatter_nd": ([np.array([1.5, -2.0], np.float32),
                    np.array([[0, 2], [1, 3]], np.int64)],
                   {"shape": (3, 4)}),
    "where": ([(X > 0).astype(np.float32), X, POS], {}),
    "boolean_mask": ([X, MASK], {"axis": 0}),
    "SequenceMask": ([X3, np.array([1, 2, 3], np.float32)],
                     {"use_sequence_length": True, "value": -1.0}),
    "cast": ([X], {"dtype": "int32"}),
    "_full": ([], {"shape": (2, 3), "value": 1.25}),
    "_arange": ([], {"start": 1, "stop": 7, "step": 1.5, "repeat": 2}),
    "_eye": ([], {"N": 3, "M": 4, "k": 1}),
    "diag": ([X], {"k": 1}),
    "tril": ([X], {"k": -1}),
    "cumsum": ([X3], {"axis": 1}),
    "isnan": ([np.array([0.0, np.nan, np.inf], np.float32)], {}),
    "isinf": ([np.array([0.0, np.nan, -np.inf], np.float32)], {}),
    "isfinite": ([np.array([0.0, np.nan, np.inf], np.float32)], {}),
    "broadcast_axis": ([_f((3, 1, 4), 18)], {"axis": 1, "size": 5}),
    "make_loss": ([X], {"grad_scale": 2.0}),
    "SVMOutput": ([X], {}),
}


def _inputs(name):
    if name in CASES:
        return CASES[name]
    if name in BINARY:
        return [X, Y], {}
    if name in LOGICAL:
        return [np.where(X > 0, X, 0).astype(np.float32),
                np.where(Y < 0, Y, 0).astype(np.float32)], {}
    if SCALAR.match(name):
        base = POS if "power" in name or "div" in name else X
        return [base], {"scalar": 1.5}
    if name in POSITIVE:
        return [POS], {}
    if name in IN_UNIT:
        return [UNIT], {}
    return [X], {}


def _host(out):
    if isinstance(out, (tuple, list)):
        return [_host(o) for o in out]
    return np.asarray(out.asnumpy())


def _compare(got, want, what):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for g, w in zip(got, want):
            _compare(g, w, what)
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, err_msg=what, **F32)


def test_the_registries_hold_the_same_core_names():
    names = _core_names()
    assert len(names) > 100
    missing = [n for n in names if n not in treg._REGISTRY]
    assert not missing
    for n in names:
        j = jreg.get(n)
        assert set(treg.get(n).aliases) == set(j.aliases), n


@pytest.mark.parametrize("name", _core_names())
def test_registered_op_matches_jax(name):
    inputs, params = _inputs(name)
    jout = getattr(jnd, name)(*[jnd.array(a) for a in inputs], **params)
    with tmx.cpu():
        tout = getattr(tnd, name)(*[tnd.array(a) for a in inputs], **params)
    _compare(_host(tout), _host(jout), name)


RESHAPES = [((0, -1), False), ((-1, 0), True), ((-2,), False),
            ((2, -2), False), ((-3, 5), False), ((0, -3), False),
            ((2, -1, 0), True), ((-1, 5), True), ((4, 0, 0, -1), False),
            ((-3, 0), True)]


@pytest.mark.parametrize("shape,reverse", RESHAPES,
                         ids=[f"{s}-{r}" for s, r in RESHAPES])
def test_reshape_codes_match_jax(shape, reverse):
    a = _f((2, 3, 5), 20)
    if shape == (4, 0, 0, -1):
        a = _f((4, 3, 5, 2), 21)
    want = jnd.reshape(jnd.array(a), shape=shape, reverse=reverse).asnumpy()
    with tmx.cpu():
        got = tnd.reshape(tnd.array(a), shape=shape, reverse=reverse)
    np.testing.assert_array_equal(got.asnumpy(), want)
    # the method form resolves the same way
    with tmx.cpu():
        assert tnd.array(a).reshape(shape, reverse=reverse).shape == want.shape


def test_reshape_code_minus_4_is_refused_by_both():
    """Neither package resolves MXNet 1.x's -4 (split one dim in two)."""
    a = _f((6, 5), 22)
    with pytest.raises((TypeError, ValueError)):
        jnd.reshape(jnd.array(a), shape=(-4, 2, 3)).asnumpy()
    with tmx.cpu(), pytest.raises(ValueError, match="unresolved"):
        tnd.reshape(tnd.array(a), shape=(-4, 2, 3))


def _both(fn, *arrays):
    """``fn(nd, *arrays)`` in each package, as numpy."""
    want = fn(jnd, *[jnd.array(a) for a in arrays])
    with tmx.cpu():
        got = fn(tnd, *[tnd.array(a) for a in arrays])
    return _host(got), _host(want)


OPERATOR_CASES = {
    "add_broadcast": lambda m, a, b: a + b,
    "radd_scalar": lambda m, a, b: 2.5 + a,
    "rsub_scalar": lambda m, a, b: 1.0 - a,
    "rdiv_scalar": lambda m, a, b: 3.0 / (a * a + 1.0),
    "mul_div": lambda m, a, b: (a * b) / (b * b + 2.0),
    "pow": lambda m, a, b: abs(a) ** 1.5,
    "neg_abs": lambda m, a, b: -abs(a),
    "matmul": lambda m, a, b: a @ m.array(np.ones((4, 2), np.float32)),
    "compare": lambda m, a, b: (a > b) + (a <= 0.5) + (a == a),
    "getitem_slice": lambda m, a, b: a[1:, ::2],
    "getitem_int": lambda m, a, b: a[2],
    "getitem_tuple": lambda m, a, b: a[1, 1:3],
    "getitem_ndarray": lambda m, a, b: a[m.array(np.array([2, 0]))],
    "methods": lambda m, a, b: a.T.reshape((2, -1)).sum(axis=1, keepdims=True),
    "astype": lambda m, a, b: a.astype("int32"),
    "broadcast_to_method": lambda m, a, b: b.reshape((1, 4)).broadcast_to(
        (3, 4)),
}


@pytest.mark.parametrize("case", sorted(OPERATOR_CASES))
def test_operators_and_indexing_match_jax(case):
    got, want = _both(OPERATOR_CASES[case], X, Y)
    _compare(got, want, case)


SETITEM_CASES = {
    "full": (slice(None), 1.5),
    "row": (1, np.array([9.0, 8.0, 7.0, 6.0], np.float32)),
    "block": ((slice(0, 2), slice(1, 3)), -3.0),
    "column_broadcast": ((slice(None), 2), 0.25),
}


@pytest.mark.parametrize("case", sorted(SETITEM_CASES))
def test_setitem_matches_jax(case):
    key, value = SETITEM_CASES[case]
    ja = jnd.array(X)
    ja[key] = value
    with tmx.cpu():
        ta = tnd.array(X)
        ta[key] = value
    _compare(ta.asnumpy(), ja.asnumpy(), case)


def test_setitem_writes_in_place():
    """The port writes into the tensor (MXNet's in-place write); a handle
    sharing it sees the value."""
    with tmx.cpu():
        t = torch.zeros(2, 3)
        a = tnd.array(t)
        a[:] = 2.0
        a[0, 1] = 5.0
        assert t[0, 1].item() == 5.0 and t[1, 2].item() == 2.0
        b = tnd.zeros((2, 3))
        a.copyto(b)
        np.testing.assert_array_equal(b.asnumpy(), t.numpy())


def test_creation_and_properties_match_jax():
    for mod, ctx in ((jnd, None), (tnd, tmx.cpu())):
        kw = {} if ctx is None else {"ctx": ctx}
        outs = [mod.zeros((2, 3), **kw), mod.ones(4, **kw),
                mod.full((2, 2), 7.0, **kw), mod.arange(0, 5, 2, **kw),
                mod.array([[1, 2], [3, 4]], **kw),
                mod.array(np.ones(3, np.float64), **kw)]
        if mod is jnd:
            want = outs
        else:
            got = outs
    for g, w in zip(got, want):
        _compare(g.asnumpy(), w.asnumpy(), "creation")
        assert g.shape == w.shape and g.size == w.size and g.ndim == w.ndim
        assert g.dtype == w.dtype
    with tmx.cpu():
        a = tnd.array([[1.5, 2.5]])
    assert a.context == tmx.cpu() and a.asscalar is not None
    assert tnd.array([3.0], ctx=tmx.cpu()).asscalar() == 3.0


def test_ndarray_wraps_its_tensor_without_a_copy():
    t = torch.arange(6.0).reshape(2, 3)
    a = tnd.array(t)
    assert a._data is t
    assert a.detach()._data.data_ptr() == t.data_ptr()
    assert a.as_in_context(tmx.cpu()) is a


def test_save_and_load_cross_the_packages(tmp_path):
    """A dict and a list of arrays (f32, int32, bf16) saved by one package
    load in the other with the same values."""
    arrays = {"w": _f((3, 4), 30), "ids": np.arange(5, dtype=np.int32)}
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnd.save(jpath, {k: jnd.array(v) for k, v in arrays.items()})
    with tmx.cpu():
        tnd.save(tpath, {k: tnd.array(v) for k, v in arrays.items()})
        tnd.save(str(tmp_path / "bf.params"),
                 {"b": tnd.array(_f((2, 3), 31), dtype="bfloat16")})
    for path in (jpath, tpath):
        jl, tl = jnd.load(path), tnd.load(path)
        assert set(jl) == set(tl) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(tl[k].asnumpy(), v)
            np.testing.assert_array_equal(jl[k].asnumpy(), v)
            assert tl[k].dtype == jl[k].dtype
            assert tl[k].context == tmx.cpu()
    jb = jnd.load(str(tmp_path / "bf.params"))["b"]
    tb = tnd.load(str(tmp_path / "bf.params"))["b"]
    assert tb._data.dtype == torch.bfloat16 and str(jb.dtype) == "bfloat16"
    np.testing.assert_array_equal(tb.asnumpy(), np.asarray(jb.asnumpy(),
                                                           np.float32))
    jnd.save(jpath, [jnd.array(arrays["w"])])
    (only,) = tnd.load(jpath)
    np.testing.assert_array_equal(only.asnumpy(), arrays["w"])


def test_creation_defaults_to_the_card(monkeypatch):
    """The default context is gpu(0): creating an array without a card
    raises unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(tmx.MXNetError, match="CUDA is not available"):
        tnd.zeros((2, 2))
    assert tnd.zeros((2, 2), ctx=tmx.cpu()).context == tmx.cpu()
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tnd.array([1.0]).context == tmx.cpu()


def test_array_copies_host_data():
    """``nd.array`` of a numpy array holds a copy, as MXNet's: an in-place
    write into the NDArray leaves the caller's array as it was."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    with tmx.cpu():
        x = tnd.array(a)
        x[:] = 7.0
    assert a[0, 0] == 0.0 and x.asnumpy()[0, 0] == 7.0


# the JAX modules of the NN ops, optimizers, the operator long tail and
# linalg whose registered names the port carries (and the extra parameter the port's samplers that take no
# tensor accept, as the creation ops' ctx=)
PORTED_MODULES = ("mxnet_tpu.ops.nn", "mxnet_tpu.ops.attention",
                  "mxnet_tpu.ops.random_ops", "mxnet_tpu.ops.optimizer_ops",
                  "mxnet_tpu.ops.pallas_softmax_xent", "mxnet_tpu.ops.extra",
                  "mxnet_tpu.ops.linalg")


def _ported_names():
    """The primary names the JAX modules above register."""
    return sorted({op.name for op in jreg._REGISTRY.values()
                   if op.fn.__module__ in PORTED_MODULES})


@pytest.mark.parametrize("name", _ported_names())
def test_ported_op_has_the_jax_names_parameters_and_nout(name):
    import inspect

    j, t = jreg.get(name), treg.get(name)
    assert set(t.aliases) == set(j.aliases)
    for alias in (name, *j.aliases):
        assert treg.get(alias) is t
    assert t.nout == j.nout and t.stochastic == j.stochastic
    jsig = inspect.signature(j.fn).parameters
    tsig = dict(inspect.signature(t.fn).parameters)
    if "ctx" in tsig and "ctx" not in jsig:
        assert t.stochastic and tsig.pop("ctx").default is None
    # the same names (multi_head_attention, of an earlier slice, orders its
    # keyword parameters differently), the required ones in the same order
    assert sorted(tsig) == sorted(jsig)
    required = [p for p, v in jsig.items()
                if v.default is inspect.Parameter.empty]
    assert [p for p in tsig if p in required] == required
    for p in jsig:
        assert tsig[p].default == jsig[p].default, (name, p)
        assert tsig[p].kind == jsig[p].kind, (name, p)


def test_boolean_mask_contrib_alias():
    assert jreg.get("_contrib_boolean_mask") is jreg.get("boolean_mask")
    assert treg.get("_contrib_boolean_mask") is treg.get("boolean_mask")

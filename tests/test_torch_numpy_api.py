"""The port's ``mx.np`` / ``mx.npx`` (``mxnet_tpu_torch/numpy_api.py``)
against the JAX package's (``mxnet_tpu/numpy_api.py``) on the same numpy
inputs: one case a name of the JAX package's list and of the names it
assigns after it (numpy's semantics where PyTorch's differ: ``var``/``std``
at ddof 0, ``median`` of an even count, ``meshgrid``'s "xy",
``split``/``array_split`` by sections and by indices, ``pad`` per axis,
``mod`` of a negative divisor, ``cross``, ``digitize`` both ways,
``tril_indices``/``triu_indices``, ``empty_like``, ``histogram``, and the
names torch lacks: ``cbrt``, ``ptp``, ``average``, ``interp``,
``ediff1d``), then ``np.linalg``, ``npx``, and ``np.random`` by its
moments.

Tolerances: float results rtol 1e-5, atol 1e-6 (f32, another order of
operations in the reductions and the transcendental functions); integer
and boolean results exact. Float dtypes equal the JAX package's; integer
results that PyTorch gives as int64 where JAX gives int32 are the port's
recorded divergence (``test_integer_results_are_int64``)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

F32 = dict(rtol=1e-5, atol=1e-6)


class A:
    """An array argument: the same numpy values as an NDArray of each
    package."""

    def __init__(self, value):
        self.value = value


_rs = np.random.RandomState(0)
X = _rs.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
Y = _rs.uniform(-0.9, 0.9, (3, 4)).astype(np.float32)
P = _rs.uniform(0.1, 2.0, (3, 4)).astype(np.float32)
G = _rs.uniform(1.1, 3.0, (3, 4)).astype(np.float32)
I = _rs.randint(1, 20, (3, 4)).astype(np.int32)  # noqa: E741
J = _rs.randint(1, 20, (3, 4)).astype(np.int32)
M = _rs.uniform(-1, 1, (4, 4)).astype(np.float32)
V = _rs.uniform(-1, 1, (4,)).astype(np.float32)
W3 = _rs.uniform(-1, 1, (3,)).astype(np.float32)
C = _rs.uniform(-1, 1, (2, 3)).astype(np.float32)
D = _rs.uniform(-1, 1, (2, 3)).astype(np.float32)
X3 = _rs.uniform(-1, 1, (2, 3, 4)).astype(np.float32)
XNAN = X.copy()
XNAN[0, 1] = np.nan
XNAN[2, 3] = np.inf
XZ = X.copy()
XZ[X < 0] = 0
S = np.sort(_rs.uniform(-1, 1, (6,))).astype(np.float32)
XP = np.array([0.0, 1.0, 2.5, 4.0], np.float32)
FP = np.array([1.0, -1.0, 3.0, 0.5], np.float32)
XQ = np.array([-1.0, 0.0, 0.5, 2.5, 3.0, 5.0], np.float32)
BINS = np.array([-0.5, 0.0, 0.5], np.float32)
WEIGHTS = np.array([1.0, 2.0, 3.0, 4.0], np.float32)

# name -> list of (args, kwargs); A(...) marks an array argument
CASES = {
    # elementwise, one argument
    **{n: [((A(X),), {})] for n in (
        "exp", "tanh", "sin", "cos", "abs", "sign", "floor", "ceil",
        "square", "trunc", "isnan", "isinf", "isfinite", "logical_not",
        "sinh", "cosh", "arcsin", "arccos", "arctan", "arctanh", "arcsinh",
        "expm1", "log1p", "negative", "positive", "cbrt", "exp2",
        "absolute", "tan")},
    **{n: [((A(P),), {})] for n in ("log", "sqrt", "log2", "log10",
                                    "reciprocal")},
    "arccosh": [((A(G),), {})],
    "round": [((A(X * 10),), {}), ((A(X),), {"decimals": 2})],
    "nan_to_num": [((A(XNAN),), {}), ((A(XNAN),), {"posinf": 9.0})],
    # elementwise, two arguments
    **{n: [((A(X), A(Y)), {})] for n in (
        "add", "subtract", "multiply", "divide", "maximum", "minimum",
        "arctan2", "hypot", "logical_and", "logical_or", "logical_xor",
        "greater", "greater_equal", "less", "less_equal")},
    "power": [((A(P), A(Y)), {}), ((A(P), 2.0), {})],
    "floor_divide": [((A(X * 5), A(P)), {})],
    "mod": [((A(X * 5), A(P)), {}), ((A(X * 5), A(-P)), {})],
    "equal": [((A(I), A(J)), {})],
    "not_equal": [((A(I), A(J)), {})],
    "gcd": [((A(I), A(J)), {})],
    "lcm": [((A(I), A(J)), {})],
    "where": [((A(X > 0), A(X), A(Y)), {})],
    "clip": [((A(X), -0.5, 0.5), {})],
    # reductions
    "sum": [((A(X),), {"axis": 1}), ((A(X),), {})],
    "mean": [((A(X),), {"axis": 0, "keepdims": True}), ((A(X),), {})],
    "max": [((A(X),), {}), ((A(X),), {"axis": 1})],
    "min": [((A(X),), {"axis": (0, 1)})],
    "argmax": [((A(X),), {"axis": 1}), ((A(X),), {})],
    "argmin": [((A(X),), {})],
    "prod": [((A(P),), {"axis": 0}), ((A(P),), {})],
    "var": [((A(X),), {"axis": 1}), ((A(X),), {})],
    "std": [((A(X),), {}), ((A(X),), {"axis": 0, "ddof": 1})],
    "cumsum": [((A(X),), {"axis": 1}), ((A(X),), {})],
    "cumprod": [((A(P),), {"axis": 0})],
    "count_nonzero": [((A(XZ),), {}), ((A(XZ),), {"axis": 1})],
    "nanmean": [((A(np.where(np.isinf(XNAN), 1.0, XNAN)),), {"axis": 1})],
    "nansum": [((A(np.where(np.isinf(XNAN), 1.0, XNAN)),), {})],
    "median": [((A(X),), {}), ((A(X),), {"axis": 1}), ((A(X),),
                                                      {"axis": 0})],
    "percentile": [((A(X), 30), {"axis": 0}),
                   ((A(X), A(np.float32([10, 90]))), {})],
    "quantile": [((A(X), A(np.float32([0.25, 0.75]))), {}),
                 ((A(X), 0.5), {"axis": 1})],
    "ptp": [((A(X),), {}), ((A(X),), {"axis": 1})],
    "average": [((A(X),), {"axis": 1, "weights": A(WEIGHTS)}),
                ((A(X),), {})],
    "allclose": [((A(X), A(X + 1e-7)), {}), ((A(X), A(Y)), {})],
    "array_equal": [((A(I), A(I)), {}), ((A(I), A(J)), {})],
    "all": [((A(X > -1),), {})],
    "any": [((A(X > 0.8),), {"axis": 0})],
    # shapes
    "reshape": [((A(X), (4, 3)), {})],
    "transpose": [((A(X),), {}), ((A(X3), (1, 0, 2)), {})],
    "concatenate": [(([A(X), A(Y)],), {"axis": 0}),
                    (([A(X), A(Y)],), {"axis": 1})],
    "stack": [(([A(X), A(Y)],), {"axis": 1})],
    "split": [((A(X), 2), {"axis": 1}), ((A(X), [1, 3]), {"axis": 1})],
    "array_split": [((A(X), 3), {"axis": 1}), ((A(V), 3), {})],
    "expand_dims": [((A(X), 1), {})],
    "squeeze": [((A(X[None]),), {}), ((A(X[:, :1]),), {"axis": 1})],
    "broadcast_to": [((A(V), (3, 4)), {})],
    "tile": [((A(V), 2), {}), ((A(X), (2, 1)), {})],
    "repeat": [((A(X), 2), {"axis": 0}), ((A(V), 3), {})],
    "flip": [((A(X),), {"axis": 1}), ((A(X),), {})],
    "ravel": [((A(X),), {})],
    "moveaxis": [((A(X3), 0, 2), {})],
    "swapaxes": [((A(X), 0, 1), {})],
    "roll": [((A(X), 2), {}), ((A(X), 1), {"axis": 1})],
    "pad": [((A(X), ((1, 0), (2, 1))), {}), ((A(X), 1), {"mode": "edge"}),
            ((A(X), 2), {"constant_values": 3.0})],
    "atleast_1d": [((A(np.float32(2.0)),), {})],
    "atleast_2d": [((A(V),), {})],
    "vstack": [(([A(X), A(Y)],), {})],
    "hstack": [(([A(X), A(Y)],), {})],
    "dstack": [(([A(X), A(Y)],), {})],
    "column_stack": [(([A(V), A(V * 2)],), {})],
    "rot90": [((A(X),), {}), ((A(X), 3), {})],
    # products
    "dot": [((A(X), A(M)), {}), ((A(V), A(V)), {}), ((A(X3), A(M)), {})],
    "matmul": [((A(X), A(M)), {})],
    "einsum": [(("ij,jk->ik", A(X), A(M)), {})],
    "tensordot": [((A(X), A(M)), {"axes": 1})],
    "inner": [((A(X), A(Y)), {})],
    "outer": [((A(V), A(W3)), {})],
    "vdot": [((A(X), A(Y)), {})],
    "kron": [((A(X[:2, :2]), A(M[:2, :3])), {})],
    "cross": [((A(C), A(D)), {})],
    "trace": [((A(M),), {}), ((A(M),), {"offset": 1})],
    "diag": [((A(V),), {}), ((A(M),), {"k": -1})],
    "tril": [((A(M), -1), {})],
    "triu": [((A(M), 1), {})],
    "diff": [((A(X),), {"axis": 1}), ((A(X),), {"n": 2, "axis": 0})],
    "ediff1d": [((A(X),), {})],
    # sorting and indexing
    "sort": [((A(X),), {"axis": 1}), ((A(X),), {"axis": 0})],
    "argsort": [((A(X),), {})],
    "unique": [((A(I),), {})],
    "take": [((A(X), A(np.array([0, 2], np.int32))), {"axis": 1}),
             ((A(X), A(np.array([1, 5], np.int32))), {})],
    "searchsorted": [((A(S), A(V)), {}), ((A(S), A(V)), {"side": "right"})],
    "digitize": [((A(X), A(BINS)), {}), ((A(X), A(BINS)), {"right": True}),
                 ((A(np.array([0.0, 0.5, -0.5], np.float32)), A(BINS)),
                  {"right": True})],
    "interp": [((A(XQ), A(XP), A(FP)), {})],
    "histogram": [((A(X),), {"bins": 4}), ((A(X),), {"bins": 3,
                                                    "range": (-1, 1)})],
    "bincount": [((A(I.ravel()),), {}), ((A(I.ravel()),), {"minlength": 25})],
    "triu_indices": [((4, 1), {}), ((3,), {"m": 5})],
    "tril_indices": [((3,), {}), ((4, -1), {})],
    "nonzero": [((A(I > 10),), {})],
    "meshgrid": [((A(W3), A(V)), {}), ((A(W3), A(V)), {"indexing": "ij"})],
    # creation
    "arange": [((5,), {}), ((1.0, 3.0, 0.5), {})],
    "linspace": [((0, 1, 5), {}), ((0, 1, 4), {"endpoint": False})],
    "eye": [((3,), {}), ((3, 4), {"k": 1})],
    "zeros_like": [((A(X),), {})],
    "ones_like": [((A(I),), {})],
    "full_like": [((A(X), 7.0), {})],
    "empty_like": [((A(X),), {})],
    "identity": [((3,), {})],
    "zeros": [(((2, 3),), {})],
    "ones": [(((2, 3),), {"dtype": "int32"})],
    "full": [(((2, 2), 3.0), {})],
    "empty": [(((2, 3),), {})],
    "array": [(([[1.0, 2.0], [3.0, 4.0]],), {}), (([1, 2],), {})],
}


def _call(mx, name, args, kwargs):
    def conv(a):
        if isinstance(a, A):
            return mx.nd.array(a.value)
        if isinstance(a, list) and a and isinstance(a[0], A):
            return [conv(x) for x in a]
        return a
    fn = getattr(mx.np, name)
    out = fn(*[conv(a) for a in args],
             **{k: conv(v) for k, v in kwargs.items()})
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [o.asnumpy() if hasattr(o, "asnumpy") else np.asarray(o)
            for o in outs]


def _compare(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
            np.testing.assert_allclose(g, w, err_msg=what, **F32)
        else:
            assert g.dtype.kind == w.dtype.kind, f"{what}: {g.dtype}"
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_name_matches_jax(name):
    for k, (args, kwargs) in enumerate(CASES[name]):
        want = _call(jmx, name, args, kwargs)
        with tmx.cpu():
            got = _call(tmx, name, args, kwargs)
        _compare(got, want, f"np.{name} case {k}")


def test_every_jax_name_is_there():
    """Every public name of the JAX package's ``np``, ``np.linalg``,
    ``np.random`` and ``npx`` exists in the port's, and each name of
    ``np`` a case above covers (or is a constant, a dtype or a module)."""
    for jm, tm in ((jmx.np, tmx.np), (jmx.np.linalg, tmx.np.linalg),
                   (jmx.np.random, tmx.np.random), (jmx.npx, tmx.npx)):
        names = {n for n in dir(jm) if not n.startswith("_")}
        missing = sorted(n for n in names if not hasattr(tm, n))
        assert not missing, f"{jm.__name__}: {missing}"
    elsewhere = {"linalg", "random", "ndarray", "float32", "float16",
                 "float64", "int32", "int64", "bool_", "pi", "e", "inf",
                 "nan", "newaxis"}
    uncovered = sorted(n for n in dir(jmx.np) if not n.startswith("_")
                       and n not in CASES and n not in elsewhere)
    assert not uncovered, uncovered
    assert (tmx.np.pi, tmx.np.e, tmx.np.newaxis) == (np.pi, np.e, None)
    assert np.isinf(tmx.np.inf) and np.isnan(tmx.np.nan)
    assert tmx.np.ndarray is tmx.nd.NDArray
    import sys

    assert sys.modules["mxnet_tpu_torch.np"] is tmx.np
    assert sys.modules["mxnet_tpu_torch.npx"] is tmx.npx
    assert sys.modules["mxnet_tpu_torch.np.linalg"] is tmx.np.linalg


def test_integer_results_are_int64():
    """The recorded divergence: where PyTorch gives int64 (indices, counts,
    integer sums) the port keeps it; the JAX package, with 64-bit types
    off, gives int32. The values are equal (``test_name_matches_jax``);
    integer creation follows JAX's int32."""
    with tmx.cpu():
        xi = tmx.nd.array(I)
        x = tmx.nd.array(X)
        for out in (tmx.np.argmax(x), tmx.np.argsort(x),
                    tmx.np.count_nonzero(x), tmx.np.sum(xi),
                    tmx.np.searchsorted(tmx.nd.array(S), tmx.nd.array(V)),
                    tmx.np.bincount(tmx.nd.array(I.ravel())),
                    tmx.np.nonzero(xi > 10)[0],
                    tmx.np.triu_indices(3)[0]):
            assert out._data.dtype == torch.int64
        assert tmx.np.arange(5)._data.dtype == torch.int32
        assert tmx.np.arange(1.0, 3.0)._data.dtype == torch.float32
    assert jmx.np.argmax(jmx.nd.array(X)).asnumpy().dtype == np.int32


def test_numpy_semantics_where_torch_differs():
    """The trouble list checked against numpy itself."""
    with tmx.cpu():
        x = tmx.nd.array(X)
        np.testing.assert_allclose(tmx.np.var(x).asnumpy(), X.var(), **F32)
        np.testing.assert_allclose(tmx.np.median(x, axis=1).asnumpy(),
                                   np.median(X, axis=1), **F32)
        gx, gy = tmx.np.meshgrid(tmx.nd.array(W3), tmx.nd.array(V))
        assert gx.shape == np.meshgrid(W3, V)[0].shape == (4, 3)
        parts = tmx.np.array_split(tmx.nd.array(V), 3)
        assert [p.shape for p in parts] == [(2,), (1,), (1,)]
        np.testing.assert_array_equal(
            tmx.np.mod(tmx.nd.array(np.float32([5, -5])), -3.0).asnumpy(),
            np.mod(np.float32([5, -5]), -3.0))
        np.testing.assert_allclose(
            tmx.np.cbrt(tmx.nd.array(np.float32([-27, 8]))).asnumpy(),
            [-3, 2], **F32)
        e = tmx.np.empty_like(x)
        assert e.shape == X.shape and not e.asnumpy().any()
        h, edges = tmx.np.histogram(x, bins=4)
        wh, wedges = np.histogram(X, bins=4)
        np.testing.assert_array_equal(h.asnumpy(), wh)
        np.testing.assert_allclose(edges.asnumpy(), wedges, **F32)
        with pytest.raises(tmx.MXNetError, match="equal division"):
            tmx.np.split(x, 3, axis=1)


def test_np_results_stay_on_the_inputs_device():
    with tmx.cpu():
        out = tmx.np.add(tmx.nd.array(X), 1.0)
        assert out.context == tmx.cpu()
        assert tmx.np.zeros((2,)).context == tmx.cpu()


# -- np.linalg -----------------------------------------------------------------
SPD = (M @ M.T + 4 * np.eye(4)).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("norm", (M,)), ("inv", (SPD,)), ("det", (SPD,)), ("slogdet", (M,)),
    ("cholesky", (SPD,)), ("solve", (SPD, M))])
def test_linalg_matches_jax(name, args):
    want = getattr(jmx.np.linalg, name)(*[jmx.nd.array(a) for a in args])
    with tmx.cpu():
        got = getattr(tmx.np.linalg, name)(*[tmx.nd.array(a) for a in args])
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-4,
                                   atol=1e-5)


def test_linalg_svd_and_eigh_up_to_signs():
    """Singular values and eigenvalues as JAX's; the vectors may differ in
    sign, so the factorisations are held to their reconstructions."""
    ju, js, jv = jmx.np.linalg.svd(jmx.nd.array(X))
    jw, _ = jmx.np.linalg.eigh(jmx.nd.array(SPD))
    with tmx.cpu():
        u, s, vh = tmx.np.linalg.svd(tmx.nd.array(X))
        w, q = tmx.np.linalg.eigh(tmx.nd.array(SPD))
    np.testing.assert_allclose(s.asnumpy(), js.asnumpy(), rtol=1e-4)
    np.testing.assert_allclose(w.asnumpy(), jw.asnumpy(), rtol=1e-4)
    np.testing.assert_allclose(
        (u.asnumpy() * s.asnumpy()) @ vh.asnumpy(), X, atol=1e-5)
    qn = q.asnumpy()
    np.testing.assert_allclose(qn @ np.diag(w.asnumpy()) @ qn.T, SPD,
                               atol=1e-4)


# -- npx -------------------------------------------------------------------------
def _npx_cases():
    rs = np.random.RandomState(3)
    x = rs.randn(2, 5).astype(np.float32)
    ids = np.array([1, 0, 3], np.float32)
    w = rs.randn(3, 5).astype(np.float32)
    return [
        ("softmax", (x,), {}), ("log_softmax", (x,), {"axis": 0}),
        ("relu", (x,), {}), ("sigmoid", (x,), {}),
        ("activation", (x,), {"act_type": "tanh"}),
        ("one_hot", (ids,), {"depth": 4}),
        ("pick", (x, np.array([1, 4], np.float32)), {"axis": 1}),
        ("topk", (x,), {"k": 2, "ret_typ": "value"}),
        ("reshape_like", (x, x.reshape(5, 2)), {}),
        ("fully_connected", (x, w, np.zeros(3, np.float32)),
         {"num_hidden": 3}),
        ("layer_norm", (x, np.ones(5, np.float32), np.zeros(5, np.float32)),
         {}),
        ("embedding", (ids, w), {"input_dim": 3, "output_dim": 5}),
        ("broadcast_add", (x, x[:1]), {}),
    ]


@pytest.mark.parametrize("case", _npx_cases(), ids=lambda c: c[0])
def test_npx_matches_jax(case):
    name, args, kw = case
    want = getattr(jmx.npx, name)(*[jmx.nd.array(a) for a in args], **kw)
    with tmx.cpu():
        got = getattr(tmx.npx, name)(*[tmx.nd.array(a) for a in args], **kw)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32)
    assert tmx.npx.is_np_array() and tmx.npx.set_np() is None


# -- np.random --------------------------------------------------------------------
def test_random_by_moments():
    """The port's generators, not JAX's streams: each sampler's mean and
    variance within 6 standard errors of the distribution's; shuffle is in
    place and a permutation; the seed repeats a draw."""
    n = 1 << 16
    with tmx.cpu():
        tmx.np.random.seed(3)
        u = tmx.np.random.uniform(-1.0, 3.0, size=n).asnumpy()
        z = tmx.np.random.normal(2.0, 0.5, size=(n,)).asnumpy()
        r = tmx.np.random.randint(2, 7, size=n).asnumpy()
        assert tmx.np.random.rand(2, 3).shape == (2, 3)
        assert tmx.np.random.randn(4).shape == (4,)
        for got, mean, var in ((u, 1.0, 16 / 12), (z, 2.0, 0.25),
                               (r, 4.0, (25 - 1) / 12)):
            assert abs(got.mean() - mean) < 6 * np.sqrt(var / n)
            assert abs(got.var() - var) < 6 * var * np.sqrt(2 / n)
        assert r.min() == 2 and r.max() == 6 and r.dtype == np.int32
        x = tmx.nd.array(np.arange(10, dtype=np.float32))
        assert tmx.np.random.shuffle(x) is None
        assert sorted(x.asnumpy().tolist()) == list(range(10))
        p = tmx.np.random.permutation(x)
        assert sorted(p.asnumpy().tolist()) == list(range(10))
        tmx.np.random.seed(5)
        a = tmx.np.random.uniform(size=(3,)).asnumpy()
        tmx.np.random.seed(5)
        np.testing.assert_array_equal(a, tmx.np.random.uniform(
            size=(3,)).asnumpy())

"""The operators the BERT slice adds to the port (mxnet_tpu_torch.ops.core,
ops.nn's activation / softmax / log_softmax, gluon.nn's
Dense(activation=...) and Activation) against the JAX package's functions
on the same numpy inputs, including the out-of-range indices whose JAX
semantics the port keeps: gather_nd wraps a negative index once and clamps
(dropping the gradient of a clamped index), one_hot gives a zero row
outside [0, depth), pick clips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ops import core as jcore
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ops import core as tcore
from mxnet_tpu_torch.ops import nn as tops

F32 = dict(rtol=1e-5, atol=1e-6)
# bf16 outputs: both sides compute in f32 (or round bf16 inputs the same
# way) and round once; a result may land one bf16 ulp apart (2^-8)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
DTYPES = {"float32": (torch.float32, jnp.float32, F32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, BF16)}


def _x(shape, seed=0, scale=3.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("act", sorted(jops._ACTS))
def test_activation_matches_jax(act, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x = _x((7, 33), seed=1)
    got = tops.activation(torch.from_numpy(x).to(tdt), act)
    want = jops.activation(jnp.asarray(x, jdt), act_type=act)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)


def test_activation_table_and_refusal():
    assert set(tops._ACTS) == set(jops._ACTS)
    x = torch.from_numpy(_x((4, 5)))
    # "gelu" is the erf form, not GPT-2's tanh approximation
    assert not torch.allclose(tops.activation(x, "gelu"),
                              tops.activation(x, "tanh_gelu"))
    with pytest.raises(ValueError, match="act_type"):
        tops.activation(x, "swish")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_matches_jax(dtype, axis):
    tdt, jdt, tol = DTYPES[dtype]
    x = _x((3, 6, 9), seed=2)
    got = tops.softmax(torch.from_numpy(x).to(tdt), axis=axis)
    want = jops.softmax(jnp.asarray(x, jdt), axis=axis)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)
    got_t = tops.softmax(torch.from_numpy(x).to(tdt), axis=axis,
                         temperature=2.0)
    want_t = jops.softmax(jnp.asarray(x, jdt), axis=axis, temperature=2.0)
    np.testing.assert_allclose(_np(got_t), _jnp(want_t), **tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_softmax_with_length_matches_jax(dtype):
    """Row b takes part only over its first length[b] entries; the rest
    come out 0."""
    tdt, jdt, tol = DTYPES[dtype]
    x = _x((3, 4, 9), seed=3)
    length = np.array([9, 4, 1], np.int32)
    got = tops.softmax(torch.from_numpy(x).to(tdt), axis=-1,
                       length=torch.from_numpy(length))
    want = jops.softmax(jnp.asarray(x, jdt), axis=-1,
                        length=jnp.asarray(length))
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)
    assert (_np(got)[1, :, 4:] == 0).all() and (_np(got)[2, :, 1:] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_log_softmax_matches_jax(dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x = _x((5, 97), seed=4, scale=10.0)
    got = tops.log_softmax(torch.from_numpy(x).to(tdt))
    want = jops.log_softmax(jnp.asarray(x, jdt))
    assert got.dtype == tdt
    # log-probabilities reach ~-60 here: bf16's ulp there is 0.25
    tol = dict(tol, atol=0.25) if dtype == "bfloat16" else tol
    np.testing.assert_allclose(_np(got), _jnp(want), **tol)


def test_gather_nd_matches_jax_with_out_of_range_indices():
    """Rows (0, 1, 2) at columns (T, -1, -T-1) and in range: the forward
    reads the wrapped and clamped rows, and the gradient reaches only the
    indices in range after the wrap, as jax.grad of ``data[idx]``."""
    data = _x((4, 6, 5), seed=5)
    idx = np.array([[0, 1, 2, 3, 3], [6, -1, -7, 2, 4]], np.int32)
    w = _x((5, 5), seed=6)
    got_in = torch.from_numpy(data).requires_grad_()
    got = tcore.gather_nd(got_in, torch.from_numpy(idx))
    want = jcore.gather_nd(jnp.asarray(data), jnp.asarray(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    (grad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), got_in)
    want_grad = jax.grad(lambda d: (jcore.gather_nd(d, jnp.asarray(idx))
                                    * w).sum())(jnp.asarray(data))
    np.testing.assert_array_equal(grad.numpy(), np.asarray(want_grad))
    assert grad[0, 5].abs().sum() == 0  # index T: read, no gradient


@pytest.mark.parametrize("depth", [1, 7])
def test_one_hot_matches_jax_with_out_of_range_indices(depth):
    idx = np.array([[0, depth - 1, -1], [depth, 3, 2 * depth]], np.int32)
    got = tcore.one_hot(torch.from_numpy(idx), depth, on_value=2.0,
                        off_value=-1.0)
    want = jcore.one_hot(jnp.asarray(idx), depth, on_value=2.0,
                         off_value=-1.0)
    assert got.dtype == torch.float32 and got.shape == (2, 3, depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (0, True), (1, False)])
def test_pick_clips_as_jax(axis, keepdims):
    data = _x((4, 6), seed=7)
    n = data.shape[axis]
    other = data.shape[1 - (axis % 2)]
    idx = np.array([0, n - 1, -3, n, n + 5, 2][:other], np.int32)
    got = tcore.pick(torch.from_numpy(data), torch.from_numpy(idx),
                     axis=axis, keepdims=keepdims)
    want = jcore.pick(jnp.asarray(data), jnp.asarray(idx), axis=axis,
                      keepdims=keepdims)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="clip"):
        tcore.pick(torch.from_numpy(data), torch.from_numpy(idx), mode="wrap")


@pytest.mark.parametrize("axis,begin,end", [(1, 0, 1), (-1, 2, None),
                                            (0, -2, None), (2, 1, -1)])
def test_slice_axis_matches_jax(axis, begin, end):
    data = _x((3, 4, 5), seed=8)
    got = tcore.slice_axis(torch.from_numpy(data), axis, begin, end)
    want = jcore.slice_axis(jnp.asarray(data), axis, begin, end)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack_matches_jax(axis):
    xs = [_x((2, 3), seed=s) for s in range(3)]
    got = tcore.stack(*map(torch.from_numpy, xs), axis=axis)
    want = jcore.stack(*map(jnp.asarray, xs), axis=axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("args,dtype", [((7,), "int32"), ((2, 11, 3), "int32"),
                                        ((0.5, 3.0, 0.5), "float32"),
                                        ((-3, 4), "int32")])
def test_arange_matches_jax(args, dtype):
    got = tcore.arange(*args, dtype=dtype, device="cpu")
    want = jcore.arange(*args, dtype=dtype)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rep = tcore.arange(4, repeat=2, dtype="int32", device="cpu")
    np.testing.assert_array_equal(
        rep.numpy(), np.asarray(jcore.arange(4, repeat=2, dtype="int32")))


def test_arange_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tcore.arange(4)


def test_dense_tanh_and_activation_block_match_jax():
    """Dense(activation="tanh") (BERT's pooler) and the Activation block
    with the JAX blocks' weights."""
    x = _x((5, 12), seed=9, scale=1.0)
    mx.random.seed(0)
    jdense = jnn.Dense(8, activation="tanh", in_units=12)
    jdense.initialize()
    jact = jnn.Activation("gelu")
    want = jdense(nd.array(x))
    params = {k: np.asarray(p.data().asnumpy())
              for k, p in jdense._collect_params_with_prefix().items()}
    tdense = tnn.Dense(8, in_units=12, activation="tanh", device="cpu")
    tser.load_mxnet_params(tdense, params)
    got = tdense(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), want.asnumpy(), **F32)
    np.testing.assert_allclose(
        _np(tnn.Activation("gelu")(got)), jact(want).asnumpy(), **F32)
    plain = tnn.Dense(8, in_units=12, device="cpu")
    tser.load_mxnet_params(plain, params)
    np.testing.assert_allclose(_np(torch.tanh(plain(torch.from_numpy(x)))),
                               _np(got), rtol=0, atol=0)


def _backward_names(fn):
    """The class names of the autograd graph below ``fn``."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is not None and type(f).__name__ not in seen:
            seen.add(type(f).__name__)
            todo.extend(g for g, _ in f.next_functions)
    return seen


@pytest.mark.parametrize("rows", [2, 100])
def test_embedding_gradient_is_summed_deterministically(rows):
    """The lookup's gradient sums each row's duplicates (long runs of one
    id over 512 positions, and ids outside the table, whose gradient is
    dropped) as ``jnp.take``'s VJP does: by the one-hot product for a
    table of at most ``ONE_HOT_ROWS`` rows (BERT's two token types, where
    ``F.embedding``'s CUDA backward added two long runs in an order that
    changed from call to call), else by ``F.embedding``'s own backward."""
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 2, (8, 64)) * rs.randint(1, rows, (8, 64))
    ids[0, :3] = (-1, rows, -rows - 2)
    weight = _x((rows, 16), 4, 1.0)
    cot = _x((8, 64, 16), 5, 1.0)
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(ids), axis=0), weight)
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    w = torch.from_numpy(weight).requires_grad_()
    out = tops.embedding(torch.from_numpy(ids), w)
    names = _backward_names(out.grad_fn)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(w.grad.numpy(), want, rtol=1e-5, atol=1e-4)
    one_hot = rows <= tops.ONE_HOT_ROWS
    assert ("_LookupBackward" in names) == one_hot
    assert ("EmbeddingBackward0" in names) == (not one_hot)

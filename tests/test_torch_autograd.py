"""The port's ``autograd`` against the JAX package's: each case of
tests/test_autograd.py runs in both packages on the same numpy inputs and
the gradients (and outputs) must agree, plus the port's own rules: ops
outside ``record()`` build no graph, ``pause()`` stops recording, a
``grad_req="write"`` leaf is overwritten by a second backward, and a (B,)
head takes ones as its implied head gradient."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

F32 = dict(rtol=1e-5, atol=1e-6)
SIDES = {"jax": jmx, "torch": tmx}


def _both(case):
    """``case(mx)`` in each package (the port's on the CPU), as numpy."""
    want = case(jmx)
    with tmx.cpu():
        got = case(tmx)
    return got, want


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _simple_backward(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return x.grad


def _chain_and_broadcast(mx):
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(3, 4).astype(np.float32))
    w = mx.nd.array(rs.rand(5, 4).astype(np.float32))
    x.attach_grad()
    w.attach_grad()
    with mx.autograd.record():
        y = mx.nd.FullyConnected(x, w, None, num_hidden=5, no_bias=True)
        z = mx.nd.relu(y)
        loss = (z * z).mean()
    loss.backward()
    return [x.grad, w.grad, loss]


def _head_gradient(mx):
    x = mx.nd.array([2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 3
    y.backward(mx.nd.array([5.0]))
    return x.grad


def _grad_req_add(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad(grad_req="add")
    for _ in range(2):
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return x.grad


def _grad_req_write(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    for _ in range(2):
        with mx.autograd.record():
            y = (x * x).sum()
        y.backward()
    return x.grad


def _detach_blocks_grad(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * 2
        z = (y.detach() * x).sum()
    z.backward()
    return x.grad


def _stop_gradient_op(mx):
    x = mx.nd.array([3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.BlockGrad(x * 2) * x
    y.backward()
    return x.grad


def _autograd_grad_api(mx):
    x = mx.nd.array([1.0, 2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x ** 3).sum()
    (g,) = mx.autograd.grad([y], [x])
    return g


def _getitem_grad(mx):
    x = mx.nd.array([1.0, 2.0, 3.0, 4.0])
    x.attach_grad()
    with mx.autograd.record():
        y = (x[1:3] * 2).sum()
    y.backward()
    return x.grad


def _mark_variables(mx):
    x = mx.nd.array([1.0, 2.0])
    g = mx.nd.zeros((2,))
    mx.autograd.mark_variables(x, g)
    with mx.autograd.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad, g]


def _second_order(mx):
    x = mx.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with mx.autograd.record():
        y = x * x * x
        (gx,) = mx.autograd.grad(y, x, create_graph=True)
        z = gx.sum()
    z.backward()
    return [x.grad, gx]


def _second_order_sin(mx):
    x = mx.nd.array([0.3, 1.1])
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.sin(x)
        (gx,) = mx.autograd.grad(y, x, create_graph=True)
        w = gx.sum()
    w.backward()
    return [x.grad, gx]


def _first_order_unchanged(mx):
    x = mx.nd.array([2.0])
    with mx.autograd.record():
        y = x * x
    (g,) = mx.autograd.grad(y, [x])
    return g


def _vector_head(mx):
    """A (B,) head without a head gradient takes ones."""
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2))
    x.attach_grad()
    with mx.autograd.record():
        y = (x * x).sum(axis=1)
    y.backward()
    return x.grad


def _function(mx):
    class Scale(mx.autograd.Function):
        def forward(self, a):
            return a * 2

        def backward(self, g):
            return g * 3

    x = mx.nd.array([1.0, -2.0])
    x.attach_grad()
    with mx.autograd.record():
        y = Scale()(x)
        z = (y * y).sum()
    z.backward()
    return [x.grad, y]


CASES = {"simple_backward": _simple_backward,
         "chain_and_broadcast": _chain_and_broadcast,
         "head_gradient": _head_gradient, "grad_req_add": _grad_req_add,
         "grad_req_write": _grad_req_write,
         "detach_blocks_grad": _detach_blocks_grad,
         "stop_gradient_op": _stop_gradient_op,
         "autograd_grad_api": _autograd_grad_api,
         "getitem_grad": _getitem_grad, "mark_variables": _mark_variables,
         "grad_create_graph_second_order": _second_order,
         "grad_create_graph_sin": _second_order_sin,
         "grad_first_order_unchanged": _first_order_unchanged,
         "vector_head": _vector_head, "function": _function}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    got, want = _both(CASES[case])
    got, want = _np(got), _np(want)
    if not isinstance(want, list):
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_is_training_flags(side):
    ag = SIDES[side].autograd
    assert not ag.is_recording()
    assert not ag.is_training()
    with ag.record():
        assert ag.is_recording()
        assert ag.is_training()
        with ag.pause():
            assert not ag.is_recording()
    with ag.record(train_mode=False):
        assert not ag.is_training()
    with ag.predict_mode():
        assert not ag.is_training()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_dropout_gradient_matches_its_mask(side):
    """The gradient of a recorded Dropout is 1/keep exactly where the
    output kept its input (the JAX tape replays the key; the port's
    autograd saves the mask)."""
    mx = SIDES[side]
    with (tmx.cpu() if side == "torch" else jmx.cpu()):
        x = mx.nd.array(np.ones((200,), np.float32))
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Dropout(x, p=0.5, training=True)
            loss = y.sum()
        loss.backward()
    out, g = y.asnumpy(), x.grad.asnumpy()
    assert 0 < (out == 0).sum() < 200
    np.testing.assert_allclose((out != 0).astype(np.float32) * 2.0, g)


def test_ops_outside_record_build_no_graph():
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        y = (x * x).sum()
        assert not y._data.requires_grad
        with pytest.raises(ValueError, match="no arrays with attach_grad"):
            y.backward()
        with tmx.autograd.record():
            with tmx.autograd.pause():
                z = x * 2
            w = (x * 3).sum()
        assert not z._data.requires_grad and w._data.requires_grad
    with pytest.raises(ValueError, match="no arrays with attach_grad"):
        jy = (jmx.nd.array([1.0]) * 2).sum()
        jy.backward()


def test_write_overwrites_what_torch_would_accumulate():
    """A second backward under grad_req='write' replaces the gradient;
    torch's .backward() would have added to it."""
    with tmx.cpu():
        x = tmx.nd.array([1.0, 2.0])
        x.attach_grad()
        for _ in range(3):
            with tmx.autograd.record():
                y = (x * x).sum()
            y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), [2.0, 4.0])
        assert x._data.grad.is_contiguous()

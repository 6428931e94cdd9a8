"""The port's ``nd.contrib.foreach`` / ``while_loop`` / ``cond``
(``mxnet_tpu_torch/control_flow.py``) against the JAX package's on the same
inputs, the cases of ``tests/test_linalg_control_flow.py``: a cumulative
sum, several data arrays, states and outputs, the gradient of a weight the
body closes over, a while loop stopped by its predicate (its outputs zero
past the last step taken) and by ``max_iterations``, one that takes no
step, and ``cond`` on both branches, recorded for autograd.

Tolerance: f32 1e-6 (the same elementwise ops in the same order)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu_torch import nd as tnd

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(fn):
    """``fn(mx, nd)`` in both packages (the port's on the CPU)."""
    want = fn(jmx, jnd)
    with tmx.cpu():
        got = fn(tmx, tnd)
    return got, want


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_foreach_cumsum():
    def run(mx, nd):
        data = nd.array(np.arange(6, dtype=np.float32).reshape(6, 1))
        return nd.contrib.foreach(lambda x, s: (x + s, x + s), data,
                                  nd.zeros((1,)))

    got, want = _both(run)
    _close(got, want)
    np.testing.assert_allclose(got[1].asnumpy(), [15.0])


def test_foreach_several_arrays_states_and_outputs():
    def run(mx, nd):
        data = [nd.array(np.arange(8, dtype=np.float32).reshape(4, 2)),
                nd.array(np.full((4, 2), 2.0, np.float32))]

        def body(xs, states):
            a, b = xs
            s1, s2 = states
            return [a + s1, b * s2], [s1 + a, s2 * 1.5]

        return nd.contrib.foreach(body, data, [nd.zeros((2,)),
                                               nd.ones((2,))])

    got, want = _both(run)
    assert len(got[0]) == 2 and len(got[1]) == 2
    _close(got, want)


def test_foreach_gradient_reaches_a_closed_over_weight():
    def run(mx, nd):
        data = nd.array(np.arange(1, 5, dtype=np.float32).reshape(4, 1))
        w = nd.array([2.0])
        w.attach_grad()
        with mx.autograd.record():
            outs, final = nd.contrib.foreach(
                lambda x, s: (x * w * s, s + x * w), data, nd.ones((1,)))
            loss = outs.sum() + final.sum()
        loss.backward()
        return [outs, final, w.grad]

    got, want = _both(run)
    _close(got, want)


@pytest.mark.parametrize("limit,max_iterations", [(10, 8), (100, 4), (0, 3)])
def test_while_loop_matches_jax(limit, max_iterations):
    """Sum 0, 1, 2, ... while the total is under ``limit``: the predicate
    stops it, ``max_iterations`` stops it, or it takes no step; the stacked
    outputs are zero past the last step taken."""
    def run(mx, nd):
        return nd.contrib.while_loop(
            lambda i, total: total < limit,
            lambda i, total: ([i, total * 2], (i + 1, total + i)),
            [nd.array([0.0]), nd.array([0.0])],
            max_iterations=max_iterations)

    got, want = _both(run)
    _close(got, want)
    assert got[0][0].shape == (max_iterations, 1)


def test_while_loop_records_no_gradient():
    with tmx.cpu():
        x = tnd.array([1.0])
        x.attach_grad()
        with tmx.autograd.record():
            _, (y,) = tnd.contrib.while_loop(
                lambda v: v < 5, lambda v: (v, [v * 2]), [x],
                max_iterations=4)
        assert not y._data.requires_grad


@pytest.mark.parametrize("pred", [1.0, 0.0])
def test_cond_runs_one_branch(pred):
    def run(mx, nd):
        a, b = nd.array([1.0, 2.0]), nd.array([3.0, -1.0])
        a.attach_grad()
        with mx.autograd.record():
            out = nd.contrib.cond(nd.array([pred]), lambda: a * b,
                                  lambda: a - b)
        out.backward()
        return [out, a.grad]

    got, want = _both(run)
    _close(got, want)


def test_cond_with_two_outputs():
    def run(mx, nd):
        a = nd.array([1.0, 2.0])
        return nd.contrib.cond(nd.array([0.0]), lambda: [a, a * 2],
                               lambda: [a + 1, a * 3])

    got, want = _both(run)
    _close(got, want)

"""Test utilities (reference: ``python/mxnet/test_utils.py``).

Counterpart of ``mxnet_tpu/test_utils.py``: dtype-aware
``assert_almost_equal``, the central finite-difference gradient checker
(through the port's autograd), ``rand_ndarray``, ``same_array``, and
``check_consistency`` with MXNet's own meaning: the same function on the
CPU and on the card (the JAX package compares its eager and compiled
paths instead). Without a card ``check_consistency`` raises ``MXNetError``
rather than compare the CPU with itself.
"""
from __future__ import annotations

import numpy as np
import torch

from . import autograd
from .base import MXNetError
from .context import cpu, current_context, gpu
from .ndarray import NDArray, array

__all__ = ["default_context", "assert_almost_equal", "almost_equal",
           "check_numeric_gradient", "check_consistency", "rand_ndarray",
           "same_array", "default_rtols", "list_gpus", "list_tpus"]

_DEFAULT_RTOL = {
    np.dtype(np.float16): 1e-2,
    np.dtype(np.float32): 1e-4,
    np.dtype(np.float64): 1e-6,
}
_DEFAULT_ATOL = {
    np.dtype(np.float16): 1e-2,
    np.dtype(np.float32): 1e-5,
    np.dtype(np.float64): 1e-7,
}


def default_rtols(dtype):
    d = np.dtype(dtype) if not str(dtype).startswith("bfloat") \
        else np.dtype(np.float16)
    return _DEFAULT_RTOL.get(d, 1e-4), _DEFAULT_ATOL.get(d, 1e-5)


def list_gpus():
    """Reference ``test_utils.list_gpus``: the CUDA card indices."""
    return list(range(torch.cuda.device_count()))


def list_tpus():
    """No TPU on this stack."""
    return []


def default_context():
    return current_context()


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def almost_equal(a, b, rtol=None, atol=None):
    a, b = _np(a), _np(b)
    rt, at = default_rtols(a.dtype)
    return np.allclose(a, b, rtol=rtol or rt, atol=atol or at)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    a_np, b_np = _np(a), _np(b)
    rt, at = default_rtols(a_np.dtype)
    np.testing.assert_allclose(a_np, b_np, rtol=rtol or rt, atol=atol or at,
                               err_msg=f"{names[0]} vs {names[1]}")


def rand_ndarray(shape, dtype="float32", ctx=None, scale=1.0):
    data = (np.random.randn(*shape) * scale).astype(np.dtype(dtype))
    return array(data, ctx=ctx)


def same_array(a, b):
    """Whether two NDArrays are views of the same memory (a write through
    one shows through the other), MXNet's aliasing check."""
    if a is b or a._data is b._data:
        return True
    ta, tb = a._data, b._data
    return (ta.device == tb.device and ta.dtype == tb.dtype
            and ta.data_ptr() == tb.data_ptr() and ta.shape == tb.shape
            and ta.stride() == tb.stride())


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=1e-4,
                           input_grads=None):
    """Compare autograd gradients of ``fn(*inputs)`` (its sum when not a
    scalar) against central finite differences (reference:
    check_numeric_gradient)."""
    nds = [x if isinstance(x, NDArray) else array(x) for x in inputs]
    for x in nds:
        x.attach_grad()
    with autograd.record():
        out = fn(*nds)
        if out.size != 1:
            out = out.sum()
    out.backward()
    analytic = [x.grad.asnumpy() for x in nds]

    for xi, x in enumerate(nds):
        base = x.asnumpy().astype(np.float64)
        fd = np.zeros_like(base)
        it = np.nditer(base, flags=["multi_index"])
        while not it.finished:
            idx = it.multi_index
            xp = base.copy()
            xp[idx] += eps
            xm = base.copy()
            xm[idx] -= eps

            def eval_at(v):
                args = [array(v.astype(x.dtype), ctx=x.context)
                        if j == xi else nds[j] for j in range(len(nds))]
                o = fn(*args)
                return float(o.sum().asnumpy()) if o.size != 1 \
                    else float(o.asnumpy())

            fd[idx] = (eval_at(xp) - eval_at(xm)) / (2 * eps)
            it.iternext()
        np.testing.assert_allclose(analytic[xi], fd, rtol=rtol, atol=atol,
                                   err_msg=f"input {xi}: autograd vs "
                                           f"finite-diff")


def check_consistency(fn, inputs, rtol=1e-4, atol=1e-5):
    """``fn`` on CPU copies of ``inputs`` against ``fn`` on card copies
    (MXNet's cpu-vs-gpu oracle); outputs compared on the host. Raises
    ``MXNetError`` when there is no card."""
    if not torch.cuda.is_available():
        raise MXNetError("check_consistency compares the CPU with the card, "
                         "and no CUDA card is present")
    host = [_np(x) for x in inputs]
    outs = []
    for ctx in (cpu(), gpu(0)):
        with ctx:
            out = fn(*[array(h, ctx=ctx, dtype=h.dtype) for h in host])
        outs.append(out if isinstance(out, (list, tuple)) else [out])
    for i, (c, g) in enumerate(zip(*outs)):
        np.testing.assert_allclose(_np(c), _np(g), rtol=rtol, atol=atol,
                                   err_msg=f"output {i}: cpu vs gpu")

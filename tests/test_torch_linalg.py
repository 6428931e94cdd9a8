"""The port's ``ops/linalg.py`` (every op of ``mxnet_tpu/ops/linalg.py``)
against the JAX package's on the same seeded numpy inputs: values, and the
gradients of ``gemm``, ``gemm2``, ``potrf``, ``potri``, ``trsm``, ``trmm``,
``syrk``, ``sumlogdiag``, ``det`` and ``inverse`` against a seeded
cotangent; ``potrf`` of a batch holding a matrix that is not positive
definite (NaN in that matrix's lower triangle, the others factored);
``gelqf`` and ``syevd`` held by reconstruction, orthonormality and
agreement with JAX up to the sign of each row (two LAPACK builds may pick
other signs); ``maketrian`` against JAX for every (offset, lower); the
``nd.linalg`` namespace, and ``gemm2`` under both packages' ``amp.init``.

Tolerances: 1e-5 relative / 1e-5 absolute for products and their
gradients; 1e-4 for the factorizations and solves (LAPACK in both, in
other operation orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import registry as jreg
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import registry as treg

PROD = dict(rtol=1e-5, atol=1e-5)
FACT = dict(rtol=1e-4, atol=1e-4)


def _f(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _spd(n, batch=(), seed=0):
    a = _f(batch + (n, n), seed)
    return a @ np.swapaxes(a, -1, -2) + 3 * np.eye(n, dtype=np.float32)


SPD = _spd(4, (2,))
CHOL = np.linalg.cholesky(SPD).astype(np.float32)

# name -> (inputs, params, indices of the inputs to differentiate, tol)
CASES = {
    "linalg_gemm": ([_f((3, 4), 1), _f((4, 5), 2), _f((3, 5), 3)],
                    {"alpha": 0.5, "beta": 2.0}, (0, 1, 2), PROD),
    "linalg_gemm-t": ([_f((2, 4, 3), 4), _f((2, 5, 4), 5), _f((2, 3, 5), 6)],
                      {"transpose_a": True, "transpose_b": True}, (0, 1, 2),
                      PROD),
    "linalg_gemm2": ([_f((2, 3, 4), 7), _f((2, 5, 4), 8)],
                     {"transpose_b": True, "alpha": 2.0}, (0, 1), PROD),
    "linalg_potrf": ([SPD], {}, (0,), FACT),
    "linalg_potri": ([CHOL], {}, (0,), FACT),
    "linalg_trsm": ([CHOL, _f((2, 4, 3), 9)], {"alpha": 1.5}, (0, 1), FACT),
    "linalg_trsm-t": ([CHOL, _f((2, 4, 3), 10)], {"transpose": True},
                      (0, 1), FACT),
    "linalg_trsm-right": ([np.swapaxes(CHOL, -1, -2).copy(),
                           _f((2, 3, 4), 11)],
                          {"rightside": True, "lower": False}, (0, 1), FACT),
    "linalg_trmm": ([_f((2, 4, 4), 12), _f((2, 4, 3), 13)],
                    {"alpha": 2.0}, (0, 1), PROD),
    "linalg_trmm-right": ([_f((2, 4, 4), 14), _f((2, 3, 4), 15)],
                          {"rightside": True, "lower": False,
                           "transpose": True}, (0, 1), PROD),
    "linalg_syrk": ([_f((3, 4), 16)], {"alpha": 0.5}, (0,), PROD),
    "linalg_syrk-t": ([_f((3, 4), 16)], {"transpose": True}, (0,), PROD),
    "linalg_sumlogdiag": ([CHOL], {}, (0,), FACT),
    "linalg_det": ([SPD / 3], {}, (0,), FACT),
    "linalg_slogdet": ([_f((2, 3, 3), 17)], {}, (), FACT),
    "linalg_inverse": ([SPD], {}, (0,), FACT),
    "linalg_extractdiag": ([_f((2, 4, 4), 18)], {"offset": 1}, (0,), PROD),
    "linalg_makediag": ([_f((2, 3), 19)], {"offset": -1}, (0,), PROD),
    "linalg_extracttrian": ([_f((2, 4, 4), 20)], {}, (0,), PROD),
    "linalg_extracttrian-up": ([_f((4, 4), 21)],
                               {"offset": 1, "lower": False}, (0,), PROD),
    "linalg_maketrian": ([_f((2, 10), 22)], {}, (0,), PROD),
}


def _linalg_names():
    return sorted({op.name for op in jreg._REGISTRY.values()
                   if op.fn.__module__ == "mxnet_tpu.ops.linalg"})


def test_every_linalg_op_is_covered():
    covered = {c.split("-")[0] for c in CASES} | {"linalg_gelqf",
                                                  "linalg_syevd"}
    assert set(_linalg_names()) == covered
    for name in _linalg_names():
        assert treg.get("_" + name) is treg.get(name)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_linalg_op_matches_jax(case):
    name = case.split("-")[0]
    inputs, params, diff, tol = CASES[case]
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn
    t_in = [torch.from_numpy(a.copy()) for a in inputs]
    for i in diff:
        t_in[i].requires_grad_(True)
    tout = _as_list(tfn(*t_in, **params))

    def jf(*d):
        args = [jnp.asarray(a) for a in inputs]
        for i, v in zip(diff, d):
            args[i] = v
        return _as_list(jfn(*args, **params))

    jout, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(inputs[i]) for i in diff])
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=case, **tol)
    if not diff:
        return
    cots = [_f(np.shape(o), 40 + k) for k, o in enumerate(jout)]
    jg = vjp([jnp.asarray(c) for c in cots])
    torch.autograd.backward(tout, [torch.from_numpy(c) for c in cots])
    for i, g in zip(diff, jg):
        np.testing.assert_allclose(t_in[i].grad.numpy(), np.asarray(g),
                                   err_msg=f"{case} d{i}", **tol)


def test_potrf_of_a_matrix_that_is_not_positive_definite_is_nan():
    """As the JAX op: NaN in the lower triangle of the bad matrix, zeros
    above it, and the other matrix of the batch factored."""
    a = SPD.copy()
    a[1] = np.array([[1, 2, 0, 0], [2, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                    np.float32)
    got = treg.get("linalg_potrf").fn(torch.from_numpy(a)).numpy()
    want = np.asarray(jreg.get("linalg_potrf").fn(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1][np.tril_indices(4)]).all()
    np.testing.assert_allclose(got[0], want[0], **FACT)
    np.testing.assert_array_equal(got[1][np.triu_indices(4, 1)], 0)


def _row_signs(a, b):
    """Flip each row of ``a`` to the sign of the same row of ``b``."""
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return a * s


@pytest.mark.parametrize("shape", [(3, 5), (2, 4, 4)])
def test_gelqf_reconstructs_and_agrees_up_to_row_signs(shape):
    a = _f(shape, 30)
    tl, tq = (t.numpy() for t in
              treg.get("linalg_gelqf").fn(torch.from_numpy(a)))
    jl, jq = (np.asarray(t) for t in
              jreg.get("linalg_gelqf").fn(jnp.asarray(a)))
    m = shape[-2]
    np.testing.assert_allclose(tl @ tq, a, **FACT)
    np.testing.assert_allclose(tq @ np.swapaxes(tq, -1, -2),
                               np.broadcast_to(np.eye(m), tq.shape[:-1] +
                                               (m,)), atol=1e-5)
    assert np.abs(np.triu(tl, 1)).max() < 1e-6
    np.testing.assert_allclose(_row_signs(tq, jq), jq, **FACT)
    # L's column j goes with Q's row j
    flip = np.sign(np.sum(tq * jq, axis=-1))
    np.testing.assert_allclose(tl * flip[..., None, :], jl, **FACT)


def test_syevd_reconstructs_and_agrees_up_to_row_signs():
    a = SPD
    tu, tw = (t.numpy() for t in
              treg.get("linalg_syevd").fn(torch.from_numpy(a)))
    ju, jw = (np.asarray(t) for t in
              jreg.get("linalg_syevd").fn(jnp.asarray(a)))
    np.testing.assert_allclose(tw, jw, **FACT)
    recon = np.swapaxes(tu, -1, -2) @ (tw[..., :, None] * tu)
    np.testing.assert_allclose(recon, a, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_row_signs(tu, ju), ju, **FACT)


@pytest.mark.parametrize("offset", [-2, -1, 0, 1, 2, 3])
@pytest.mark.parametrize("lower", [True, False])
def test_maketrian_inverts_extracttrian_as_jax(offset, lower):
    a = _f((2, 5, 5), 31)
    packed = treg.get("linalg_extracttrian").fn(
        torch.from_numpy(a), offset=offset, lower=lower)
    got = treg.get("linalg_maketrian").fn(packed, offset=offset,
                                          lower=lower).numpy()
    want = np.asarray(jreg.get("linalg_maketrian").fn(
        jnp.asarray(packed.numpy()), offset=offset, lower=lower))
    np.testing.assert_array_equal(got, want)


def test_maketrian_refuses_a_count_no_triangle_has():
    with pytest.raises(ValueError, match="no n matches"):
        treg.get("linalg_maketrian").fn(torch.zeros(2, 4))


def test_linalg_namespace_matches_jax():
    a, b = _f((3, 4), 32), _f((4, 2), 33)
    want = jnd.linalg.gemm2(jnd.array(a), jnd.array(b), alpha=3.0)
    with tmx.cpu():
        got = tnd.linalg.gemm2(tnd.array(a), tnd.array(b), alpha=3.0)
        pot = tnd.linalg.potrf(tnd.array(SPD))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **PROD)
    np.testing.assert_allclose(pot.asnumpy(),
                               jnd.linalg.potrf(jnd.array(SPD)).asnumpy(),
                               **FACT)


def test_gemm2_under_amp_init_matches_jax():
    from mxnet_tpu.contrib import amp as jamp
    from mxnet_tpu_torch.contrib import amp as tamp

    a, b = _f((3, 16), 34), _f((16, 5), 35)
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        want = jnd.linalg_gemm2(jnd.array(a), jnd.array(b))
        with tmx.cpu():
            got = tnd.linalg_gemm2(tnd.array(a), tnd.array(b))
    finally:
        jamp._reset()
        tamp._reset()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **PROD)
    assert np.abs(got.asnumpy() - a @ b).max() > 1e-4  # bf16 operands

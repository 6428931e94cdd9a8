"""The port's softmax cross entropy (mxnet_tpu_torch.ops.softmax_xent)
against the JAX package's Pallas kernel in interpret mode and its custom
VJP, on the same numpy inputs, at the tolerances of
tests/test_pallas_softmax_xent.py: 1e-5 in f32, 3e-2 in bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_softmax_xent as px
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.ops import softmax_xent as tsx

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(n, c, seed=0, scale=3.0):
    rs = np.random.RandomState(seed)
    return ((rs.randn(n, c) * scale).astype(np.float32),
            rs.randint(0, c, (n,)).astype(np.int32))


def _jax_fused(x, lbl, dtype):
    return px.softmax_cross_entropy_fused(jnp.asarray(x, dtype),
                                          jnp.asarray(lbl), interpret=True)


def _torch_x(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(12, 64), (9, 50), (300, 128)])
def test_forward_matches_jax_kernel(n, c, dtype):
    x, lbl = _inputs(n, c)
    ref = _jax_fused(x, lbl, dtype)
    got = tsx.softmax_cross_entropy_fused(_torch_x(x, dtype),
                                          torch.from_numpy(lbl))
    assert got.shape == (n,) and got.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c", [(10, 64), (9, 50), (300, 128)])
def test_backward_matches_jax_custom_vjp(n, c, dtype):
    """dx = (softmax - onehot) * g with a non-uniform cotangent, through the
    autograd Function, against jax.grad of the Pallas op; dx in x's dtype."""
    x, lbl = _inputs(n, c, seed=2, scale=1.0)
    co = (np.random.RandomState(3).rand(n) + 0.5).astype(np.float32)
    ref = jax.grad(lambda v: jnp.sum(px.softmax_cross_entropy_fused(
        v, jnp.asarray(lbl), interpret=True) * co))(jnp.asarray(x, dtype))
    tx = _torch_x(x, dtype).requires_grad_()
    loss = tsx.softmax_cross_entropy_fused(tx, torch.from_numpy(lbl))
    (got,) = torch.autograd.grad(loss, tx, torch.from_numpy(co))
    assert got.dtype == tx.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_plain_versions_match_jax_forward_and_vjp_directly():
    """The two plain versions the kernels are held against on the card:
    (loss, lse) and the backward from (x, labels, g)."""
    x, lbl = _inputs(20, 33, seed=4)
    g = np.random.RandomState(5).rand(20).astype(np.float32)
    loss, lse = tsx.softmax_cross_entropy_plain(torch.from_numpy(x),
                                                torch.from_numpy(lbl))
    np.testing.assert_allclose(loss.numpy(), np.asarray(_jax_fused(x, lbl, "float32")),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(x, -1)),
                               rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda v: px.softmax_cross_entropy_fused(
        v, jnp.asarray(lbl), interpret=True), jnp.asarray(x))
    dx = tsx.softmax_cross_entropy_bwd_plain(torch.from_numpy(x),
                                             torch.from_numpy(lbl),
                                             torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)


def test_leading_shape_kept_and_float_labels_cast():
    """(B, T, C) LM-head logits keep their (B, T) loss shape; float labels
    are cast to int32 as in JAX."""
    rs = np.random.RandomState(1)
    x = rs.randn(4, 6, 32).astype(np.float32)
    lbl = rs.randint(0, 32, (4, 6)).astype(np.int32)
    ref = px.softmax_cross_entropy_fused(jnp.asarray(x), jnp.asarray(lbl),
                                         interpret=True)
    for label in (torch.from_numpy(lbl), torch.from_numpy(lbl.astype(np.float32))):
        got = tsx.softmax_cross_entropy_fused(torch.from_numpy(x), label)
        assert got.shape == (4, 6)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_extreme_logits_stable():
    x = np.asarray([[1e4, -1e4, 0.0, 50.0] * 8], np.float32)
    lbl = np.asarray([1], np.int32)
    ref = _jax_fused(x, lbl, "float32")
    got = tsx.softmax_cross_entropy_fused(torch.from_numpy(x),
                                          torch.from_numpy(lbl))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("label", [-1, 7], ids=["minus_one", "C"])
def test_out_of_range_labels_pick_nothing(label):
    """A label outside [0, C) never matches a column in the JAX kernel: the
    loss is lse and the gradient is softmax · g (no one-hot)."""
    x, lbl = _inputs(3, 7, seed=6)
    lbl[1] = label
    co = np.asarray([0.5, 2.0, 1.5], np.float32)
    ref = _jax_fused(x, lbl, "float32")
    rgrad = jax.grad(lambda v: jnp.sum(px.softmax_cross_entropy_fused(
        v, jnp.asarray(lbl), interpret=True) * co))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = tsx.softmax_cross_entropy_fused(tx, torch.from_numpy(lbl))
    (dx,) = torch.autograd.grad(got, tx, torch.from_numpy(co))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].item(),
                               np.asarray(jax.nn.logsumexp(x[1])), rtol=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rgrad), rtol=1e-5,
                               atol=1e-6)


def test_minus_inf_logits():
    """-inf entries drop out of the row's sum; a row that is all -inf gives
    NaN, as the JAX max-shift does."""
    x, lbl = _inputs(3, 16, seed=7)
    x[0, ::2] = -np.inf
    x[2, :] = -np.inf
    lbl[0] = 1
    ref = np.asarray(_jax_fused(x, lbl, "float32"))
    got = tsx.softmax_cross_entropy_fused(torch.from_numpy(x),
                                          torch.from_numpy(lbl)).numpy()
    assert np.isfinite(got[:2]).all() and np.isnan(ref[2]) and np.isnan(got[2])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_gate_keeps_jax_semantics_without_tpu_terms():
    """Knob, class axis last, ndim >= 2, f32/bf16; f16 goes to the
    composition. The JAX gate's TPU terms (on a TPU, C % 128 == 0,
    C <= 65536) are dropped: a ragged 50-wide or a 70000-wide row is taken."""
    ok = tsx.xent_kernel_supported
    assert tconfig.get("fused_softmax_xent") is True
    for shape in ((8, 128), (8, 50), (2, 70000), (2, 3, 50257)):
        assert ok(torch.zeros(shape))
        assert ok(torch.zeros(shape, dtype=torch.bfloat16))
    assert not ok(torch.zeros(8, 50, dtype=torch.float16))
    assert not ok(torch.zeros(8, 128), axis=0)
    assert ok(torch.zeros(8, 128), axis=1)
    assert not ok(torch.zeros(128))
    tconfig.set("fused_softmax_xent", False)
    try:
        assert not ok(torch.zeros(8, 128))
    finally:
        tconfig.set("fused_softmax_xent", True)


def test_knob_default_on_with_env_alias(monkeypatch):
    monkeypatch.setattr(tconfig, "_values", {})
    assert tconfig.get("fused_softmax_xent") is True
    monkeypatch.setenv("MXNET_TPU_FUSED_SOFTMAX_XENT", "0")
    assert tconfig.get("fused_softmax_xent") is False


def test_wrappers_refuse_non_cuda_tensors():
    x = torch.zeros(4, 8, device="meta")
    lbl = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        tsx._xent_fwd(x, lbl)
    with pytest.raises(MXNetError, match="CUDA"):
        tsx._xent_bwd(x, lbl, torch.zeros(2, 4, device="meta"),
                      torch.zeros(4, device="meta"))


def test_launch_counters_untouched_on_cpu():
    before = dict(tsx.launches)
    x, lbl = _inputs(4, 8)
    tx = torch.from_numpy(x).requires_grad_()
    tsx.softmax_cross_entropy_fused(tx, torch.from_numpy(lbl)).sum().backward()
    assert tsx.launches == before and tx.grad is not None

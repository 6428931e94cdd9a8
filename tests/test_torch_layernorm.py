"""The port's LayerNorm (mxnet_tpu_torch.ops.layernorm) against the JAX
package's Pallas kernel in interpret mode on the same numpy inputs, at the
tolerances of tests/test_pallas_layernorm.py (2e-5 in f32, 3e-2 in bf16;
gradients rtol 1e-4 / atol 1e-5 in f32, the custom-VJP test there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_layernorm as pln
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.ops import layernorm as tln
from mxnet_tpu_torch.ops import nn as tnn

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(shape, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rs.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rs.randn(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128), (40, 1024)])
def test_matches_jax_kernel(shape, dtype):
    x, g, b = _inputs(shape)
    ref = pln.layer_norm_fused(jnp.asarray(x, dtype), jnp.asarray(g, dtype),
                               jnp.asarray(b, dtype), 1e-5, interpret=True)
    dt = getattr(torch, dtype)
    got = tln.layer_norm(torch.from_numpy(x).to(dt), torch.from_numpy(g).to(dt),
                         torch.from_numpy(b).to(dt), 1e-5)
    assert got.dtype == dt and tuple(got.shape) == shape
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_knob_selects_same_math_on_cpu():
    x, g, b = (torch.from_numpy(a) for a in _inputs((4, 32), seed=1))
    on = tnn.layer_norm(x, g, b)
    tconfig.set("fused_layernorm", False)
    try:
        off = tnn.layer_norm(x, g, b)
    finally:
        tconfig.set("fused_layernorm", True)
    assert torch.equal(on, off)


def test_fused_layernorm_defaults_on():
    assert tconfig.get("fused_layernorm") is True


def test_wrapper_refuses_non_cuda_device():
    x = torch.zeros(2, 8, device="meta")
    g = torch.zeros(8, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        tln.layer_norm(x, g, g)


# gradients: f32 as test_ln_custom_vjp_matches_jnp_grads; bf16 outputs of
# the same f32 math differ by the last bf16 rounding, so 3e-2 as above
GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 3e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128)])
def test_grads_match_jax_vjp(shape, dtype):
    """dx, dgamma and dbeta through the autograd Function against jax.vjp
    of the JAX package's custom-VJP LayerNorm (kernel in interpret mode)."""
    x, g, b = _inputs(shape, seed=2)
    cot = np.random.RandomState(3).randn(*shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda x, g, b: pln.layer_norm_fused(
        x, g, b, 1e-5, interpret=True), jnp.asarray(x, jdt),
        jnp.asarray(g, jdt), jnp.asarray(b, jdt))
    ref = vjp(jnp.asarray(cot, jdt))
    dt = getattr(torch, dtype)
    xt, gt, bt = (torch.from_numpy(a).to(dt).requires_grad_()
                  for a in (x, g, b))
    got = torch.autograd.grad(tln.layer_norm(xt, gt, bt, 1e-5), (xt, gt, bt),
                              torch.from_numpy(cot).to(dt))
    rtol, atol = GRAD_TOL[dtype]
    for a, r, name in zip(got, ref, ("dx", "dgamma", "dbeta")):
        assert a.dtype == dt, name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(r, np.float32),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_grads_match_autograd_of_plain_version():
    """The analytic backward equals autograd through the plain composition
    (what the knob-off path differentiates), f32, 1e-5."""
    x, g, b = (torch.from_numpy(a).requires_grad_()
               for a in _inputs((6, 5, 96), seed=4))
    cot = torch.from_numpy(np.random.RandomState(5).randn(6, 5, 96)
                           .astype(np.float32))
    got = torch.autograd.grad(tln.layer_norm(x, g, b), (x, g, b), cot)
    want = torch.autograd.grad(tln.layer_norm_plain(x, g, b), (x, g, b), cot)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_no_function_node_without_grad():
    """Without a gradient to take, the forward runs bare (no autograd node,
    no saved tensors)."""
    x, g, b = (torch.from_numpy(a) for a in _inputs((4, 32), seed=6))
    assert tln.layer_norm(x, g, b).grad_fn is None
    x.requires_grad_()
    assert type(tln.layer_norm(x, g, b).grad_fn).__name__ == "LayerNormFnBackward"
    with torch.no_grad():
        assert tln.layer_norm(x, g, b).grad_fn is None

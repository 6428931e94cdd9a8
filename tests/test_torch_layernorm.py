"""The port's LayerNorm (mxnet_tpu_torch.ops.layernorm) against the JAX
package's Pallas kernel in interpret mode on the same numpy inputs, at the
tolerances of tests/test_pallas_layernorm.py (2e-5 in f32, 3e-2 in bf16)."""
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

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
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128), (40, 1024),
                                   (6, 1000)])
def test_grads_match_jax_vjp(shape, dtype):
    """dx, dgamma and dbeta through the autograd Function (on the CPU its
    backward is the plain version, layer_norm_bwd) against jax.vjp of the
    JAX package's custom-VJP LayerNorm (kernel in interpret mode), at the
    training width and at a ragged one."""
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


def test_route_picks_warp_and_block_kernels():
    """The warp kernel for rows of whole 16-byte vectors at aligned
    addresses up to its width; the block kernel for wider, ragged or
    misaligned rows."""
    f32, bf16 = torch.float32, torch.bfloat16
    fwd = tln.FWD_WARP_MAX_BYTES // 4  # f32 rows
    bwd = tln.BWD_WARP_MAX_D
    assert tln._route(1024, f32, (0, 4096, 8192), fwd) == "warp"
    assert tln._route(1024, bf16, (0, 4096), bwd) == "warp"
    assert tln._route(1000, f32, (0,), fwd) == "warp"  # 250 vectors of 4
    assert tln._route(1000, bf16, (0,), fwd) == "warp"  # 125 vectors of 8
    assert tln._route(64, f32, (0,), bwd) == "warp"
    assert tln._route(2048, bf16, (0,), tln.FWD_WARP_MAX_BYTES // 2) == "warp"
    # wide
    assert tln._route(8192, f32, (0,), fwd) == "block"
    assert tln._route(2 * fwd, f32, (0,), fwd) == "block"
    assert tln._route(2 * bwd, bf16, (0,), bwd) == "block"
    # ragged: not a whole number of 16-byte vectors
    assert tln._route(1023, f32, (0,), fwd) == "block"
    assert tln._route(1020, bf16, (0,), fwd) == "block"
    # misaligned: any pointer off a 16-byte boundary (x[1:] of a contiguous
    # f32 tensor starts 4 bytes on)
    assert tln._route(1024, f32, (4,), fwd) == "block"
    assert tln._route(1024, bf16, (0, 0, 2, 0), bwd) == "block"
    assert tln._route(0, f32, (0,), fwd) == "block"


def test_backward_refuses_non_cuda_device():
    x = torch.zeros(2, 8, device="meta")
    g = torch.zeros(8, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        tln._backward(x, g, x, 1e-5)


def test_cpu_path_leaves_launch_counts_at_zero(monkeypatch):
    """Forward and backward on CPU tensors run the plain versions: no
    launch is counted."""
    monkeypatch.setattr(tln, "launches", {"fwd": 0, "bwd": 0, "bwd_merge": 0})
    x, g, b = (torch.from_numpy(a).requires_grad_()
               for a in _inputs((4, 32), seed=7))
    tln.layer_norm(x, g, b).sum().backward()
    assert x.grad is not None and g.grad is not None
    assert tln.launches == {"fwd": 0, "bwd": 0, "bwd_merge": 0}


class _FakeLib:
    """Stands in for the built library: records the launch arguments."""

    def __init__(self):
        self.calls = []

    def mx_layernorm(self, *args):
        self.calls.append(("fwd",) + args)
        return 0

    def mx_layernorm_bwd(self, *args):
        self.calls.append(("bwd",) + args)
        return 0


@pytest.mark.parametrize("rows,d,warps", [(8, 1024, True), (4096, 1024, True),
                                          (6, 1023, False), (3, 8192, False)])
def test_kernel_launch_routes_and_counts(rows, d, warps, monkeypatch):
    """The CUDA branch, with the card mocked (meta tensors, a stand-in
    library): the forward launches once ("fwd"), the backward launches its
    row kernel and its merge once each ("bwd", "bwd_merge"), with the warps
    of the route taken (0: the block route) and a grid of at most
    BWD_BLOCKS_PER_SM blocks a SM."""
    from mxnet_tpu_torch.ops import cuda_common as cc

    lib = _FakeLib()
    monkeypatch.setattr(cc, "check_device", lambda t: None)
    monkeypatch.setattr(cc, "load", lambda name: lib)
    monkeypatch.setattr(cc, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(tln, "_sm_count", lambda device: 132)
    monkeypatch.setattr(tln, "launches", {"fwd": 0, "bwd": 0, "bwd_merge": 0})
    x = torch.zeros(rows, d, device="meta")
    p = torch.zeros(d, device="meta")
    y = tln._forward(x, p, p, 1e-5)
    dx, dgamma, dbeta = tln._backward(x, p, x, 1e-5)
    assert y.shape == dx.shape == x.shape
    assert dgamma.shape == dbeta.shape == (d,)
    assert tln.launches == {"fwd": 1, "bwd": 1, "bwd_merge": 1}
    (_, *fargs), (_, *bargs) = lib.calls
    assert fargs[4:7] == [rows, d, 1e-5]
    assert fargs[-2] == (tln.FWD_WARPS if warps else 0)
    bwd_warps, blocks = bargs[-3:-1]
    assert bwd_warps == (tln.BWD_WARPS if warps else 0)
    per_block = bwd_warps or 1
    assert blocks == min(-(-rows // per_block), tln.BWD_BLOCKS_PER_SM * 132)

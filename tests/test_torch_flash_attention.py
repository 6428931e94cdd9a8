"""The port's flash attention (mxnet_tpu_torch.ops.flash_attention) against
the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs. Tolerances are those of tests/test_flash_attention.py: forward
2e-4 in f32 and 3e-2 in bf16, backward 2e-3 (f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tfa

FWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
BWD_TOL = 2e-3
# (Tq, Tk): square, cross lengths both ways (causal rows with no live key
# when Tq > Tk), and a ragged length with no 64/128 divisor
LENGTHS = [(128, 128), (128, 384), (384, 128), (320, 320)]


def _qkv(tq, tk, d, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    q = (rs.randn(1, 2, tq, d) * scale).astype(np.float32)
    k = (rs.randn(1, 2, tk, d) * scale).astype(np.float32)
    v = rs.randn(1, 2, tk, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", LENGTHS)
def test_forward_and_lse_match_jax_kernel(tq, tk, causal, dtype):
    q, k, v = _qkv(tq, tk, 64, seed=tq + tk)
    jdt = getattr(jnp, dtype)
    ref, ref_lse = jfa._flash_fwd(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                  jnp.asarray(v, jdt), causal, interpret=True,
                                  return_lse=True)
    dt = getattr(torch, dtype)
    out, lse = tfa._flash_fwd(torch.from_numpy(q).to(dt),
                              torch.from_numpy(k).to(dt),
                              torch.from_numpy(v).to(dt), causal,
                              return_lse=True)
    assert out.dtype == dt and tuple(out.shape) == (1, 2, tq, 64)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (1, 2, tq)
    tol = FWD_TOL[dtype]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)
    # the JAX lse is lane-replicated (B*H, Tq, 128): column 0 is the value
    np.testing.assert_allclose(lse.reshape(2, tq).numpy(),
                               np.asarray(ref_lse)[:, :, 0], rtol=tol, atol=tol)
    if causal and tq > tk:  # rows that see no key: out 0 and lse 0
        dead = np.arange(tq) + tk - tq < 0
        assert np.all(out.float().numpy()[:, :, dead] == 0)
        assert np.all(lse.numpy()[:, :, dead] == 0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", LENGTHS)
def test_backward_matches_jax_vjp(tq, tk, causal):
    """dq, dk, dv of the port's autograd Function (the FA-2 plain backward
    on the CPU) against jax.vjp of the JAX flash_attention, whose backward
    is the dkv + dq Pallas kernels in interpret mode."""
    q, k, v = _qkv(tq, tk, 64, seed=3 * tq + tk, scale=0.5)
    cot = np.random.RandomState(tq).randn(1, 2, tq, 64).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, interpret=True), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(cot))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, causal=causal)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=BWD_TOL,
                                   atol=BWD_TOL, err_msg=name)


def test_backward_d128_bf16_matches_f32_math():
    """bf16 inputs at head dim 128: the backward's f32 math, cast to bf16,
    against the f32 backward of the same (bf16-rounded) inputs (3e-2, the
    bf16 tolerance above)."""
    q, k, v = _qkv(96, 160, 128, seed=9, scale=0.5)
    do = np.random.RandomState(10).randn(1, 2, 96, 128).astype(np.float32)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do)]
    tf = [t.float() for t in tb]
    o_b, lse_b = tfa._flash_fwd(*tb[:3], True, return_lse=True)
    o_f, lse_f = tfa._flash_fwd(*tf[:3], True, return_lse=True)
    got = tfa.flash_bwd_plain(*tb[:3], o_b, lse_b, tb[3], True)
    want = tfa.flash_bwd_plain(*tf[:3], o_f, lse_f, tf[3], True)
    for a, r in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), r, rtol=3e-2, atol=3e-2)


def _plain_bwd(q, k, v, do, causal, rounded):
    out, lse = tfa.flash_fwd_plain(q, k, v, causal)
    di = tfa._row_dot(do, out)
    dk, dv = tfa._flash_bwd_dkv_plain(q, k, v, do, lse, di, causal,
                                      rounded=rounded)
    return (tfa._flash_bwd_dq_plain(q, k, v, do, lse, di, causal,
                                    rounded=rounded), dk, dv)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(128, 384), (384, 128), (320, 320)])
def test_rounded_plain_backward_matches_jax_vjp_bf16(tq, tk, causal, d):
    """The plain backward that rounds p and ds to bf16 before the
    accumulating products, as the bf16 tensor-core kernels do, against
    jax.vjp of the JAX flash_attention (Pallas in interpret mode) on the
    same bf16 inputs, at the bf16 tolerance (3e-2); for f32 inputs the
    option changes nothing."""
    q, k, v = _qkv(tq, tk, d, seed=5 * tq + tk + d, scale=0.5)
    cot = np.random.RandomState(tq + d).randn(1, 2, tq, d).astype(np.float32)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, cot)]
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, interpret=True), *jb[:3])
    ref = vjp(jb[3])
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, cot)]
    got = _plain_bwd(*tb, causal, rounded=True)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32), rtol=3e-2,
                                   atol=3e-2, err_msg=name)
    tf = [torch.from_numpy(a) for a in (q, k, v, cot)]
    for a, b in zip(_plain_bwd(*tf, causal, rounded=True),
                    _plain_bwd(*tf, causal, rounded=False)):
        assert torch.equal(a, b)


def test_knob_off_backward_takes_plain_version():
    """flash_pallas_bwd off is the explicit choice of the plain backward; on
    the CPU both settings run it, so the gradients are equal."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(64, 64, 64, seed=1))
    grads = []
    for on in (True, False):
        tconfig.set("flash_pallas_bwd", on)
        try:
            out = tfa.flash_attention(q, k, v, causal=True)
            grads.append(torch.autograd.grad(out.sum(), (q, k, v)))
        finally:
            tconfig.set("flash_pallas_bwd", True)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_flash_supported_admits_kernel_shapes_at_any_length():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype)

    # no 2048 crossover and no 128-multiple: short and ragged lengths pass
    assert tfa.flash_supported(t(1, 2, 7, 64), t(1, 2, 300, 64), t(1, 2, 300, 64))
    assert tfa.flash_supported(*(t(2, 4, 1024, 128, dtype=torch.bfloat16),) * 3)
    assert not tfa.flash_supported(*(t(1, 2, 64, 32),) * 3)  # head dim
    assert not tfa.flash_supported(*(t(1, 2, 64, 64, dtype=torch.float16),) * 3)
    assert not tfa.flash_supported(*(t(1, 2, 64, 64),) * 3,
                                   mask=torch.ones(64, 64))


def test_wrappers_refuse_non_cuda_tensors():
    q = torch.zeros(1, 2, 64, 64, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_fwd(q, q, q, True)
    with pytest.raises(MXNetError, match="CUDA"):
        tfa._flash_bwd(q, q, q, q, torch.zeros(1, 2, 64, device="meta"), q,
                       True)


def test_cpu_path_counts_no_launch():
    before = dict(tfa.launches)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(64, 64, 64, seed=2))
    torch.autograd.grad(tfa.flash_attention(q, k, v, causal=True).sum(),
                        (q, k, v))
    assert tfa.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_dispatch(masked, monkeypatch):
    """No mask and the flash_attention knob on: the flash path; a mask: the
    plain einsum path. Both agree with _reference_mha (f32, 1e-5)."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _qkv(48, 48, 16, seed=4))
    mask = torch.from_numpy(np.random.RandomState(5).rand(48, 48) > 0.3) \
        if masked else None
    if masked:
        mask[:, 0] = True  # every row keeps a live key
    out = tatt.multi_head_attention(q, k, v, mask=mask, causal=True)
    ref = tatt._reference_mha(q, k, v, mask=mask, causal=True)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert len(calls) == (0 if masked else 1)
    tconfig.set("flash_attention", False)
    try:
        calls.clear()
        tatt.multi_head_attention(q, k, v, causal=True)
        assert not calls
    finally:
        tconfig.set("flash_attention", True)

"""The interleaved-projection attention ops, ``boolean_mask``, the chunked
attention and the knob-off flash backward of the port against the JAX
package on the same seeded numpy inputs:

- ``_contrib_div_sqrt_dim`` and the four
  ``_contrib_interleaved_matmul_{selfatt,encdec}_{qk,valatt}`` ops, values
  and gradients, without AMP (f32: 1e-5) and under ``amp.init("bfloat16")``
  in both packages (``selfatt_qk`` casts its input to bf16 and its scores
  back to the caller's dtype: 2e-2 relative, bf16's rounding of the
  products);
- ``boolean_mask`` and ``_contrib_boolean_mask``;
- ``chunked_attention`` (the port of ``_chunked_attention``) forward and
  VJP, causal and not, Tq < Tk, chunk sizes that do not divide Tk
  (1e-5), and its memory: no saved tensor of the (B, H, Tq, Tk) scores;
- ``FlashAttention``'s backward with ``flash_pallas_bwd`` off: the VJP of
  the chunked attention (held against JAX's escape hatch, the VJP of
  ``_chunked_attention``), never ``flash_bwd_plain``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tfa

F32 = dict(rtol=1e-5, atol=1e-5)
AMP = dict(rtol=2e-2, atol=2e-2)
T, TK, BATCH, H, CH = 7, 9, 3, 2, 8


def _x(shape, seed, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


@pytest.fixture
def amp_both(request):
    """``amp.init(dtype)`` in both packages for one test (None: off)."""
    dtype = request.param
    if dtype is not None:
        jmx.contrib.amp.init(dtype)
        tmx.contrib.amp.init(dtype)
    try:
        yield dtype
    finally:
        jmx.contrib.amp._reset()
        tmx.contrib.amp._reset()


def _vjp_pair(jfn, tfn, arrays, cot):
    jo, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    jg = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    to = tfn(*ts)
    to.backward(torch.from_numpy(cot))
    return (to.detach().float().numpy(), np.asarray(jo, np.float32)), \
        [(t.grad.numpy(), np.asarray(g)) for t, g in zip(ts, jg)]


CASES = {
    "selfatt_qk": (lambda m: m.interleaved_matmul_selfatt_qk,
                   [(T, BATCH, H * 3 * CH)], (BATCH * H, T, T)),
    "selfatt_valatt": (lambda m: m.interleaved_matmul_selfatt_valatt,
                       [(T, BATCH, H * 3 * CH), (BATCH * H, T, T)],
                       (T, BATCH, H * CH)),
    "encdec_qk": (lambda m: m.interleaved_matmul_encdec_qk,
                  [(T, BATCH, H * CH), (TK, BATCH, H * 2 * CH)],
                  (BATCH * H, T, TK)),
    "encdec_valatt": (lambda m: m.interleaved_matmul_encdec_valatt,
                      [(TK, BATCH, H * 2 * CH), (BATCH * H, T, TK)],
                      (T, BATCH, H * CH)),
}


@pytest.mark.parametrize("amp_both", [None, "bfloat16"], indirect=True)
@pytest.mark.parametrize("name", sorted(CASES))
def test_interleaved_ops_match_jax(name, amp_both):
    pick, shapes, out_shape = CASES[name]
    arrays = [_x(s, i) for i, s in enumerate(shapes)]
    cot = _x(out_shape, 9)
    (to, jo), grads = _vjp_pair(
        lambda *a: pick(jatt)(*a, heads=H),
        lambda *a: pick(tatt)(*a, heads=H), arrays, cot)
    assert to.shape == out_shape == jo.shape
    tol = AMP if amp_both and name == "selfatt_qk" else F32
    np.testing.assert_allclose(to, jo, **tol)
    for tg, jg in grads:
        np.testing.assert_allclose(tg, jg, **tol)


@pytest.mark.parametrize("amp_both", [None, "bfloat16"], indirect=True)
def test_selfatt_qk_returns_the_callers_dtype(amp_both):
    qkv = torch.from_numpy(_x((T, BATCH, H * 3 * CH), 1))
    assert tatt.interleaved_matmul_selfatt_qk(qkv, heads=H).dtype == \
        torch.float32
    with tmx.cpu():
        nd_out = tnd._contrib_interleaved_matmul_selfatt_qk(tnd.array(qkv),
                                                            heads=H)
    assert nd_out.dtype == np.float32


def test_the_ops_rebuild_multi_head_attention():
    """scores -> softmax -> valatt equals the port's plain attention over
    the same heads (GluonNLP's BERT cell against ``multi_head_attention``)."""
    qkv = torch.from_numpy(_x((T, BATCH, H * 3 * CH), 2))
    att = torch.softmax(tatt.interleaved_matmul_selfatt_qk(qkv, heads=H), -1)
    out = tatt.interleaved_matmul_selfatt_valatt(qkv, att, heads=H)
    x = qkv.reshape(T, BATCH, H, 3, CH).permute(3, 1, 2, 0, 4)
    want = tatt.multi_head_attention(x[0], x[1], x[2], use_flash=False)
    np.testing.assert_allclose(
        out.numpy(), want.permute(2, 0, 1, 3).reshape(T, BATCH, H * CH)
        .numpy(), **F32)


def test_div_sqrt_dim_matches_jax():
    x = _x((3, 5, 16), 3)
    want = np.asarray(jatt.div_sqrt_dim(jnp.asarray(x)))
    with tmx.cpu():
        got = tnd._contrib_div_sqrt_dim(tnd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("name", ["boolean_mask", "_contrib_boolean_mask"])
@pytest.mark.parametrize("axis", [0, 1])
def test_boolean_mask_matches_jax(name, axis):
    x = _x((4, 5), 4)
    mask = np.array([1, 0, 1, 1, 0][:x.shape[axis]], np.float32)
    want = jmx.nd.boolean_mask(jmx.nd.array(x), jmx.nd.array(mask),
                               axis=axis).asnumpy()
    with tmx.cpu():
        got = getattr(tnd, name)(tnd.array(x), tnd.array(mask),
                                 axis=axis).asnumpy()
    np.testing.assert_array_equal(got, want)


CHUNKED = [(16, 16, 8, True), (16, 16, 8, False), (6, 24, 16, True),
           (12, 20, 8, True), (5, 7, 1024, False)]


@pytest.mark.parametrize("tq,tk,chunk,causal", CHUNKED,
                         ids=[str(c) for c in CHUNKED])
def test_chunked_attention_and_its_vjp_match_jax(tq, tk, chunk, causal):
    q, k, v = _x((2, 2, tq, 8), 5), _x((2, 2, tk, 8), 6), _x((2, 2, tk, 8), 7)
    cot = _x((2, 2, tq, 8), 8)
    (to, jo), grads = _vjp_pair(
        lambda *a: jfa._chunked_attention(*a, causal, chunk=chunk),
        lambda *a: tfa.chunked_attention(*a, causal, chunk=chunk),
        [q, k, v], cot)
    np.testing.assert_allclose(to, jo, **F32)
    for tg, jg in grads:
        np.testing.assert_allclose(tg, jg, **F32)
    # chunked_attention_vjp: the default chunk, as the knob-off backward
    got = tfa.chunked_attention_vjp(*(torch.from_numpy(a) for a in (q, k, v)),
                                    torch.from_numpy(cot), causal)
    for g, (_, jg) in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), jg, **F32)


def test_chunked_vjp_keeps_no_score_matrix():
    """The tensors autograd saves outside the checkpointed chunk bodies
    are the (B, H, Tq, D) carries and the inputs: none is as large as one
    chunk's (B, H, Tq, chunk) scores, let alone the (B, H, Tq, Tk)
    matrix."""
    b, h, t, d, chunk = 1, 2, 256, 8, 32
    q, k, v = (torch.randn(b, h, t, d, requires_grad=True) for _ in range(3))
    biggest = []

    def pack(x):
        biggest.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = tfa.chunked_attention(q, k, v, True, chunk=chunk)
    assert max(biggest) < b * h * t * chunk
    out.sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knob_off_flash_backward_is_jax_chunked_vjp(causal, dtype,
                                                    monkeypatch):
    """``flash_pallas_bwd`` off: the gradients of ``flash_attention`` are the
    VJP of the chunked attention, as JAX's escape hatch
    (``_flash_vjp_bwd``); ``flash_bwd_plain`` is not called."""
    q, k, v = (_x((1, 2, 32, 64), s, 0.5) for s in (11, 12, 13))
    cot = _x((1, 2, 32, 64), 14)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda *a: jfa._chunked_attention(*a, causal),
                     *[jnp.asarray(a, jdt) for a in (q, k, v)])
    want = [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(cot, jdt))]

    def refuse(*a, **kw):
        raise AssertionError("the knob-off backward took flash_bwd_plain")

    monkeypatch.setattr(tfa, "flash_bwd_plain", refuse)
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    tconfig.set("flash_pallas_bwd", False)
    try:
        out = tfa.flash_attention(*ts, causal=causal)
        out.backward(torch.from_numpy(cot).to(tdt))
    finally:
        tconfig.set("flash_pallas_bwd", True)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.float().numpy(), w, **tol)

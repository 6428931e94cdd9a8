"""GPT-2 serving under ``contrib.amp.init("bfloat16")``: the port against
the JAX package with the same weights (carried through a ``.params`` file),
AMP on in both.

- Cached prefill and decode logits, dense and paged caches (JAX's paged
  read in interpret mode): both packages round the same operands to bf16 at
  the same places (q, k, v before the cached branch, the attention weights
  before their product with the f32 cache, the tied LM head's operands) and
  sum in f32, so they agree to f32 sum order (measured ~6e-8); the
  tolerance is the f32 one of tests/test_torch_gpt2.py, 1e-4. An f32 LM
  head or cached attention that ignores amp.init is off by ~2e-3.
- Dense == paged logits within the port, bit for bit.
- The eager full forward at the bf16 tolerance 3e-2: the port's full-
  sequence attention takes the flash path (f32 scores of the bf16 q, k)
  where JAX on the CPU takes its einsum path (bf16 scores).
- The same cached logits under ``amp.init("float16")`` (f16 q over the f32
  caches), at 1e-4 too.
- The AMP matmul rules against the JAX package's: the tied LM head's
  (``contrib.amp.matmul``) against ``dot``, which rounds only when both
  operands are f32, and ``fully_connected``'s, which rounds when the data
  is f32, each with same and mixed operand dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.contrib import amp as jamp
from mxnet_tpu.inference import GenerationEngine as JEngine
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.ops import core as jcore
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.inference import GenerationEngine as TEngine
from mxnet_tpu_torch.models import gpt2 as tgpt2
from mxnet_tpu_torch.ops import nn as tnn

VOCAB, EOS, PAD = 97, 96, 0
SMALL = dict(num_layers=2, units=64, num_heads=4, max_length=64,
             vocab_size=VOCAB, dropout=0.0)
CACHED_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mx.random.seed(0)
    jnet = jgpt2.GPT2Model(**SMALL)
    jnet.initialize()
    _ = jnet(nd.array(np.zeros((1, 4)), dtype="int32"))
    fname = str(tmp_path_factory.mktemp("amp_serving") / "gpt2.params")
    jnet.save_parameters(fname)
    tnet = tgpt2.GPT2Model(**SMALL, device="cpu", seed=3)
    tser.load_mxnet_params(tnet, tser.load_ndarrays(fname))
    return jnet, tnet


def _amp_in_both(dtype):
    """amp.init(dtype) in both packages for one test, reset after it
    whatever the test did."""
    try:
        jamp.init(dtype)
        tamp.init(dtype)
        yield
    finally:
        jamp._reset()
        tamp._reset()


@pytest.fixture
def amp_bf16():
    yield from _amp_in_both("bfloat16")


@pytest.fixture
def amp_f16():
    yield from _amp_in_both("float16")


def _engines(pair, paged):
    jnet, tnet = pair
    kw = dict(batch_size=2, prefill_buckets=(8, 16), eos_id=None, pad_id=PAD,
              paged=paged)
    if paged:
        kw["page_size"] = 8
    return JEngine(jnet, **kw), TEngine(tnet, device="cpu", **kw)


def _cached_logits(jeng, teng, decode_steps=5):
    """Two prefills and ``decode_steps`` greedy decode steps on both
    engines; the port is fed JAX's tokens, so that both see the same inputs
    at every step. Returns the per-call logits of each, as numpy f32."""
    rs = np.random.RandomState(7)
    j_out, t_out = [], []
    for slot, n in enumerate((5, 13)):
        prompt = list(rs.randint(1, EOS, n))
        tok = jeng.prefill(prompt, slot)
        teng.prefill(prompt, slot)
        teng.last_tokens[slot] = tok
        j_out.append(np.asarray(jeng._last_logits, np.float32))
        t_out.append(teng._last_logits.float().numpy())
    for _ in range(decode_steps):
        jt, _, jl = jeng.decode_step()
        _, _, tl = teng.decode_step()
        teng.last_tokens = np.asarray(jt).astype(np.int32).copy()
        j_out.append(np.asarray(jl, np.float32))
        t_out.append(tl.float().numpy())
    return j_out, t_out


@pytest.mark.parametrize("paged", [False, True])
def test_cached_logits_match_jax_under_amp(pair, amp_bf16, paged):
    jeng, teng = _engines(pair, paged)
    j_out, t_out = _cached_logits(jeng, teng)
    for i, (got, ref) in enumerate(zip(t_out, j_out)):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, err_msg=f"call {i}", **CACHED_TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_cached_logits_match_jax_under_float16_amp(pair, amp_f16, paged):
    """amp.init("float16"): f16 q over the f32 caches, which the port's
    paged read takes as it takes bf16 q (JAX's read in interpret mode
    rounds the same weights)."""
    jeng, teng = _engines(pair, paged)
    j_out, t_out = _cached_logits(jeng, teng)
    for i, (got, ref) in enumerate(zip(t_out, j_out)):
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, err_msg=f"call {i}", **CACHED_TOL)


def test_amp_changes_the_cached_logits(pair):
    """The amp.init run differs from the f32 run by more than CACHED_TOL in
    both packages: the check above can see an amp.init that is ignored."""
    runs = {}
    for on in (False, True):
        if on:
            jamp.init("bfloat16")
            tamp.init("bfloat16")
        try:
            runs[on] = _cached_logits(*_engines(pair, paged=True))
        finally:
            jamp._reset()
            tamp._reset()
    for side in (0, 1):
        gap = max(np.abs(a - b).max() for a, b in zip(runs[True][side],
                                                      runs[False][side]))
        assert gap > 10 * CACHED_TOL["atol"], (side, gap)


def test_dense_equals_paged_under_amp(pair, amp_bf16):
    """Dense and paged caches go through one read (the kernel's plain
    version here) with bf16 q over f32 caches: bit-identical logits."""
    _, tnet = pair
    kw = dict(batch_size=2, prefill_buckets=(8, 16), eos_id=None, pad_id=PAD)
    dense = TEngine(tnet, device="cpu", paged=False, **kw)
    paged = TEngine(tnet, device="cpu", paged=True, page_size=8, **kw)
    assert all(k.dtype == torch.float32 for k, _ in dense.cache)
    rs = np.random.RandomState(11)
    for slot, n in enumerate((6, 14)):
        prompt = list(rs.randint(1, EOS, n))
        assert dense.prefill(prompt, slot) == paged.prefill(prompt, slot)
        assert torch.equal(dense._last_logits, paged._last_logits)
    for _ in range(6):
        td, _, ld = dense.decode_step()
        tp, _, lp = paged.decode_step()
        np.testing.assert_array_equal(td, tp)
        assert torch.equal(ld, lp)


@pytest.mark.parametrize("t", [1, 17])
def test_eager_logits_match_jax_under_amp(pair, amp_bf16, t):
    jnet, tnet = pair
    ids = np.random.RandomState(t).randint(0, VOCAB, (3, t))
    ref = jnet(nd.array(ids, dtype="int32")).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **BF16_TOL)


@pytest.mark.parametrize("transpose_b", [False, True])
def test_amp_matmul_rule_matches_jax_dot(amp_bf16, transpose_b):
    """contrib.amp.matmul (the tied LM head) against the JAX ``dot`` under
    amp.init: f32 operands rounded to bf16, f32 sum and result; bf16
    operands pass through."""
    rs = np.random.RandomState(1)
    a = rs.randn(6, 40).astype(np.float32)
    b = rs.randn(9, 40).astype(np.float32) if transpose_b \
        else rs.randn(40, 9).astype(np.float32)
    ref = np.asarray(jcore.dot(nd.array(a)._data, nd.array(b)._data,
                               transpose_b=transpose_b))
    tb = torch.from_numpy(b)
    got = tamp.matmul(torch.from_numpy(a), tb.t() if transpose_b else tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    plain = torch.from_numpy(a) @ (tb.t() if transpose_b else tb)
    assert not torch.allclose(got, plain, rtol=1e-5, atol=1e-5)
    low = tamp.matmul(torch.from_numpy(a).bfloat16(),
                      (tb.t() if transpose_b else tb).bfloat16())
    assert low.dtype == torch.bfloat16


DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operands(rs, a_dt, b_dt, b_shape):
    """Numpy operands exactly representable in their dtypes, as JAX arrays
    and as port tensors."""
    out = []
    for dt, shape in ((a_dt, (6, 40)), (b_dt, b_shape)):
        jdt, tdt = DTYPES[dt]
        x = np.asarray(jnp.asarray(rs.randn(*shape).astype(np.float32), jdt))
        out.append((jnp.asarray(x), torch.from_numpy(
            np.array(x, np.float32)).to(tdt)))
    return out


@pytest.mark.parametrize("a_dt,b_dt", [("f32", "bf16"), ("bf16", "f32")])
def test_amp_matmul_mixed_dtypes_match_jax_dot(amp_bf16, a_dt, b_dt):
    """With one operand f32 and the other bf16 the JAX ``dot`` rounds
    nothing (``_amp_pair`` needs both f32) and multiplies in the promoted
    f32: so does contrib.amp.matmul, as the tied LM head calls it."""
    (ja, ta), (jb, tb) = _operands(np.random.RandomState(2), a_dt, b_dt,
                                   (40, 9))
    ref = np.asarray(jcore.dot(ja, jb), np.float32)
    got = tamp.matmul(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ta.float() @ tb.float())  # nothing rounded


@pytest.mark.parametrize("data_dt,w_dt", [("f32", "f32"), ("f32", "bf16"),
                                          ("bf16", "f32"), ("bf16", "bf16")])
def test_fully_connected_matches_jax_under_amp(amp_bf16, data_dt, w_dt):
    """ops.nn.fully_connected against the JAX ``fully_connected`` under
    amp.init("bfloat16"): an f32 data rounds both operands (the weight
    whatever its dtype), f32 sum and result; a bf16 data is multiplied as
    it is, in the promoted dtype."""
    (jd, td), (jw, tw) = _operands(np.random.RandomState(3), data_dt, w_dt,
                                   (9, 40))
    ref = jnn.fully_connected(jd, jw)
    got = tnn.fully_connected(td, tw)
    assert str(got.dtype)[6:] == str(ref.dtype)
    tol = 1e-5 if got.dtype == torch.float32 else 1e-2  # bf16: one ulp
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)

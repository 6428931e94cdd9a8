"""The port's paged attention (mxnet_tpu_torch.ops.paged_attention) against
the JAX package's Pallas kernel in interpret mode, on the same numpy
inputs: the cases of tests/test_pallas_paged_attention.py (tq 1 and 5,
ragged final pages, released rows whose table is all trash). Tolerances:
1e-5 with f32 pools, 2e-2 with bf16 pools; low-precision q over f32
pools (the cached read under amp.init, bf16 or f16 q) at the tolerance
of q's dtype. Within the port, the dense cache (identity page table) and
the paged cache give bit-identical outputs on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import pallas_paged_attention as ppa
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import paged_attention as tpa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# f16 q over f32 pools: f16 outputs one ulp apart (2^-10 relative)
F16_TOL = 2e-3


def _mk_case(rs, b, h, tq, ch, ps, n_pages, pool_pages, trash_rows=False,
             position=None):
    case = dict(
        q=rs.randn(b, h, tq, ch).astype(np.float32),
        k_new=rs.randn(b, h, tq, ch).astype(np.float32),
        v_new=rs.randn(b, h, tq, ch).astype(np.float32),
        k_pool=rs.randn(pool_pages + 1, h, ps, ch).astype(np.float32),
        v_pool=rs.randn(pool_pages + 1, h, ps, ch).astype(np.float32),
        table=rs.randint(1, pool_pages + 1, (b, n_pages)).astype(np.int32),
    )
    if trash_rows:
        case["table"][0] = 0
    cap = n_pages * ps
    case["position"] = (rs.randint(0, cap - tq + 1, (b,)) if position is None
                        else np.asarray(position)).astype(np.int32)
    return case


def _run_jax(case, dtype):
    pools = [jnp.asarray(case[k], dtype) for k in ("k_pool", "v_pool")]
    out, kp, vp = ppa.paged_attention(
        jnp.asarray(case["q"]), jnp.asarray(case["k_new"]),
        jnp.asarray(case["v_new"]), pools[0], pools[1],
        jnp.asarray(case["table"]), jnp.asarray(case["position"]),
        interpret=True)
    return [np.asarray(a, np.float32) for a in (out, kp, vp)]


def _run_port(case, dtype):
    dt = getattr(torch, dtype)
    pools = [torch.from_numpy(case[k]).to(dt) for k in ("k_pool", "v_pool")]
    out, kp, vp = tpa.paged_attention(
        torch.from_numpy(case["q"]), torch.from_numpy(case["k_new"]),
        torch.from_numpy(case["v_new"]), pools[0], pools[1],
        torch.from_numpy(case["table"]), torch.from_numpy(case["position"]))
    return [a.float().numpy() for a in (out, kp, vp)]


def _compare(case, dtype):
    ref = _run_jax(case, dtype)
    got = _run_port(case, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got[0], ref[0], rtol=tol, atol=tol)
    # the scatter is exact: the same tokens land in the same slots
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [1, 5])
def test_matches_jax_kernel(dtype, tq):
    rs = np.random.RandomState(0)
    _compare(_mk_case(rs, b=3, h=2, tq=tq, ch=16, ps=8, n_pages=8,
                      pool_pages=12), dtype)


@pytest.mark.parametrize("tq", [1, 5])
def test_bf16_q_over_f32_pool_matches_jax_kernel(tq):
    """The pair an f32 model's cached read gives under amp.init("bfloat16"):
    bf16 q, k_new and v_new over f32 pools. The new K/V are widened into the
    pools exactly; the read's scores are f32 from the widened q, its weights
    rounded to bf16 before their f32 product with v, and the output bf16,
    as the JAX kernel's ``out_shape`` (tolerance: bf16)."""
    rs = np.random.RandomState(8)
    case = _mk_case(rs, b=3, h=2, tq=tq, ch=16, ps=8, n_pages=8,
                    pool_pages=12, trash_rows=True)
    low = {k: np.asarray(jnp.asarray(case[k], jnp.bfloat16))
           for k in ("q", "k_new", "v_new")}
    out, kp, vp = ppa.paged_attention(
        *(jnp.asarray(low[k]) for k in ("q", "k_new", "v_new")),
        jnp.asarray(case["k_pool"]), jnp.asarray(case["v_pool"]),
        jnp.asarray(case["table"]), jnp.asarray(case["position"]),
        interpret=True)
    assert out.dtype == jnp.bfloat16
    args = [torch.from_numpy(np.asarray(low[k], np.float32)).bfloat16()
            for k in ("q", "k_new", "v_new")]
    pools = [torch.from_numpy(case[k].copy()) for k in ("k_pool", "v_pool")]
    got, tkp, tvp = tpa.paged_attention(
        *args, *pools, torch.from_numpy(case["table"]),
        torch.from_numpy(case["position"]))
    assert got.dtype == torch.bfloat16 and tkp.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(kp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(vp))


@pytest.mark.parametrize("tq", [1, 5])
def test_f16_q_over_f32_pool_matches_jax_kernel(tq):
    """The pair an f32 model's cached read gives under amp.init("float16"):
    f16 q, k_new and v_new over f32 pools. Both widen the new K/V into the
    pools exactly, round the f32 softmax weights to f16 before their f32
    product with v and return f16 (on a TPU the JAX gate sends f16 q to
    the gather path, which rounds the same weights and returns f32).
    Tolerance F16_TOL: f16 outputs whose f32 sums, in another order, round
    one ulp apart."""
    rs = np.random.RandomState(9)
    case = _mk_case(rs, b=3, h=2, tq=tq, ch=16, ps=8, n_pages=8,
                    pool_pages=12, trash_rows=True)
    low = {k: case[k].astype(np.float16) for k in ("q", "k_new", "v_new")}
    out, kp, vp = ppa.paged_attention(
        *(jnp.asarray(low[k]) for k in ("q", "k_new", "v_new")),
        jnp.asarray(case["k_pool"]), jnp.asarray(case["v_pool"]),
        jnp.asarray(case["table"]), jnp.asarray(case["position"]),
        interpret=True)
    assert out.dtype == jnp.float16
    args = [torch.from_numpy(low[k]) for k in ("q", "k_new", "v_new")]
    pools = [torch.from_numpy(case[k].copy()) for k in ("k_pool", "v_pool")]
    got, tkp, tvp = tpa.paged_attention(
        *args, *pools, torch.from_numpy(case["table"]),
        torch.from_numpy(case["position"]))
    assert got.dtype == torch.float16 and tkp.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32),
                               rtol=F16_TOL, atol=F16_TOL)
    np.testing.assert_array_equal(tkp.numpy(), np.asarray(kp))
    np.testing.assert_array_equal(tvp.numpy(), np.asarray(vp))


@pytest.mark.parametrize("ps,n_pages", [(6, 11), (8, 3)])
def test_matches_jax_ragged_final_page(ps, n_pages):
    """One row mid-page, one writing the LAST slot of the last page."""
    rs = np.random.RandomState(1)
    cap = ps * n_pages
    _compare(_mk_case(rs, b=2, h=2, tq=1, ch=16, ps=ps, n_pages=n_pages,
                      pool_pages=14, position=[ps + 2, cap - 1]), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_trash_page_rows(dtype):
    """A released row (all table slots 0) reads trash-page garbage."""
    rs = np.random.RandomState(2)
    _compare(_mk_case(rs, b=3, h=2, tq=1, ch=16, ps=8, n_pages=4,
                      pool_pages=10, trash_rows=True), dtype)


def test_overflow_tokens_go_to_trash_page():
    """Tokens past the table's capacity, several in one call, land in page
    0 and nowhere else; the read still matches JAX."""
    rs = np.random.RandomState(3)
    case = _mk_case(rs, b=2, h=2, tq=5, ch=16, ps=4, n_pages=2, pool_pages=6,
                    position=[6, 7])
    _compare(case, "float32")
    _, kp, _ = _run_port(case, "float32")
    live = np.unique(case["table"])
    untouched = [p for p in range(1, 7) if p not in live]
    np.testing.assert_array_equal(kp[untouched], case["k_pool"][untouched])


@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("ps", [8, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_equals_paged_bit_identical(tq, ps, dtype):
    """The same history in a dense (B, H, Tmax, Ch) buffer and in a paged
    pool gives bit-identical attention outputs and equal written K/V."""
    rs = np.random.RandomState(4)
    b, h, ch, tmax = 3, 2, 16, 40
    dt = getattr(torch, dtype)
    n_pages = -(-tmax // ps)
    hist_k = torch.from_numpy(rs.randn(b, h, tmax, ch).astype(np.float32)).to(dt)
    hist_v = torch.from_numpy(rs.randn(b, h, tmax, ch).astype(np.float32)).to(dt)
    # scatter the same histories into shuffled pages of a pool
    perm = rs.permutation(b * n_pages) + 1
    table = torch.from_numpy(perm.reshape(b, n_pages).astype(np.int32))
    k_pool = torch.from_numpy(rs.randn(b * n_pages + 1, h, ps, ch)
                              .astype(np.float32)).to(dt)
    v_pool = k_pool.clone()
    for row in range(b):
        for t in range(tmax):
            pid, off = int(table[row, t // ps]), t % ps
            k_pool[pid, :, off] = hist_k[row, :, t]
            v_pool[pid, :, off] = hist_v[row, :, t]
    q, k_new, v_new = (torch.from_numpy(rs.randn(b, h, tq, ch)
                                        .astype(np.float32)) for _ in range(3))
    position = torch.tensor([0, 17, tmax - tq], dtype=torch.int32)
    out_d, kb, _ = tatt._cached_mha(q, k_new, v_new, hist_k.clone(),
                                    hist_v.clone(), position)
    out_p, kp, _ = tatt._paged_cached_mha(q, k_new, v_new, k_pool, v_pool,
                                          table, position)
    assert torch.equal(out_d, out_p)
    for row in range(b):
        for t in range(int(position[row]), int(position[row]) + tq):
            assert torch.equal(kb[row, :, t],
                               kp[int(table[row, t // ps]), :, t % ps])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq", [1, 5])
def test_frontier_masked_attention_matches_jax(dtype, tq):
    """The plain cached read over contiguous histories against the JAX
    ``_frontier_masked_attention``; history past each frontier is garbage
    that must get a weight of exactly 0."""
    rs = np.random.RandomState(6)
    b, h, tmax, ch = 3, 2, 24, 16
    q, k, v = (rs.randn(b, h, n, ch).astype(np.float32)
               for n in (tq, tmax, tmax))
    position = np.array([0, 9, tmax - tq], np.int32)
    ref = jatt._frontier_masked_attention(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(position))
    dt = getattr(torch, dtype)
    got = tatt._frontier_masked_attention(
        torch.from_numpy(q).to(dt), torch.from_numpy(k).to(dt),
        torch.from_numpy(v).to(dt), torch.from_numpy(position))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_dense_write_past_end_is_clamped():
    """A finished row at position == Tmax writes into slot Tmax - 1 (the
    jax.lax.dynamic_update_slice clamp) instead of raising."""
    b, h, tmax, ch = 2, 2, 8, 16
    k_buf = torch.zeros(b, h, tmax, ch)
    v_buf = torch.zeros(b, h, tmax, ch)
    new = torch.ones(b, h, 1, ch)
    pos = torch.tensor([3, tmax], dtype=torch.int32)
    out, k_buf, _ = tatt._cached_mha(new, new, new, k_buf, v_buf, pos)
    assert torch.isfinite(out).all()
    assert torch.equal(k_buf[1, :, tmax - 1], torch.ones(h, ch))
    assert torch.equal(k_buf[0, :, 3], torch.ones(h, ch))


def test_knob_off_selects_plain_version():
    rs = np.random.RandomState(5)
    case = _mk_case(rs, b=2, h=2, tq=1, ch=16, ps=8, n_pages=4, pool_pages=8)
    args = [torch.from_numpy(case[k]) for k in
            ("q", "k_pool", "v_pool", "table", "position")]
    on = tatt._read(*args)
    tconfig.set("paged_attention_kernel", False)
    try:
        off = tatt._read(*args)
    finally:
        tconfig.set("paged_attention_kernel", True)
    assert torch.equal(on, off)


@pytest.mark.parametrize("tq,bh", [(1, 128), (1, 2), (16, 8), (128, 128),
                                   (512, 16)])
def test_split_plan_does_not_depend_on_page_size(tq, bh):
    """The split boundaries of a read are the same for the dense view of a
    1000-key cache (one page of Tmax per row) and for paged tables of the
    same history at page sizes 16 and 6: the same keys per split, and so the
    same live splits up to every frontier; the grid's splits cover each
    capacity."""
    tmax = 1000
    plans = {}
    for ps in (tmax, 16, 6):
        cap = -(-tmax // ps) * ps
        split_keys, n_splits = tpa._split_plan(cap, tq, bh)
        assert split_keys % 128 == 0 and n_splits >= 1
        assert n_splits == 1 or n_splits * split_keys >= cap
        # the live splits of a query tile whose last frontier is key f, as
        # the kernel counts them: splits 0 .. f // split_keys
        plans[ps] = [[(sp * split_keys, min((sp + 1) * split_keys, f + 1))
                      for sp in range(f // split_keys + 1)]
                     for f in range(tmax)]
    assert plans[16] == plans[tmax] == plans[6]


def test_split_plan_at_the_serving_shapes():
    """Decode at B=8 with 16 heads splits a 1024-key table in 8 splits of
    SPLIT_KEYS; a 512-query prefill chunk of one row already gives 1024
    (row, head, query tile) blocks and is not split."""
    assert tpa._split_plan(1024, 1, 8 * 16) == (tpa.SPLIT_KEYS, 8)
    assert tpa._split_plan(1024, 512, 16)[1] == 1


@pytest.mark.parametrize("tq", [1, 5])
def test_cpu_read_counts_no_launch(tq):
    """On CPU tensors the wrapper takes the plain version and launches
    nothing."""
    rs = np.random.RandomState(7)
    case = _mk_case(rs, b=2, h=2, tq=tq, ch=16, ps=8, n_pages=4, pool_pages=8)
    before = tpa.launches
    with torch.no_grad():
        out = tpa.paged_attention_read(*[torch.from_numpy(case[k]) for k in (
            "q", "k_pool", "v_pool", "table", "position")])
    assert tuple(out.shape) == (2, 2, tq, 16)
    assert tpa.launches == before


def test_wrapper_refuses_non_cuda_device():
    """The wrapper takes the plain version only for CPU tensors; any other
    device must launch the kernel or raise, never fall back."""
    q = torch.zeros(1, 2, 1, 16, device="meta")
    pool = torch.zeros(3, 2, 4, 16, device="meta")
    table = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        tpa.paged_attention_read(q, pool, pool, table, pos)

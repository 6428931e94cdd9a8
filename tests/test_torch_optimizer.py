"""The port's Adam (mxnet_tpu_torch.ops.optimizer and .optimizer) against
the JAX package: the fused Pallas kernel in interpret mode and the unfused
optimizer_ops.adam_update, on the same numpy inputs. Tolerances are those
of tests/test_pallas_optimizer.py: rtol 1e-6 / atol 1e-7 for one update,
1e-5 / 1e-6 for the 10-step trajectory."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ops import optimizer_ops as joo
from mxnet_tpu.ops import pallas_optimizer as jpo
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.ops import optimizer as too

HP = dict(beta1=0.9, beta2=0.999, epsilon=1e-8)
ONE = dict(rtol=1e-6, atol=1e-7)


def _mk(rs, shape):
    w = rs.randn(*shape).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    m = (rs.randn(*shape) * 0.1).astype(np.float32)
    v = (np.abs(rs.randn(*shape)) * 0.01).astype(np.float32)
    return w, g, m, v


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("shape", [(7,), (33, 5), (300, 129), (2, 3, 64)])
@pytest.mark.parametrize("clip", [-1.0, 2.0])
def test_plain_update_matches_jax(shape, clip):
    """Any rank and size, clip on and off, rescale 1.5, wd 0.01: in place,
    against the JAX fused kernel and the unfused chain."""
    w, g, m, v = _mk(np.random.RandomState(0), shape)
    lr_t, wd = np.float32(0.003), np.float32(0.01)
    kw = dict(wd=wd, rescale_grad=1.5, clip_gradient=clip, **HP)
    fused = jpo.adam_update_fused(*map(jnp.asarray, (w, g, m, v)), lr_t,
                                  interpret=True, **kw)
    chain = joo.adam_update(*map(jnp.asarray, (w, g, m, v)), lr_t,
                            HP["beta1"], HP["beta2"], HP["epsilon"], wd, 1.5,
                            clip)
    tw, tg, tm, tv = _t(w, g, m, v)
    out = too.adam_update(tw, tg, tm, tv, torch.tensor(lr_t), HP["beta1"],
                          HP["beta2"], HP["epsilon"], torch.tensor(wd), 1.5,
                          clip)
    assert out[0] is tw and out[1] is tm and out[2] is tv  # in place
    for got, a, b, name in zip((tw, tm, tv), fused, chain, "wmv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(a), err_msg=name,
                                   **ONE)
        np.testing.assert_allclose(got.numpy(), np.asarray(b), err_msg=name,
                                   **ONE)


def test_multi_tensor_update_matches_jax_per_tensor():
    """One call over odd-sized tensors with per-tensor lr and wd (a bf16
    gradient and a bf16 weight copy among them) equals the JAX fused
    kernel run tensor by tensor."""
    rs = np.random.RandomState(1)
    shapes = [(7,), (65, 17), (129, 33), (1,), (3, 3, 3)]
    data = [_mk(rs, s) for s in shapes]
    lrs = np.array([0.001, 0.003, 0.0, 0.01, 0.002], np.float32)
    wds = np.array([0.0, 0.01, 0.02, 0.0, 0.1], np.float32)
    bf16_grad = {1, 3}
    ws, gs, ms, vs, lows = [], [], [], [], []
    for i, (w, g, m, v) in enumerate(data):
        tw, tg, tm, tv = _t(w, g, m, v)
        ws.append(tw)
        gs.append(tg.to(torch.bfloat16) if i in bf16_grad else tg)
        ms.append(tm)
        vs.append(tv)
        lows.append(torch.empty(w.shape, dtype=torch.bfloat16)
                    if i % 2 == 0 else None)
    too.adam_update_fused(ws, gs, ms, vs, torch.from_numpy(lrs),
                          torch.from_numpy(wds), rescale_grad=0.5,
                          clip_gradient=1.0, out_lows=lows, **HP)
    for i, (w, g, m, v) in enumerate(data):
        jg = jnp.asarray(g, jnp.bfloat16) if i in bf16_grad else jnp.asarray(g)
        ref = jpo.adam_update_fused(
            jnp.asarray(w), jg, jnp.asarray(m), jnp.asarray(v),
            jnp.float32(lrs[i]), wd=jnp.float32(wds[i]), rescale_grad=0.5,
            clip_gradient=1.0, out_dtype=jnp.bfloat16, interpret=True, **HP)
        for got, r, name in zip((ws[i], ms[i], vs[i]), ref, "wmv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                       err_msg=f"{name}{i}", **ONE)
        if lows[i] is not None:  # the one-pass copy: bit-equal to the cast
            np.testing.assert_array_equal(
                lows[i].float().numpy(), np.asarray(ref[3], np.float32))


def test_ten_step_trajectory_matches_jax():
    """10 plain multi-tensor steps track 10 JAX fused steps (1e-5 / 1e-6)."""
    rs = np.random.RandomState(3)
    w, _, m, v = _mk(rs, (50, 30))
    jw, jm, jv = map(jnp.asarray, (w, m, v))
    tw, tm, tv = _t(w, m, v)
    for t in range(1, 11):
        g = rs.randn(50, 30).astype(np.float32)
        lr_t = np.float32(0.01 * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t))
        jw, jm, jv = jpo.adam_update_fused(jw, jnp.asarray(g), jm, jv, lr_t,
                                           wd=jnp.float32(0.01),
                                           interpret=True, **HP)
        too.adam_update_fused([tw], [torch.from_numpy(g)], [tm], [tv],
                              float(lr_t), 0.01, **HP)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)


def test_lr_t_matches_jax():
    """The bias-corrected rate, f32, for t = 1..10, from an int and from a
    device-style int tensor (rtol 1e-6)."""
    ja = jopt.Adam(learning_rate=3e-4)
    ta = topt.Adam(learning_rate=3e-4)
    lr = np.float32(3e-4)
    for t in range(1, 11):
        ref = np.asarray(ja._lr_t(jnp.float32(lr), jnp.int32(t)))
        for tt in (t, torch.tensor(t, dtype=torch.int32)):
            got = ta._lr_t(torch.tensor(lr), tt)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_adam_update_raw_and_state_match_jax():
    rs = np.random.RandomState(4)
    w, g, _, _ = _mk(rs, (17, 9))
    ja, ta = jopt.Adam(learning_rate=0.01, wd=0.0), topt.Adam(learning_rate=0.01)
    js = ja.create_state(0, jnp.asarray(w))
    tw = torch.from_numpy(w.copy())
    ts = ta.create_state(0, tw)
    assert all(s.dtype == torch.float32 and not s.any() for s in ts)
    jw = jnp.asarray(w)
    for t in (1, 2, 3):
        jw, js = ja.update_raw(jw, jnp.asarray(g * t), js, jnp.float32(0.01),
                               jnp.float32(0.001), jnp.int32(t))
        out, ts = ta.update_raw(tw, torch.from_numpy(g * t), ts,
                                torch.tensor(0.01), 0.001,
                                torch.tensor(t, dtype=torch.int32))
        assert out is tw
    for got, ref in zip((tw,) + tuple(ts), (jw,) + tuple(js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ONE)


def test_update_raw_multi_knob_on_and_off_agree_on_cpu():
    """fused_adam on (the default) and off give the same update on the CPU,
    where both run the plain version."""
    rs = np.random.RandomState(5)
    data = [_mk(rs, s) for s in ((5, 4), (11,))]
    results = []
    for on in (True, False):
        tconfig.set("fused_adam", on)
        try:
            opt = topt.Adam(learning_rate=0.01, clip_gradient=0.5)
            ws = [torch.from_numpy(d[0].copy()) for d in data]
            st = [opt.create_state(i, w) for i, w in enumerate(ws)]
            opt.update_raw_multi(ws, [torch.from_numpy(d[1]) for d in data],
                                 st, torch.tensor([0.01, 0.02]),
                                 torch.tensor([0.0, 0.1]),
                                 torch.tensor(1, dtype=torch.int32))
            results.append(ws)
        finally:
            tconfig.set("fused_adam", True)
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("opt_name", ["adam", "adamw"])
def test_update_raw_multi_scale_and_skip_knob_on_and_off(opt_name, skip):
    """``inv_scale``, ``skip`` and the low-precision copies through
    ``update_raw_multi``: Adam with ``fused_adam`` on and off (both plain on
    the CPU) gives the same tensors; a set skip leaves every weight, moment
    and copy bit-unchanged, for Adam and for AdamW's clone-and-restore."""
    rs = np.random.RandomState(8)
    data = [_mk(rs, s) for s in ((6, 3), (13,))]
    results = []
    for on in (True, False):
        tconfig.set("fused_adam", on)
        try:
            opt = topt.create(opt_name, learning_rate=0.01, wd=0.1)
            ws = [torch.from_numpy(d[0].copy()) for d in data]
            st = [opt.create_state(i, w) for i, w in enumerate(ws)]
            lows = [w.to(torch.bfloat16) for w in ws]
            before = [t.clone() for t in ws + lows + [x for s in st for x in s]]
            opt.update_raw_multi(
                ws, [torch.from_numpy(d[1] * 64).half() for d in data], st,
                torch.tensor([0.01, 0.02]), torch.tensor([0.1, 0.0]),
                torch.tensor(1, dtype=torch.int32), out_lows=lows,
                inv_scale=torch.tensor(1 / 64), skip=torch.tensor(
                    skip, dtype=torch.int32))
            after = ws + lows + [x for s in st for x in s]
            assert all(torch.equal(a, b) for a, b in zip(before, after)) \
                == bool(skip)
            results.append(after)
        finally:
            tconfig.set("fused_adam", True)
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_training_knobs_default_on_with_env_aliases(monkeypatch):
    monkeypatch.setattr(tconfig, "_values", {})  # no in-process overrides
    for name in ("fused_adam", "flash_attention", "flash_pallas_bwd"):
        assert tconfig.get(name) is True
        monkeypatch.setenv(f"MXNET_TPU_{name.upper()}", "0")
        assert tconfig.get(name) is False


def test_kernel_wrapper_refuses_non_cuda_tensors():
    w = torch.zeros(8, device="meta")
    with pytest.raises(MXNetError, match="CUDA"):
        too.adam_update_fused([w], [w], [w], [w], 0.1, 0.0)


def test_create_and_register():
    opt = topt.create("adam", learning_rate=0.5, beta1=0.8)
    assert isinstance(opt, topt.Adam) and opt.learning_rate == 0.5
    assert topt.create(opt) is opt
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.create("nope")
    # multi_precision serves the imperative gluon.Trainer (f32 masters in
    # the optimizer state); TrainStep keeps its own f32 masters
    assert topt.Adam(multi_precision=True).multi_precision is True


def test_inverse_scale_and_f16_gradients_match_jax():
    """Float16 loss scaling: an f16 gradient of the scaled loss, times the
    inverse scale, then Adam, as the JAX TrainStep unscales (g · 1/scale
    in f32, then rescale_grad); bf16 and f16 copies are the rounding of
    the new weight."""
    rs = np.random.RandomState(6)
    shapes = [(7,), (65, 17), (3, 3, 3)]
    data = [_mk(rs, s) for s in shapes]
    scale = np.float32(1024.0)
    inv = np.float32(1.0) / scale
    ws, gs, ms, vs, lows = [], [], [], [], []
    for i, (w, g, m, v) in enumerate(data):
        tw, tg, tm, tv = _t(w, g * scale, m, v)
        ws.append(tw)
        gs.append(tg.half())
        ms.append(tm)
        vs.append(tv)
        lows.append(torch.empty(w.shape, dtype=(torch.float16, torch.bfloat16,
                                                torch.float16)[i]))
    too.adam_update_fused(ws, gs, ms, vs, 0.003, 0.01, rescale_grad=0.5,
                          out_lows=lows, inv_scale=torch.tensor(inv), **HP)
    for i, (w, g, m, v) in enumerate(data):
        g16 = (g * scale).astype(np.float16).astype(np.float32)
        ref = jpo.adam_update_fused(
            jnp.asarray(w), jnp.asarray(g16) * inv, jnp.asarray(m),
            jnp.asarray(v), jnp.float32(0.003), wd=jnp.float32(0.01),
            rescale_grad=0.5, interpret=True, **HP)
        for got, r, name in zip((ws[i], ms[i], vs[i]), ref, "wmv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(r),
                                       err_msg=f"{name}{i}", **ONE)
        assert torch.equal(lows[i], ws[i].to(lows[i].dtype))


@pytest.mark.parametrize("fused", [True, False], ids=["multi", "per_tensor"])
def test_skip_flag_leaves_everything_bit_unchanged(fused):
    """A nonzero skip writes nothing (weights, moments, copies), whatever
    the gradient holds; a zero skip is a normal update."""
    rs = np.random.RandomState(7)
    w, g, m, v = _mk(rs, (40, 9))
    g[0, 0] = np.inf
    tw, tg, tm, tv = _t(w, g, m, v)
    low = tw.to(torch.bfloat16)
    keep = [t.clone() for t in (tw, tm, tv, low)]
    for skip in (torch.tensor(1, dtype=torch.int32), torch.tensor(True)):
        if fused:
            too.adam_update_fused([tw], [tg], [tm], [tv], 0.01, 0.0,
                                  out_lows=[low], skip=skip,
                                  inv_scale=torch.tensor(0.5), **HP)
        else:
            too.adam_update(tw, tg, tm, tv, 0.01, out_low=low, skip=skip,
                            inv_scale=torch.tensor(0.5), **HP)
        for a, b in zip(keep, (tw, tm, tv, low)):
            assert torch.equal(a, b)
    g[0, 0] = 1.0
    tg = torch.from_numpy(g)
    too.adam_update(tw, tg, tm, tv, 0.01, out_low=low,
                    skip=torch.tensor(0, dtype=torch.int32), **HP)
    ref = _t(w, g, m, v)
    too.adam_update(ref[0], ref[1], ref[2], ref[3], 0.01, **HP)
    for a, b in zip((tw, tm, tv), ref[:1] + ref[2:]):
        assert torch.equal(a, b)
    assert torch.equal(low, tw.to(torch.bfloat16))


def test_kernel_table_flags_for_f16_gradients_and_copies():
    """A table row's flags carry the gradient's and the copy's dtypes."""
    w = torch.zeros(5)
    got = [too._flags(g, low) for g, low in (
        (w, None), (w.bfloat16(), w.bfloat16()), (w.half(), w.half()),
        (w, w.half()))]
    assert got == [0, too._FLAG_G_BF16, too._FLAG_G_F16 | too._FLAG_LOW_F16,
                   too._FLAG_LOW_F16]

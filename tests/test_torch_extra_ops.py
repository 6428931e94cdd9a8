"""The port's ``ops/extra.py`` (every op of ``mxnet_tpu/ops/extra.py``, by
name) against the JAX package's on the same seeded numpy inputs: values,
and gradients against a seeded cotangent for each differentiable input
named in the case. Also the registered aliases through ``mx.nd``, the AMP
graph ops under both packages' ``amp.init``, and ``bincount``'s refusal
inside a captured step.

Tolerances: f32 values 1e-5 relative (1e-6 absolute), gradients 1e-5;
bf16 casts exact."""
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
from mxnet_tpu_torch.ops import extra as tex

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _f(shape, seed, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _i(values):
    return np.asarray(values, np.int32)


SEQ = _f((5, 3, 2), 1)
LENS = np.array([5, 2, 1], np.float32)
NCHW = _f((2, 6, 3, 4), 2)
IMG = _f((2, 3, 7, 8), 3)
GRID = _f((2, 2, 4, 4), 4, -1.2, 1.2)
LOC = (np.array([1, 0.1, 0, -0.1, 0.9, 0.05], np.float32)[None]
       + _f((2, 6), 5, -0.1, 0.1))

# name -> (inputs, params, indices of the inputs to differentiate)
CASES = {
    "hard_sigmoid": ([_f((4, 5), 10, -4, 4)], {}, (0,)),
    "softmin": ([_f((4, 5), 11)], {"axis": 0}, (0,)),
    "relu6": ([_f((4, 5), 12, -3, 9)], {}, (0,)),
    "selu": ([_f((4, 5), 13)], {}, (0,)),
    "gelu": ([_f((4, 5), 14)], {}, (0,)),
    "softrelu": ([_f((4, 5), 15, -25, 25)], {}, (0,)),
    "log_sigmoid": ([_f((4, 5), 16, -6, 6)], {}, (0,)),
    "logsumexp": ([_f((2, 3, 4), 17)], {"axis": (0, 2), "keepdims": True},
                  (0,)),
    "logsumexp-all": ([_f((2, 3, 4), 17)], {}, (0,)),
    "SequenceLast": ([SEQ, LENS], {"use_sequence_length": True}, (0,)),
    "SequenceLast-ntc": ([SEQ.transpose(1, 0, 2).copy(), LENS],
                         {"use_sequence_length": True, "axis": 1}, (0,)),
    "SequenceLast-nolen": ([SEQ], {}, (0,)),
    "SequenceReverse": ([SEQ, LENS], {"use_sequence_length": True}, (0,)),
    "SequenceReverse-ntc": ([SEQ.transpose(1, 0, 2).copy(), LENS],
                            {"use_sequence_length": True, "axis": 1}, (0,)),
    "SequenceReverse-nolen": ([SEQ], {}, (0,)),
    "GroupNorm": ([NCHW, _f((3,), 20), _f((3,), 21)], {"num_groups": 3},
                  (0, 1, 2)),
    "GroupNorm-channel": ([NCHW, _f((6,), 22), _f((6,), 23)],
                          {"num_groups": 2, "eps": 1e-3}, (0, 1, 2)),
    "LRN": ([_f((2, 7, 3, 3), 24)], {}, (0,)),
    "LRN-4": ([_f((2, 7, 3, 3), 24)], {"nsize": 4, "alpha": 1e-2,
                                       "beta": 0.5, "knorm": 1.0}, (0,)),
    "GridGenerator": ([LOC], {"target_shape": (4, 5)}, (0,)),
    "GridGenerator-warp": ([_f((2, 2, 4, 5), 25)],
                           {"transform_type": "warp"}, (0,)),
    "BilinearSampler": ([IMG[:, :, :5, :6].copy(), GRID], {}, (0, 1)),
    "SpatialTransformer": ([IMG[:, :, :5, :6].copy(), LOC],
                           {"target_shape": (4, 4)}, (0, 1)),
    "batch_take": ([_f((3, 4), 26), _i([1, -1, 7])], {}, ()),
    "khatri_rao": ([_f((3, 4), 27), _f((2, 4), 28), _f((2, 4), 29)], {},
                   (0, 1, 2)),
    "unravel_index": ([_i([5, -1, 30, 0])], {"shape": (3, 4)}, ()),
    "ravel_multi_index": ([_i([[0, 2, 1, 2], [3, 0, 1, 2]])],
                          {"shape": (3, 4)}, ()),
    "split_v2": ([_f((6, 4), 30)], {"indices_or_sections": (1, 4)}, (0,)),
    "split_v2-sections": ([_f((6, 4), 31)],
                          {"indices_or_sections": 4, "axis": 1,
                           "squeeze_axis": True}, (0,)),
    "moments": ([_f((2, 3, 4), 32)], {"axes": (0, 2), "keepdims": True},
                (0,)),
    "moments-all": ([_f((2, 3, 4), 33)], {}, (0,)),
    "Correlation": ([IMG, _f((2, 3, 7, 8), 34)],
                    {"max_displacement": 1, "stride1": 2, "pad_size": 1},
                    (0, 1)),
    "Correlation-abs": ([IMG, _f((2, 3, 7, 8), 35)],
                        {"max_displacement": 2, "stride2": 2,
                         "is_multiply": False}, ()),
    "all_finite": ([np.array([1.0, np.inf], np.float32)], {}, ()),
    "all_finite-ok": ([_f((3,), 36)], {}, ()),
    "multi_all_finite": ([_f((3,), 37), np.array([np.nan], np.float32)],
                         {"num_arrays": 2}, ()),
    "multi_all_finite-ok": ([_f((3,), 37), _f((2, 2), 38)], {}, ()),
    "_sharding_constraint": ([_f((4, 2), 39)], {"spec": ("data", None)},
                             (0,)),
    "add_n": ([_f((3, 2), 40), _f((3, 2), 41), _f((3, 2), 42)], {},
              (0, 1, 2)),
    "argmax_channel": ([_f((3, 5, 2), 43)], {}, ()),
    "shape_array": ([_f((3, 5, 2), 44)], {}, ()),
    "size_array": ([_f((3, 5, 2), 44)], {}, ()),
    "im2col": ([IMG], {"kernel": (3, 3), "stride": (2, 1),
                       "dilate": (1, 2), "pad": (1, 1)}, (0,)),
    "im2col-1d": ([_f((2, 3, 9), 45)], {"kernel": (3,), "stride": (2,),
                                        "pad": (1,)}, (0,)),
    "col2im": ([_f((2, 27, 24), 46)],
               {"output_size": (7, 8), "kernel": (3, 3), "stride": (2, 1),
                "dilate": (1, 2), "pad": (1, 1)}, (0,)),
    "quantize": ([_f((4, 5), 47, -3, 3), np.float32(-2.0),
                  np.float32(2.5)], {}, ()),
    "quantize-int8": ([_f((4, 5), 47, -3, 3), np.float32(-2.0),
                       np.float32(2.5)], {"out_type": "int8"}, ()),
    "quantize_v2": ([_f((4, 5), 48, -3, 3)], {}, ()),
    "quantize_v2-calib": ([_f((4, 5), 48, -3, 3)],
                          {"out_type": "uint8", "min_calib_range": -1.0,
                           "max_calib_range": 2.0}, ()),
    "dequantize": ([np.arange(0, 250, 10, dtype=np.uint8), np.float32(-1.0),
                    np.float32(3.0)], {}, ()),
    "dequantize-int8": ([np.arange(-120, 125, 10).astype(np.int8),
                         np.float32(-1.0), np.float32(3.0)], {}, ()),
    "bincount": ([_i([1, 2, 2, 5, 0])], {}, ()),
    "bincount-weights": ([_i([1, 2, 2, 5, 0]), _f((5,), 49)],
                         {"minlength": 9}, ()),
    "onehot_encode": ([np.array([0, 2, 5], np.float32),
                       np.zeros((3, 4), np.float32)], {}, ()),
    "choose_element_0index": ([_f((3, 4), 50), _i([1, -1, 7])], {}, (0,)),
    "fill_element_0index": ([_f((3, 4), 51), _f((3,), 52), _i([1, -1, 7])],
                            {}, (0, 1)),
    "amp_cast": ([_f((3, 4), 53)], {"dtype": "float16"}, (0,)),
    "amp_cast-int": ([_i([1, 2])], {"dtype": "float16"}, ()),
    "amp_multicast": ([_f((2,), 54).astype(np.float16), _f((2,), 55),
                       _i([3, 4])], {"num_outputs": 3}, ()),
}


def _extra_names():
    """The primary names mxnet_tpu/ops/extra.py registers."""
    return sorted({op.name for op in jreg._REGISTRY.values()
                   if op.fn.__module__ == "mxnet_tpu.ops.extra"})


def test_every_extra_op_has_a_case():
    covered = {c.split("-")[0] for c in CASES}
    assert set(_extra_names()) <= covered


def _host(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    x = np.asarray(x)
    return x


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _close(got, want, what, tol=F32):
    got, want = _as_list(got), _as_list(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = _host(g), _host(w)
        assert g.shape == w.shape, (what, g.shape, w.shape)
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, err_msg=what, equal_nan=True, **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_extra_op_matches_jax(case):
    name = case.split("-")[0]
    inputs, params, diff = CASES[case]
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn
    t_in = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        t_in[i].requires_grad_(True)
    tout = tfn(*t_in, **params)
    if not diff:
        _close(tout, jfn(*[jnp.asarray(a) for a in inputs], **params), case)
        return

    def jf(*d):
        args = [jnp.asarray(a) for a in inputs]
        for i, v in zip(diff, d):
            args[i] = v
        return _as_list(jfn(*args, **params))

    jout, vjp = jax.vjp(jax.jit(jf), *[jnp.asarray(inputs[i]) for i in diff])
    _close(tout, jout, case)
    cots = [np.asarray(np.random.RandomState(99 + k).randn(*np.shape(o)),
                       np.asarray(o).dtype) for k, o in enumerate(jout)]
    jg = vjp([jnp.asarray(c) for c in cots])
    torch.autograd.backward(
        [o for o in _as_list(tout)],
        [torch.from_numpy(c) for c in cots])
    for i, g in zip(diff, jg):
        _close(t_in[i].grad, g, f"{case} d{i}", GRAD)


@pytest.mark.parametrize("name,alias", [
    ("SequenceLast", "sequence_last"), ("SequenceReverse",
                                        "sequence_reverse"),
    ("GroupNorm", "group_norm"), ("LRN", "lrn"),
    ("unravel_index", "_unravel_index"),
    ("ravel_multi_index", "_ravel_multi_index"), ("split_v2", "_split_v2"),
    ("add_n", "ElementWiseSum")])
def test_aliases_through_nd(name, alias):
    assert treg.get(alias) is treg.get(name)
    case = next(c for c in sorted(CASES) if c.split("-")[0] == name)
    inputs, params, _ = CASES[case]
    want = getattr(jnd, alias)(*[jnd.array(a) for a in inputs], **params)
    with tmx.cpu():
        got = getattr(tnd, alias)(*[tnd.array(a) for a in inputs], **params)
    _close([g.asnumpy() for g in _as_list(got)],
           [w.asnumpy() for w in _as_list(want)], alias)


def test_amp_cast_bf16_and_multicast_widest():
    x = _f((3, 4), 60)
    got = treg.get("amp_cast").fn(torch.from_numpy(x), dtype="bfloat16")
    want = jreg.get("amp_cast").fn(jnp.asarray(x), dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    t = treg.get("amp_multicast").fn(got, got.half())
    j = jreg.get("amp_multicast").fn(want, want.astype(jnp.float16))
    assert [a.dtype for a in t] == [torch.float32] * 2
    assert [str(a.dtype) for a in j] == ["float32"] * 2
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_amp_ops_under_amp_init():
    """Under both packages' amp.init("bfloat16") an LP16 op (dot) gives f32
    from bf16-rounded operands; amp_cast to bf16 and amp_multicast back to
    the widest dtype hold the same values in both."""
    from mxnet_tpu.contrib import amp as jamp
    from mxnet_tpu_torch.contrib import amp as tamp

    x, w = _f((4, 8), 61), _f((8, 3), 62)
    jamp.init("bfloat16")
    tamp.init("bfloat16")
    try:
        jd = jnd.dot(jnd.array(x), jnd.array(w))
        jc = jnd.amp_cast(jd, dtype="bfloat16")
        jm = jnd.amp_multicast(jc, jd, num_outputs=2)
        with tmx.cpu():
            td = tnd.dot(tnd.array(x), tnd.array(w))
            tc = tnd.amp_cast(td, dtype="bfloat16")
            tm = tnd.amp_multicast(tc, td, num_outputs=2)
        assert "linalg_gemm2" in tamp.list_lp16_ops()
        assert td.dtype == np.float32 and tc.dtype == torch.bfloat16
        np.testing.assert_allclose(td.asnumpy(), jd.asnumpy(), **F32)
        np.testing.assert_array_equal(tc.asnumpy(), jc.asnumpy())
        for a, b in zip(tm, jm):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **F32)
    finally:
        jamp._reset()
        tamp._reset()


def test_bincount_refuses_a_captured_step(monkeypatch):
    """bincount reads its length on the host: inside a capture it raises
    instead of syncing."""
    monkeypatch.setattr(tex, "_capturing", lambda: True)
    with pytest.raises(tmx.MXNetError, match="captured step"):
        tex.bincount(torch.tensor([1, 2, 2], dtype=torch.int32))


def test_im2col_is_channel_major_and_col2im_its_adjoint():
    """Column c*kh*kw + i*kw + j of im2col holds channel c at window offset
    (i, j); <im2col(x), y> == <x, col2im(y)>."""
    x = _f((1, 2, 4, 4), 63)
    cols = tex.im2col(torch.from_numpy(x), (2, 3)).numpy()
    np.testing.assert_array_equal(cols[0, 1 * 6 + 1 * 3 + 2, 0], x[0, 1, 1, 2])
    y = _f(cols.shape, 64)
    back = tex.col2im(torch.from_numpy(y), (4, 4), (2, 3)).numpy()
    np.testing.assert_allclose((cols * y).sum(), (x * back).sum(), rtol=1e-5)

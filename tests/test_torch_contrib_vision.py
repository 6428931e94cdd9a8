"""The port's detection operators (``mxnet_tpu_torch/ops/contrib_vision.py``)
against the JAX package's (``mxnet_tpu/ops/contrib_vision.py``) on the
same numpy inputs: ``MultiBoxPrior``, ``box_iou``, ``box_nms``,
``MultiBoxDetection``, ``MultiBoxTarget``, ``ROIAlign`` and
``DeformableConvolution`` (values and, for the last two, the gradients of
every input), ``index_array`` and ``getnnz``; ``ROIPooling`` against a
numpy loop of MXNet's integer-bin rule (``roi_pooling.cc``), forward and
backward, since the JAX op under-samples its bins.

Tolerances: anchors, integer outputs, NMS keep sets, ``cls_target`` and
``loc_mask`` exactly equal (ties included: both sorts are stable, and a
shared best anchor goes to the last ground truth); f32 values rtol 1e-5,
atol 1e-6; gradients of the sampled ops rtol 1e-5, atol 1e-5 (their sums
run in another order). Offsets and rois are drawn so that no sample lands
on an integer or a map border, where ``floor``/``clip`` gradients are
conventions."""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import registry as jreg
from mxnet_tpu.ops import contrib_vision as J
from mxnet_tpu_torch import registry as treg
from mxnet_tpu_torch.ops import contrib_vision as T

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)
NAMES = ("_contrib_ROIAlign", "_contrib_DeformableConvolution",
         "_contrib_MultiBoxPrior", "_contrib_box_iou", "_contrib_box_nms",
         "_contrib_MultiBoxDetection", "_contrib_index_array",
         "_contrib_getnnz", "_contrib_MultiBoxTarget", "ROIPooling",
         "roi_pooling", "_contrib_quantized_fully_connected",
         "quantized_fully_connected", "_contrib_quantized_conv",
         "quantized_conv")


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _jit(fn, **kw):
    """The JAX op with its parameters bound, compiled once (eager JAX
    dispatches every primitive on its own)."""
    return jax.jit(functools.partial(fn, **kw))


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def _close(got, want, tol=F32):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **tol)


def _equal(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_registered_with_jax_names_parameters_and_nout(name):
    j, t = jreg.get(name), treg.get(name)
    assert t.nout == j.nout and set(t.aliases) == set(j.aliases)
    assert inspect.signature(t.fn) == inspect.signature(j.fn)


def test_registry_lacks_only_the_quantized_ops():
    """The quantized ops were the last JAX names the port lacked; with
    ``contrib/quantization.py`` ported the registry lacks none."""
    missing = sorted(set(jreg.list_ops()) - set(treg.list_ops()))
    assert missing == []
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "box_nms", "box_iou", "ROIAlign", "DeformableConvolution",
                 "index_array", "getnnz"):
        assert callable(getattr(tmx.nd.contrib, name))
    assert tmx.nd.ROIPooling is not None and tmx.nd.roi_pooling is not None


PRIORS = [((2, 3, 16, 16), dict(sizes=(0.2, 0.27), ratios=(1.0, 2.0, 0.5))),
          ((1, 8, 5, 7), dict(sizes=(0.5,), ratios=(1.0, 3.0), clip=True)),
          ((1, 2, 4, 6), dict(sizes=(0.3, 0.6), steps=(0.25, 0.2),
                              offsets=(0.3, 0.7)))]


@pytest.mark.parametrize("shape,kw", PRIORS)
def test_multibox_prior_is_bit_equal(shape, kw):
    x = np.zeros(shape, np.float32)
    _equal(T.multibox_prior(*_t(x), **kw),
           _jit(J.multibox_prior, **kw)(*_j(x)))
    # made once, then read
    assert T.multibox_prior(*_t(x), **kw) is T.multibox_prior(*_t(x), **kw)


def _boxes(rs, n, batch=()):
    b = rs.rand(*batch, n, 4).astype(np.float32)
    b[..., 2:] = b[..., :2] + rs.rand(*batch, n, 2).astype(np.float32) * 0.5
    return b


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(0)
    lhs, rhs = _boxes(rs, 7), _boxes(rs, 9)
    _close(T.box_iou(*_t(lhs, rhs), format=fmt),
           _jit(J.box_iou, format=fmt)(*_j(lhs, rhs)))
    lhs, rhs = _boxes(rs, 5, (3,)), _boxes(rs, 4, (3,))
    _close(T.box_iou(*_t(lhs, rhs), format=fmt),
           _jit(J.box_iou, format=fmt)(*_j(lhs, rhs)))


def _nms_rows(seed=0, batch=2, n=40):
    """[id, score, box] rows with tied scores (a few values only) and
    overlapping boxes."""
    rs = np.random.RandomState(seed)
    rows = np.zeros((batch, n, 6), np.float32)
    rows[..., 0] = rs.randint(0, 3, (batch, n))
    rows[..., 1] = rs.choice([0.0, 0.3, 0.5, 0.5, 0.8, 0.9], (batch, n))
    rows[..., 2:] = _boxes(rs, n, (batch,))
    return rows


NMS_CASES = [dict(), dict(topk=10), dict(id_index=0),
             dict(id_index=0, force_suppress=True),
             dict(id_index=0, background_id=1, valid_thresh=0.4, topk=12),
             dict(overlap_thresh=0.2, out_format="center"),
             dict(in_format="center", out_format="corner", topk=7)]


@pytest.mark.parametrize("kw", NMS_CASES, ids=[str(k) for k in NMS_CASES])
def test_box_nms_with_ties(kw):
    rows = _nms_rows()
    want = np.asarray(_jit(J.box_nms, **kw)(*_j(rows)))
    got = T.box_nms(*_t(rows), **kw).numpy()
    # the kept set and the order are exact; ties keep index order
    np.testing.assert_array_equal(got[..., 1] >= 0, want[..., 1] >= 0)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    _close(got, want)
    one = T.box_nms(*_t(rows[0]), **kw).numpy()
    np.testing.assert_array_equal(one, got[0])


def _detection_inputs(seed=1, n=3, classes=4, a=60):
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, a, (1,))
    prob = rs.rand(n, classes, a).astype(np.float32)
    prob /= prob.sum(1, keepdims=True)
    loc = (rs.randn(n, a * 4) * 0.5).astype(np.float32)
    return prob, loc, anchors


DET_CASES = [dict(), dict(nms_topk=15), dict(threshold=0.3,
                                             force_suppress=True),
             dict(background_id=2, clip=False, nms_threshold=0.3)]


@pytest.mark.parametrize("kw", DET_CASES, ids=[str(k) for k in DET_CASES])
def test_multibox_detection(kw):
    ins = _detection_inputs()
    want = np.asarray(_jit(J.multibox_detection, **kw)(*_j(*ins)))
    got = T.multibox_detection(*_t(*ins), **kw).numpy()
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    _close(got, want)


def _target_inputs(seed=2, n=3, a=50, classes=3):
    rs = np.random.RandomState(seed)
    anchors = _boxes(rs, a, (1,))
    labels = np.full((n, 3, 5), -1.0, np.float32)
    labels[:, 0] = [0, 0.1, 0.1, 0.4, 0.4]
    labels[1, 1] = [1, 0.5, 0.5, 0.9, 0.9]
    labels[2, :2] = [[1, 0.0, 0.0, 0.3, 0.3], [0, 0.3, 0.3, 0.6, 0.7]]
    # background probabilities from a few values: mining ranks ties
    bg = rs.choice([0.1, 0.2, 0.2, 0.35, 0.6], (n, a)).astype(np.float32)
    prob = np.stack([bg] + [(1 - bg) / (classes - 1)] * (classes - 1), 1)
    return anchors, labels, prob.astype(np.float32)


TARGET_CASES = [dict(), dict(negative_mining_ratio=3.0),
                dict(negative_mining_ratio=1.5, minimum_negative_samples=2,
                     negative_mining_thresh=0.3, ignore_label=-2.0),
                dict(overlap_threshold=0.3, negative_mining_ratio=0.7,
                     variances=(0.2, 0.2, 0.5, 0.5))]


@pytest.mark.parametrize("kw", TARGET_CASES,
                         ids=[str(k) for k in TARGET_CASES])
def test_multibox_target(kw):
    ins = _target_inputs()
    want = _jit(J.multibox_target, **kw)(*_j(*ins))
    got = T.multibox_target(*_t(*ins), **kw)
    _close(got[0], want[0])
    _equal(got[1], want[1])
    _equal(got[2], want[2])


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_multibox_target_shared_best_anchor_goes_to_the_last_row(order):
    anchors = np.array([[[0, 0, 1, 1], [0.95, 0.95, 1, 1]]], np.float32)
    gts = np.array([[0, 0, 0, 0.3, 0.3], [1, 0.5, 0.5, 0.9, 0.9]],
                   np.float32)
    labels = gts[list(order)][None]
    prob = np.full((1, 2, 2), 0.5, np.float32)
    want = _jit(J.multibox_target)(*_j(anchors, labels, prob))
    got = T.multibox_target(*_t(anchors, labels, prob))
    _equal(got[2], want[2])
    _equal(got[1], want[1])
    _close(got[0], want[0])
    # the anchor both name goes to the last row's class (+1)
    last = 2.0 if order == (0, 1) else 1.0
    assert got[2].tolist() == [[last, 0.0]]


def test_index_array_and_getnnz():
    x = (np.random.RandomState(3).rand(3, 4, 5) > 0.5).astype(np.float32)
    for axes in (None, (2, 0), (1,)):
        _equal(T.index_array(*_t(x), axes=axes),
               J.index_array(*_j(x), axes=axes))
    for axis in (None, 0, 2):
        _equal(T.getnnz(*_t(x), axis=axis), J.getnnz(*_j(x), axis=axis))


ROIS = np.array([[0, 1.3, 2.2, 7.7, 8.1], [1, 0.4, 0.6, 11.2, 9.3],
                 [-1, 1.1, 1.2, 5.3, 5.4], [1, 3.3, 2.1, 4.4, 3.9]],
                np.float32)
ALIGN_CASES = [dict(pooled_size=(2, 2)),
               dict(pooled_size=(3, 2), sample_ratio=2, spatial_scale=0.5),
               dict(pooled_size=(2, 2), aligned=True, sample_ratio=2),
               dict(pooled_size=(2, 2), position_sensitive=True)]


@pytest.mark.parametrize("kw", ALIGN_CASES,
                         ids=[str(k) for k in ALIGN_CASES])
def test_roi_align_values_and_gradients(kw, monkeypatch):
    rs = np.random.RandomState(4)
    data = rs.randn(2, 8, 10, 12).astype(np.float32)
    # two rois a chunk: the chunked gather must equal one gather
    monkeypatch.setattr(T, "GATHER_ELEMS", 2 * 8 * 36 * 8)

    def f(d, r):
        return J.roi_align(d, r, **kw)

    want, vjp = jax.vjp(jax.jit(f), *_j(data, ROIS))
    td, tr = _t(data, ROIS, grad=True)
    got = T.roi_align(td, tr, **kw)
    _close(got, want)
    assert not got[2].detach().any()  # batch index -1: zeros
    cot = rs.randn(*got.shape).astype(np.float32)
    for g, w in zip(torch.autograd.grad(got, (td, tr), torch.from_numpy(cot)),
                    jax.jit(vjp)(jnp.asarray(cot))):
        _close(g, w, GRAD)


DEFORM_CASES = [dict(kernel=(3, 3), pad=(1, 1), num_filter=6),
                dict(kernel=(3, 3), pad=(2, 2), dilate=(2, 2), num_filter=4,
                     num_deformable_group=2, num_group=2, stride=(2, 1)),
                dict(kernel=(1, 3), pad=(0, 1), num_filter=4, no_bias=True)]


@pytest.mark.parametrize("kw", DEFORM_CASES,
                         ids=[str(k) for k in DEFORM_CASES])
def test_deformable_convolution_values_and_gradients(kw, monkeypatch):
    rs = np.random.RandomState(5)
    N, C, H, W = 2, 4, 7, 8
    kh, kw_ = kw["kernel"]
    dh, dw = kw.get("dilate", (1, 1))
    sh, sw = kw.get("stride", (1, 1))
    OH = (H + 2 * kw["pad"][0] - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * kw["pad"][1] - dw * (kw_ - 1) - 1) // sw + 1
    dg, g = kw.get("num_deformable_group", 1), kw.get("num_group", 1)
    # offsets of +-0.8 around 0.13: no sample on an integer
    offset = ((rs.rand(N, 2 * dg * kh * kw_, OH, OW) - 0.5) * 1.6
              + 0.13).astype(np.float32)
    weight = rs.randn(kw["num_filter"], C // g, kh, kw_).astype(np.float32)
    bias = rs.randn(kw["num_filter"]).astype(np.float32)
    monkeypatch.setattr(T, "GATHER_ELEMS", C * kh * kw_ * OH * OW)
    data = rs.randn(N, C, H, W).astype(np.float32)

    def f(d, o, w, b):
        return J.deformable_convolution(d, o, w, b, **kw)

    want, vjp = jax.vjp(jax.jit(f), *_j(data, offset, weight, bias))
    ts = _t(data, offset, weight, bias, grad=True)
    got = T.deformable_convolution(*ts, **kw)
    _close(got, want, GRAD)
    cot = rs.randn(*got.shape).astype(np.float32)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(cot),
                                allow_unused=True)
    for i, (gt, gj) in enumerate(zip(grads, jax.jit(vjp)(jnp.asarray(cot)))):
        if kw.get("no_bias") and i == 3:
            assert gt is None and not np.asarray(gj).any()
            continue
        _close(gt, gj, GRAD)


def _mxnet_roi_pooling(data, rois, ph, pw, scale):
    """roi_pooling.cc in numpy: outputs and the argmax cell of each."""
    N, C, H, W = data.shape
    out = np.zeros((len(rois), C, ph, pw), np.float32)
    arg = np.full((len(rois), C, ph, pw), -1, np.int64)

    def rnd(v):  # C round of the float product: half away from zero
        v = float(np.float32(v) * np.float32(scale))
        return int(np.sign(v) * np.floor(abs(v) + 0.5))

    for r, roi in enumerate(rois):
        b = int(roi[0])
        if b < 0:
            continue
        x1, y1, x2, y2 = [rnd(v) for v in roi[1:]]
        bh = np.float32(max(y2 - y1 + 1, 1)) / np.float32(ph)
        bw = np.float32(max(x2 - x1 + 1, 1)) / np.float32(pw)
        for i in range(ph):
            hs = min(max(int(np.floor(np.float32(i) * bh)) + y1, 0), H)
            he = min(max(int(np.ceil(np.float32(i + 1) * bh)) + y1, 0), H)
            for j in range(pw):
                ws = min(max(int(np.floor(np.float32(j) * bw)) + x1, 0), W)
                we = min(max(int(np.ceil(np.float32(j + 1) * bw)) + x1, 0),
                         W)
                if he <= hs or we <= ws:
                    continue
                for c in range(C):
                    best, where = -np.inf, -1
                    for h in range(hs, he):
                        for w in range(ws, we):
                            if data[b, c, h, w] > best:
                                best, where = data[b, c, h, w], h * W + w
                    out[r, c, i, j], arg[r, c, i, j] = best, where
    return out, arg


def test_roi_pooling_follows_mxnets_integer_bins(monkeypatch):
    rs = np.random.RandomState(6)
    data = rs.randn(2, 5, 9, 11).astype(np.float32)
    data[1, 2, 3:6, 4:7] = 2.5  # a tie: the first cell in row-major order
    rois = np.array([[0, 0, 0, 6, 6], [1, 8, 8, 40, 33],
                     [0, -5, 3, 20, 50], [1, 24, 8, 8, 40],
                     [-1, 1, 1, 5, 5], [0, 2, 3, 2.5, 3],
                     [1, 14, 10, 30, 26]], np.float32)
    # three channels a table chunk
    monkeypatch.setattr(T, "TABLE_ELEMS", 3 * 4 * 4 * 2 * 9 * 11)
    want, arg = _mxnet_roi_pooling(data, rois, 4, 3, 0.25)
    td = torch.from_numpy(data).requires_grad_()
    got = T.roi_pooling(td, torch.from_numpy(rois), pooled_size=(4, 3),
                        spatial_scale=0.25)
    _equal(got, want)
    cot = rs.randn(*got.shape).astype(np.float32)
    (grad,) = torch.autograd.grad(got, (td,), torch.from_numpy(cot))
    ref = np.zeros(data.shape, np.float64)
    for r, c, i, j in zip(*np.nonzero(arg >= 0)):
        b = int(rois[r, 0])
        h, w = divmod(int(arg[r, c, i, j]), data.shape[3])
        ref[b, c, h, w] += cot[r, c, i, j]
    np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_roi_pooling_rounds_half_away_and_reads_every_row():
    # ROADMAP section 3's case: row 2 of an 8x8 map is 5, roi (0, 0, 6, 6),
    # pooled 4x4; bin 1 spans rows 1-3, which JAX samples at rows 1 and 3
    d8 = np.zeros((1, 1, 8, 8), np.float32)
    d8[0, 0, 2] = 5.0
    rois = np.array([[0, 0, 0, 6, 6]], np.float32)
    got = T.roi_pooling(*_t(d8, rois), pooled_size=(4, 4))
    assert got[0, 0, :, 0].tolist() == [0.0, 5.0, 0.0, 0.0]
    assert np.asarray(_jit(J.roi_pooling, pooled_size=(4, 4))(
        *_j(d8, rois)))[0, 0, :, 0].tolist() \
        == [0.0, 0.0, 0.0, 0.0]
    # a corner at 8 px at scale 1/16 is 0.5 cells: MXNet rounds it to 1
    # (C round), JAX to 0 (half to even)
    data = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 8, 8, 40, 40]], np.float32)
    got = T.roi_pooling(*_t(data, rois), pooled_size=(1, 1),
                        spatial_scale=1 / 16)
    want, _ = _mxnet_roi_pooling(data, rois, 1, 1, 1 / 16)
    _equal(got, want)
    assert float(got) == 15.0  # rows and columns [1, 4)
    assert np.asarray(_jit(J.roi_pooling, pooled_size=(1, 1),
                           spatial_scale=1 / 16)(*_j(data, rois))).item() \
        == 10.0


def test_ops_through_nd_contrib():
    ins = _target_inputs()
    with tmx.cpu():
        out = tmx.nd.contrib.MultiBoxTarget(
            *[tmx.nd.array(a) for a in ins], negative_mining_ratio=3.0)
    assert len(out) == 3 and all(isinstance(o, tmx.nd.NDArray) for o in out)
    want = _jit(J.multibox_target, negative_mining_ratio=3.0)(*_j(*ins))
    _equal(out[2]._data, want[2])

"""The port's loss blocks (mxnet_tpu_torch.gluon.loss) against the JAX
package's on the same numpy inputs, each with ``weight`` and
``sample_weight``. Tolerance 1e-5 (f32; only the order of the sums in the
batch mean differs). SoftmaxCrossEntropyLoss is held four ways: against
the JAX fused dispatch forced on, with the port's knob on and off, with
dense labels and with ``from_logits``."""
import numpy as np
import pytest
import torch

from mxnet_tpu import nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.ops import pallas_softmax_xent as px
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.ops import softmax_xent as tsx

TOL = dict(rtol=1e-5, atol=1e-5)
B, D = 4, 5


def _data(kind, seed=0):
    """(pred, label) numpy f32 arrays of shape (B, D) for a label kind."""
    rs = np.random.RandomState(seed)
    pred = rs.randn(B, D).astype(np.float32)
    label = {
        "reg": lambda: rs.randn(B, D),
        "bin": lambda: rs.randint(0, 2, (B, D)),
        "sign": lambda: 2 * rs.randint(0, 2, (B, D)) - 1,
        "dist": lambda: rs.dirichlet(np.ones(D), B),
        "count": lambda: rs.poisson(2.0, (B, D)),
    }[kind]().astype(np.float32)
    return pred, label


def _run(name, kw, *arrays, **call_kw):
    """The JAX block and the port's block on the same arrays (numpy)."""
    j = getattr(jloss, name)(**kw)(*(nd.array(a) for a in arrays),
                                  **{k: nd.array(v) for k, v in call_kw.items()})
    t = getattr(tloss, name)(**kw)(*(torch.from_numpy(a) for a in arrays),
                                   **{k: torch.from_numpy(v)
                                      for k, v in call_kw.items()})
    return j.asnumpy(), t.detach().numpy()


SW = np.linspace(0.5, 2.0, B, dtype=np.float32).reshape(B, 1)

CASES = [
    ("L2Loss", dict(weight=0.7), "reg"),
    ("L1Loss", dict(weight=0.7), "reg"),
    ("SigmoidBinaryCrossEntropyLoss", dict(weight=0.7), "bin"),
    ("SigmoidBCELoss", dict(from_sigmoid=True), "bin"),
    ("KLDivLoss", dict(from_logits=False, weight=0.7), "dist"),
    ("KLDivLoss", dict(), "dist"),
    ("HuberLoss", dict(rho=0.5, weight=0.7), "reg"),
    ("HingeLoss", dict(margin=1.5, weight=0.7), "sign"),
    ("SquaredHingeLoss", dict(weight=0.7), "sign"),
    ("LogisticLoss", dict(weight=0.7), "sign"),
    ("LogisticLoss", dict(label_format="binary"), "bin"),
    ("PoissonNLLLoss", dict(weight=0.7), "count"),
    ("PoissonNLLLoss", dict(from_logits=False, compute_full=True), "count"),
]


@pytest.mark.parametrize("name,kw,kind", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "sample_weight"])
def test_elementwise_losses_match_jax(name, kw, kind, weighted):
    pred, label = _data(kind)
    if kw.get("from_sigmoid") or (name == "PoissonNLLLoss"
                                  and not kw.get("from_logits", True)):
        pred = 1 / (1 + np.exp(-pred))  # a probability or a positive rate
    extra = dict(sample_weight=SW) if weighted else {}
    j, t = _run(name, kw, pred, label, **extra)
    assert t.shape == j.shape == (B,)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("from_sigmoid", [False, True])
def test_sigmoid_bce_pos_weight(from_sigmoid):
    pred, label = _data("bin", seed=1)
    if from_sigmoid:
        pred = 1 / (1 + np.exp(-pred))
    pw = np.linspace(0.5, 3.0, D, dtype=np.float32)
    j, t = _run("SigmoidBCELoss", dict(from_sigmoid=from_sigmoid, weight=0.3),
                pred, label, sample_weight=SW, pos_weight=pw)
    np.testing.assert_allclose(t, j, **TOL)


def test_cosine_embedding_and_triplet():
    rs = np.random.RandomState(2)
    a, p, n = (rs.randn(B, D).astype(np.float32) for _ in range(3))
    lbl = np.asarray([1, -1, 1, -1], np.float32)
    j, t = _run("CosineEmbeddingLoss", dict(weight=0.7, margin=0.1), a, p, lbl,
                sample_weight=SW[:, 0])
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _run("TripletLoss", dict(margin=0.5, weight=0.7), a, p, n,
                sample_weight=SW[:, 0])
    assert t.shape == (B,)
    np.testing.assert_allclose(t, j, **TOL)


def _xent_inputs(shape, seed=3):
    rs = np.random.RandomState(seed)
    pred = (rs.randn(*shape) * 2).astype(np.float32)
    label = rs.randint(0, shape[-1], shape[:-1]).astype(np.float32)
    return pred, label


@pytest.mark.parametrize("shape", [(6, 32), (3, 4, 50)])
@pytest.mark.parametrize("knob", [True, False], ids=["knob_on", "knob_off"])
def test_softmax_ce_sparse_matches_jax_both_dispatches(monkeypatch, shape, knob):
    """The port with its knob on (the fused plain versions on the CPU) and
    off (the composition) against the JAX block on its composition and with
    its fused dispatch forced on (the Pallas kernel in interpret mode)."""
    pred, label = _xent_inputs(shape)
    sw = np.linspace(0.5, 2.0, shape[0], dtype=np.float32).reshape(
        (shape[0],) + (1,) * (len(shape) - 2))
    kw = dict(weight=0.7)
    composed, _ = _run("SoftmaxCrossEntropyLoss", kw, pred, label,
                       sample_weight=sw)
    monkeypatch.setattr(px, "xent_kernel_supported", lambda *a, **k: True)
    fused, _ = _run("SoftmaxCrossEntropyLoss", kw, pred, label,
                    sample_weight=sw)
    old = tconfig.get("fused_softmax_xent")
    tconfig.set("fused_softmax_xent", knob)
    try:
        assert tsx.xent_kernel_supported(torch.from_numpy(pred)) is knob
        _, t = _run("SoftmaxCrossEntropyLoss", kw, pred, label,
                    sample_weight=sw)
    finally:
        tconfig.set("fused_softmax_xent", old)
    assert t.shape == (shape[0],)
    np.testing.assert_allclose(t, fused, **TOL)
    np.testing.assert_allclose(t, composed, **TOL)


def test_softmax_ce_dense_labels_and_from_logits():
    pred, label = _xent_inputs((6, 32), seed=4)
    dense = np.random.RandomState(5).dirichlet(np.ones(32), 6).astype(np.float32)
    j, t = _run("SoftmaxCrossEntropyLoss", dict(sparse_label=False), pred, dense,
                sample_weight=SW[:, 0].repeat(2)[:6])
    np.testing.assert_allclose(t, j, **TOL)
    logp = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    j, t = _run("SoftmaxCrossEntropyLoss", dict(from_logits=True, weight=2.0),
                logp, label)
    np.testing.assert_allclose(t, j, **TOL)


def test_softmax_ce_other_axis_1d_and_clipped_pick():
    """axis=1 of a 3-D input and 1-D input take the composition (the gate's
    axis and ndim rules), and the composition's pick clips an
    out-of-range label, as the JAX ``pick(mode='clip')``."""
    rs = np.random.RandomState(6)
    pred = rs.randn(2, 7, 3).astype(np.float32)
    label = rs.randint(0, 7, (2, 3)).astype(np.float32)
    j, t = _run("SoftmaxCrossEntropyLoss", dict(axis=1), pred, label)
    np.testing.assert_allclose(t, j, **TOL)
    j, t = _run("SoftmaxCrossEntropyLoss", dict(), pred[0, :, 0],
                np.asarray(3, np.float32))
    np.testing.assert_allclose(t, j, **TOL)
    pred, label = _xent_inputs((4, 9), seed=7)
    label[0], label[1] = -1, 9
    tconfig.set("fused_softmax_xent", False)
    try:
        j, t = _run("SoftmaxCrossEntropyLoss", dict(), pred, label)
    finally:
        tconfig.set("fused_softmax_xent", True)
    np.testing.assert_allclose(t, j, **TOL)


def test_softmax_ce_float16_takes_the_composition():
    pred, label = _xent_inputs((6, 32), seed=8)
    j = jloss.SoftmaxCrossEntropyLoss()(nd.array(pred).astype("float16"),
                                        nd.array(label))
    t = tloss.SoftmaxCELoss()(torch.from_numpy(pred).half(),
                              torch.from_numpy(label))
    assert t.dtype == torch.float16
    np.testing.assert_allclose(t.float().numpy(), j.asnumpy().astype(np.float32),
                               rtol=1e-3, atol=1e-3)


def test_softmax_ce_gradient_matches_composition():
    """The fused path's gradient (the backward's plain version on the CPU)
    equals autograd of the composition, per row mean included."""
    pred, label = _xent_inputs((2, 3, 11), seed=9)
    grads = []
    for knob in (True, False):
        tconfig.set("fused_softmax_xent", knob)
        try:
            x = torch.from_numpy(pred).requires_grad_()
            tloss.SoftmaxCrossEntropyLoss()(x, torch.from_numpy(label)).sum() \
                .backward()
            grads.append(x.grad)
        finally:
            tconfig.set("fused_softmax_xent", True)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)

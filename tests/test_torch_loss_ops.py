"""The port's loss and head ops (mxnet_tpu_torch/ops/nn.py, gluon/loss.py's
CTCLoss, ops/softmax_xent.py's registered op) against the JAX package's on
the same seeded numpy inputs, values and gradients:

- ``CTCLoss``: blank "first" (0-padded labels) and "last" (-1-padded), with
  and without data and label lengths, an empty label, a label longer than
  its data (about 1e30 in both; its gradient, the rounding noise of a
  constant, is only required finite), frames past ``data_lengths``; the
  Gluon ``CTCLoss`` in both layouts and both label layouts with lengths and
  a weight;
- ``SoftmaxOutput`` and the three regression heads, forward and their
  fused backward (independent of the cotangent unless ``out_grad``), every
  option; ``softmax_cross_entropy``; ``smooth_l1``;
- ``softmax_cross_entropy_fused`` on the CPU (the plain version) against
  the JAX Pallas kernel in interpret mode.

Tolerances: f32 values 1e-5 relative, gradients 1e-5 absolute; CTC's
log-space recursion over 50 frames accumulates f32 rounding in a different
op order from XLA's, so its values and gradients are held at 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_softmax_xent as jsx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import nn as tnn

F32 = dict(rtol=1e-5, atol=1e-6)
CTC = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=1e-5, atol=1e-5)

T, B, C, L = 50, 5, 7, 6


def _ctc_case(blank, seed=0):
    """(T, B, C) activations; labels with an empty row, a full row of one
    repeated class (infeasible at data length 10), a ragged row; data and
    label lengths."""
    rs = np.random.RandomState(seed)
    data = (2 * rs.randn(T, B, C)).astype(np.float32)
    lab = rs.randint(1, C, (B, L)).astype(np.int32)
    lab[0, 3:] = 0
    lab[1, :] = 0              # empty label
    lab[2, :] = 4              # 6 repeats need 11 frames
    lab[4, 5:] = 0
    lab_len = (lab != 0).sum(axis=1).astype(np.int32)
    if blank == "last":        # classes 0..C-2, blank C-1, padding -1
        lab = np.where(lab == 0, -1, lab - 1).astype(np.int32)
    data_len = np.array([T, 30, 10, 1, 41], np.int32)
    return data, lab, data_len, lab_len


def _jax_ctc(data, lab, dl, ll, use_dl, use_ll, blank):
    def f(d):
        return jnn.ctc_loss(d, jnp.asarray(lab), jnp.asarray(dl),
                            jnp.asarray(ll), use_dl, use_ll, blank)
    loss = np.asarray(f(jnp.asarray(data)))
    grad = np.asarray(jax.grad(lambda d: jnp.sum(f(d)))(jnp.asarray(data)))
    return loss, grad


def _port_ctc(data, lab, dl, ll, use_dl, use_ll, blank):
    d = torch.from_numpy(data).requires_grad_()
    loss = tnn.ctc_loss(d, torch.from_numpy(lab), torch.from_numpy(dl),
                        torch.from_numpy(ll), use_dl, use_ll, blank)
    loss.sum().backward()
    return loss.detach().numpy(), d.grad.numpy()


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("use_dl,use_ll", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_ctc_op_matches_jax(blank, use_dl, use_ll):
    data, lab, dl, ll = _ctc_case(blank)
    jl, jg = _jax_ctc(data, lab, dl, ll, use_dl, use_ll, blank)
    tl, tg = _port_ctc(data, lab, dl, ll, use_dl, use_ll, blank)
    assert tl.dtype == np.float32 and tl.shape == (B,)
    np.testing.assert_allclose(tl, jl, **CTC)
    feasible = jl < 1e29
    if use_dl:
        # the repeated label over 10 frames: no alignment, ~1e30 in both
        assert not feasible[2] and tl[2] > 1e29 and np.isfinite(tl[2])
    assert feasible[0] and feasible[1]
    np.testing.assert_allclose(tg[:, feasible], jg[:, feasible], **CTC)
    assert np.isfinite(tg).all()
    if use_dl:
        # frames at and past a row's data length take no gradient
        for b in range(B):
            assert not tg[dl[b]:, b].any()


def test_ctc_empty_label_is_the_all_blank_path():
    data, lab, dl, ll = _ctc_case("first")
    tl, _ = _port_ctc(data, lab, dl, ll, False, False, "first")
    logp = torch.log_softmax(torch.from_numpy(data), -1).numpy()
    assert np.isclose(tl[1], -logp[:, 1, 0].sum(), rtol=1e-5)


def test_ctc_registered_names_agree():
    data, lab, dl, ll = _ctc_case("first")
    with tmx.cpu():
        outs = [getattr(tnd, n)(tnd.array(data), tnd.array(lab)).asnumpy()
                for n in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                          "_contrib_ctc_loss")]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"), ("TNC", "TN"),
                                                 ("NTC", "TN")])
@pytest.mark.parametrize("lengths", [False, True])
def test_gluon_ctc_loss_matches_jax(layout, label_layout, lengths):
    data, lab, dl, ll = _ctc_case("first", seed=3)
    pred = data if layout == "TNC" else data.transpose(1, 0, 2)
    label = lab if label_layout == "NT" else lab.T
    kw_np = dict(pred_lengths=dl, label_lengths=ll) if lengths else {}
    sw = np.linspace(0.5, 1.5, B).astype(np.float32)
    jloss = jmx.gluon.loss.CTCLoss(layout, label_layout, weight=0.5)
    jout = jloss(jnd.array(pred), jnd.array(label),
                 **{k: jnd.array(v) for k, v in kw_np.items()},
                 sample_weight=jnd.array(sw)).asnumpy()
    tloss = tmx.gluon.loss.CTCLoss(layout, label_layout, weight=0.5)
    with tmx.cpu():
        p = tnd.array(pred)
        p.attach_grad()
        with tmx.autograd.record():
            out = tloss(p, tnd.array(label),
                        **{k: tnd.array(v) for k, v in kw_np.items()},
                        sample_weight=tnd.array(sw))
        out.backward()
    np.testing.assert_allclose(out.asnumpy(), jout, **CTC)
    assert np.isfinite(p.grad.asnumpy()).all()


def test_gluon_ctc_loss_refuses_unknown_layouts():
    with pytest.raises(ValueError, match="layout"):
        tmx.gluon.loss.CTCLoss("NCT")
    with pytest.raises(ValueError, match="label_layout"):
        tmx.gluon.loss.CTCLoss("NTC", "TT")


# -- SoftmaxOutput -------------------------------------------------------
SO_OPTIONS = [
    dict(),
    dict(grad_scale=2.5),
    dict(use_ignore=True, ignore_label=1),
    dict(use_ignore=True, ignore_label=1, normalization="valid"),
    dict(normalization="valid"),
    dict(normalization="batch"),
    dict(out_grad=True),
    dict(smooth_alpha=0.1),
    dict(smooth_alpha=0.2, use_ignore=True, ignore_label=3,
         normalization="batch", grad_scale=0.5, out_grad=True),
]


def _vjp_jax(fn, data, label, cot):
    out, vjp = jax.vjp(lambda d: fn(d, jnp.asarray(label)), jnp.asarray(data))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(cot))[0])


def _vjp_port(fn, data, label, cot):
    d = torch.from_numpy(data).requires_grad_()
    out = fn(d, torch.from_numpy(label))
    out.backward(torch.from_numpy(cot))
    return out.detach().numpy(), d.grad.numpy()


@pytest.mark.parametrize("opts", SO_OPTIONS, ids=[str(o) for o in SO_OPTIONS])
def test_softmax_output_forward_and_fused_backward_match_jax(opts):
    rs = np.random.RandomState(1)
    data = rs.randn(6, 5).astype(np.float32)
    label = np.array([0, 1, 4, 3, 1, 2], np.int32)
    cot = rs.randn(6, 5).astype(np.float32)
    jo, jg = _vjp_jax(lambda d, l: jnn.softmax_output(d, l, **opts), data,
                      label, cot)
    to, tg = _vjp_port(lambda d, l: tnn.softmax_output(d, l, **opts), data,
                       label, cot)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg, jg, **GRAD)


def test_softmax_output_without_label_is_softmax_and_multi_output_raises():
    rs = np.random.RandomState(2)
    data = rs.randn(3, 4).astype(np.float32)
    cot = rs.randn(3, 4).astype(np.float32)
    _, vjp = jax.vjp(jnn.softmax_output, jnp.asarray(data))
    jg = np.asarray(vjp(jnp.asarray(cot))[0])
    d = torch.from_numpy(data).requires_grad_()
    tnn.softmax_output(d).backward(torch.from_numpy(cot))
    np.testing.assert_allclose(d.grad.numpy(), jg, **GRAD)
    with pytest.raises(NotImplementedError, match="multi_output"):
        tnn.softmax_output(d, torch.zeros(3), multi_output=True)
    with tmx.cpu():
        a = tnd.SoftmaxOutput(tnd.array(data), tnd.array([0, 1, 2]))
        b = tnd.softmax_output(tnd.array(data), tnd.array([0, 1, 2]))
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


HEADS = ["LinearRegressionOutput", "LogisticRegressionOutput",
         "MAERegressionOutput"]


@pytest.mark.parametrize("name", HEADS)
@pytest.mark.parametrize("grad_scale", [1.0, 3.0])
def test_regression_heads_match_jax(name, grad_scale):
    rs = np.random.RandomState(4)
    data = rs.randn(4, 3).astype(np.float32)
    label = rs.randn(4, 3).astype(np.float32)
    cot = rs.randn(4, 3).astype(np.float32)
    jfn = jmx.registry.get(name).fn
    tfn = tmx.registry.get(name).fn
    jo, jg = _vjp_jax(lambda d, l: jfn(d, l, grad_scale=grad_scale), data,
                      label, cot)
    to, tg = _vjp_port(lambda d, l: tfn(d, l, grad_scale=grad_scale), data,
                       label, cot)
    np.testing.assert_allclose(to, jo, **F32)
    np.testing.assert_allclose(tg, jg, **GRAD)
    # without a label: the link alone, differentiated as usual
    np.testing.assert_allclose(tfn(torch.from_numpy(data)).numpy(),
                               np.asarray(jfn(jnp.asarray(data))), **F32)


def test_softmax_cross_entropy_and_smooth_l1_match_jax():
    rs = np.random.RandomState(5)
    data = (3 * rs.randn(8, 11)).astype(np.float32)
    label = rs.randint(0, 11, (8,)).astype(np.int32)
    want = np.asarray(jnn.softmax_cross_entropy(jnp.asarray(data),
                                                jnp.asarray(label)))
    with tmx.cpu():
        got = tnd.softmax_cross_entropy(tnd.array(data),
                                        tnd.array(label)).asnumpy()
    np.testing.assert_allclose(got, want, **F32)
    x = np.linspace(-3, 3, 61).astype(np.float32)
    for scalar in (1.0, 2.0, 0.5):
        jo, jg = _vjp_jax(lambda d, _: jnn.smooth_l1(d, scalar), x, x,
                          np.ones_like(x))
        to, tg = _vjp_port(lambda d, _: tnn.smooth_l1(d, scalar), x, x,
                           np.ones_like(x))
        np.testing.assert_allclose(to, jo, **F32)
        np.testing.assert_allclose(tg, jg, **GRAD)


@pytest.mark.parametrize("shape", [(6, 50), (2, 3, 33)])
def test_softmax_cross_entropy_fused_matches_the_interpreted_kernel(shape):
    """``nd.softmax_cross_entropy_fused`` on CPU tensors (the plain
    version) against the JAX op with its Pallas kernel interpreted; labels
    -1 and C pick nothing in both."""
    rs = np.random.RandomState(6)
    pred = (4 * rs.randn(*shape)).astype(np.float32)
    label = rs.randint(0, shape[-1], shape[:-1]).astype(np.int32)
    label.reshape(-1)[0], label.reshape(-1)[-1] = -1, shape[-1]
    cot = rs.rand(*shape[:-1]).astype(np.float32)
    jo, jg = _vjp_jax(lambda d, l: jsx.softmax_cross_entropy_fused(
        d, l, interpret=True), pred, label, cot)
    with tmx.cpu():
        p = tnd.array(pred)
        p.attach_grad()
        with tmx.autograd.record():
            out = tnd.softmax_cross_entropy_fused(p, tnd.array(label))
        out.backward(tnd.array(cot))
    assert out.shape == shape[:-1] and out.dtype == np.float32
    np.testing.assert_allclose(out.asnumpy(), jo, **F32)
    np.testing.assert_allclose(p.grad.asnumpy(), jg, **GRAD)

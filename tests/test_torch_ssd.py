"""The port's SSD (``mxnet_tpu_torch/models/ssd.py``) and
``examples/torch_train_ssd.py`` against the JAX package's
(``mxnet_tpu/models/ssd.py``, ``examples/train_ssd.py``) at the default
width (filters 16/32/64, 3 scales, 4 anchors a pixel, 1,344 anchors at
32x32), B=2, with the JAX net's weights carried through one ``.params``
file: the anchors bit for bit, then the predictions, the training targets,
the loss and every parameter's gradient; three steps of the example's
Gluon loop (``record`` / ``backward`` / ``Trainer("adam")``) against the
JAX example's loop on the same synthetic batches; and, on the CPU,
``TrainStep(engine_type="naive")`` equal to the Gluon loop bit for bit.

Tolerances: anchors, ``cls_target`` and ``loc_mask`` exactly equal;
predictions, ``loc_target``, losses and gradients rtol 1e-5 (atol 1e-6,
gradients 1e-6 of their largest entry); after three Adam steps no weight
beyond the sign-flip bound 2 * lr * steps and 99.9% within 1e-2 * lr
(tests/test_torch_word_lm.py's rule)."""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu_torch.models import ssd as tssd
from mxnet_tpu_torch.optimizer import Adam
from mxnet_tpu_torch.parallel import TrainStep

from test_torch_vision_layers import name_counters  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_train_ssd as tex  # noqa: E402
import train_ssd as jex  # noqa: E402

B, SIZE, STEPS, LR = 2, 32, 3, 5e-3
F32 = dict(rtol=1e-5, atol=1e-6)


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _adam_close(final, want):
    err = np.concatenate([np.abs(final[k] - want[k]).ravel() for k in want])
    assert err.max() <= 2 * LR * STEPS
    assert (err > 1e-2 * LR).mean() <= 1e-3


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """The JAX net's .params, and functions that make a JAX net and a port
    net (on the CPU) that load it.

    The weights are numpy draws set into the JAX net (a JAX initializer
    compiles a draw per shape), the biases nonzero: at a zero bias the
    background of the synthetic images gives pre-activations of exactly
    0, where the JAX ReLU (``jnp.maximum(x, 0)``) passes half the
    gradient and MXNet's (and the port's) none (ROADMAP section 3)."""
    rs = np.random.RandomState(0)
    x = rs.rand(B, 3, SIZE, SIZE).astype(np.float32)
    jnet = jssd.get_ssd(num_classes=2)
    jnet.initialize(jmx.init.Zero())
    jnet.hybridize()  # one compiled program, not one a primitive
    jnet(jmx.nd.array(x))
    for name, p in sorted(jnet.collect_params().items()):
        fan_in = int(np.prod(p.shape[1:])) if len(p.shape) > 1 else 1
        scale = np.sqrt(3.0 / fan_in) if len(p.shape) > 1 else 0.05
        p.set_data(jmx.nd.array(
            rs.uniform(-scale, scale, p.shape).astype(np.float32)))
    fname = str(tmp_path_factory.mktemp("ssd") / "jax.params")
    jnet.save_parameters(fname)

    def jax_net():
        net = jssd.get_ssd(num_classes=2)
        net.initialize(jmx.init.Zero())
        net.hybridize()
        net(jmx.nd.array(x))
        net.load_parameters(fname)
        return net

    def port_net():
        with tmx.cpu():
            net = tssd.get_ssd(num_classes=2)
            net.initialize(ctx=tmx.cpu())
            net(tmx.nd.array(x))
            net.load_parameters(fname)
        return net

    return jax_net, port_net


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    imgs, labels = jex.synthetic_batch(rs, B, SIZE)
    return np.array(imgs.asnumpy()), np.array(labels.asnumpy())


def test_parameter_names_match(nets):
    jax_net, port_net = nets
    assert sorted(_params(jax_net())) == sorted(_params(port_net()))


def test_forward_targets_loss_and_gradients_match_jax(nets):
    jax_net, port_net = nets
    imgs, labels = _batch()
    jnet, tnet = jax_net(), port_net()
    with jmx.autograd.record():
        jout = jnet(jmx.nd.array(imgs))
        jt = jssd.ssd_train_targets(jout[0], jmx.nd.array(labels), jout[1])
        jloss = jssd.ssd_loss(jout[1], jout[2], jt[2], jt[0], jt[1])
    jloss.backward()
    with tmx.cpu():
        with tmx.autograd.record():
            tout = tnet(tmx.nd.array(imgs))
            tt = tssd.ssd_train_targets(tout[0], tmx.nd.array(labels),
                                        tout[1])
            tloss = tssd.ssd_loss(tout[1], tout[2], tt[2], tt[0], tt[1])
        tloss.backward()
    assert tout[0].shape == (1, 1344, 4)
    np.testing.assert_array_equal(tout[0].asnumpy(), jout[0].asnumpy())
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **F32)
    np.testing.assert_allclose(tt[0].asnumpy(), jt[0].asnumpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tt[1].asnumpy(), jt[1].asnumpy())
    np.testing.assert_array_equal(tt[2].asnumpy(), jt[2].asnumpy())
    assert (tt[2].asnumpy() > 0).sum() >= B  # each image matched a box
    assert (tt[2].asnumpy() == -1).any()  # and ignored unmined negatives
    np.testing.assert_allclose(tloss.asnumpy(), jloss.asnumpy(), **F32)
    jg = {k: p.grad().asnumpy()
          for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet._collect_params_with_prefix().items():
        g = p.grad().asnumpy()
        np.testing.assert_allclose(g, jg[k], rtol=1e-5,
                                   atol=1e-6 * np.abs(jg[k]).max(), err_msg=k)


def test_detect_decodes_the_forward(nets):
    """``detect`` is ``MultiBoxDetection`` of the forward; the op on the
    port net's outputs equals the JAX op on the same outputs (the JAX
    net's own scores differ in the last bits, which reorders near-equal
    scores)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import contrib_vision as J

    _, port_net = nets
    imgs, _ = _batch()
    tnet = port_net()
    with tmx.cpu():
        det = tnet.detect(tmx.nd.array(imgs), threshold=0.3).asnumpy()
        anchors, cls_preds, box_preds = tnet(tmx.nd.array(imgs))
        prob = tmx.nd.softmax(cls_preds, axis=-1).asnumpy().transpose(0, 2, 1)
    want = np.asarray(J.multibox_detection(
        jnp.asarray(prob), jnp.asarray(box_preds.asnumpy()),
        jnp.asarray(anchors.asnumpy()), threshold=0.3, nms_threshold=0.45))
    assert det.shape == (B, 1344, 6)
    np.testing.assert_array_equal(det[..., 0], want[..., 0])
    np.testing.assert_allclose(det, want, **F32)


def test_example_loop_matches_the_jax_example(nets):
    jax_net, port_net = nets
    # the JAX example's loop (examples/train_ssd.py main), STEPS steps
    rs = np.random.RandomState(0)
    jnet = jax_net()
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": LR})
    want = []
    for _ in range(STEPS):
        imgs, labels = jex.synthetic_batch(rs, B, SIZE)
        with jmx.autograd.record():
            anchors, cls_preds, box_preds = jnet(imgs)
            lt, lm, ct = jssd.ssd_train_targets(anchors, labels, cls_preds)
            loss = jssd.ssd_loss(cls_preds, box_preds, ct, lt, lm)
        loss.backward()
        trainer.step(B)
        want.append(float(loss.asnumpy()))
    args = tex.build_parser().parse_args(
        ["--batch-size", str(B), "--steps", str(STEPS), "--lr", str(LR)])
    tnet = port_net()
    got = []
    res = tex.train(args, ctx=tmx.cpu(), net=tnet,
                    on_step=lambda step, value: got.append(value))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [s for s, _ in res["losses"]] == [1, 2, 3]
    _adam_close(_params(tnet), _params(jnet))
    assert res["detections"].shape == (B, 1344, 6)
    assert 0 <= res["hits"] <= B


def _step_loss(out, labels):
    anchors, cls_preds, box_preds = out
    lt, lm, ct = tssd.ssd_train_targets(anchors, labels, cls_preds)
    return tssd.ssd_loss(cls_preds, box_preds, ct, lt, lm)


def test_trainstep_naive_equals_the_gluon_loop(nets):
    _, port_net = nets
    batches = [_batch(seed) for seed in (2, 3, 4)]
    # the Gluon loop divides the gradient by the batch size
    # (Trainer.step(B)); TrainStep's Adam takes the same 1/B
    gnet = port_net()
    trainer = tmx.gluon.Trainer(gnet.collect_params(), "adam",
                                {"learning_rate": LR})
    want = []
    with tmx.cpu():
        for imgs, labels in batches:
            with tmx.autograd.record():
                loss = _step_loss(gnet(tmx.nd.array(imgs)),
                                  tmx.nd.array(labels))
            loss.backward()
            trainer.step(B)
            want.append(float(loss.asnumpy()))
    snet = port_net()
    ts = TrainStep(snet, _step_loss, Adam(learning_rate=LR,
                                          rescale_grad=1.0 / B),
                   engine_type="naive")
    got = [float(ts(torch.from_numpy(i), torch.from_numpy(lab)))
           for i, lab in batches]
    assert got == want
    final, gluon = _params(snet), _params(gnet)
    for k in gluon:
        np.testing.assert_array_equal(final[k], gluon[k], err_msg=k)
    assert ts.compiled_programs == 1

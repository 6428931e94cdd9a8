"""Training the vision zoo in the port against the JAX package: resnet18_v1
at 32x32 with 10 classes, from the same weights (a ``.params`` file) and
batches, three ``TrainStep`` steps of SGD with momentum and weight decay
in f32 at B=4 and under ``amp="bfloat16"`` at B=16 (losses, and each
trainable weight's move, against the JAX ``TrainStep``); BatchNorm's moving statistics, which the
port's ``TrainStep`` updates and the JAX one leaves (its ``_loss_of``
drops the state tape), against the JAX imperative ``record`` /
``Trainer.step`` loop, and bit for bit against the port's own imperative
loop; a window of two steps against two calls, statistics included;
checkpoints carrying the statistics across the packages; and LeNet
through ``record`` + ``gluon.Trainer("adam")`` against the JAX loop."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_vision_layers import name_counters  # noqa: F401
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch.parallel import TrainStep

B, CLASSES, SIZE, STEPS = 4, 10, 32, 3
# lr 1e-5 keeps three steps in the linear regime. At B=4 and 32x32 the
# last stage's BatchNorm normalizes 4 values a channel, and its backward
# cancels nearly all of its terms: a 1e-7 difference of the two packages'
# sums is a 1e-4 difference of the gradients, and at lr 1e-2 the third
# step's losses already differ by percents (JAX's TrainStep against its
# own imperative loop, too)
SGD = dict(learning_rate=1e-5, momentum=0.9, wd=1e-4)
# f32: the packages sum convolutions in other orders
F32 = dict(rtol=1e-4, atol=1e-5)
# f32: each weight's move over the three steps against JAX's, in norm
# (at most 2.3e-3 of the move measured; a skipped step errs by a third)
MOVE_RTOL = 1e-2
# bf16 runs at B=16: at B=4 both packages' bf16 moves are as far from the
# f32 run's as the moves are long (JAX's 0.9-1.2 of them), so no bound
# short of a zero move could hold them. At B=16 JAX's bf16 moves are
# 0.03-0.43 of the f32 move off it, in norm. Each of the port's may be off
# by BF16_RATIO times JAX's error plus BF16_SLACK of the move, and by at
# most BF16_MOVE_MAX of it: a zero move (1.0) or a skipped step (0.46 or
# more, and 0.5 at the dense layer, where JAX's error is 0.03-0.05) fail
BF16_B, BF16_RATIO, BF16_SLACK, BF16_MOVE_MAX = 16, 2.0, 0.02, 0.6


def _batches(n=3, seed=0, b=B):
    rs = np.random.RandomState(seed)
    return [(rs.rand(b, 3, SIZE, SIZE).astype(np.float32),
             rs.randint(0, CLASSES, b).astype(np.int32)) for _ in range(n)]


def _stats(net):
    """The moving statistics under names without the net's prefix."""
    n = len(net.prefix)
    return {k[n:]: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net.collect_params().items() if "running" in k}


def _trainable(net):
    n = len(net.prefix)
    return {k[n:]: np.asarray(p.data().asnumpy(), np.float32)
            for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def _close(got, want, tol, what=""):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=what + k, **tol)


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """resnet18_v1's initial weights (MSRAPrelu, drawn by the port: JAX
    would compile a draw per shape) in a .params file that both packages
    load, the moving statistics drawn at random (so that a checkpoint
    carries values a fresh net does not hold)."""
    with tmx.cpu():
        tmx.random.seed(0)
        net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=CLASSES)
        net.initialize(tmx.init.MSRAPrelu(), ctx=tmx.cpu())
        net(tmx.nd.array(_batches(1)[0][0]))
    rs = np.random.RandomState(7)
    for k, p in net.collect_params().items():
        if k.endswith("running_mean"):
            p.set_data(rs.randn(*p.shape).astype(np.float32))
        elif k.endswith("running_var"):
            p.set_data(rs.uniform(0.5, 2, p.shape).astype(np.float32))
    f = str(tmp_path_factory.mktemp("init") / "resnet18.params")
    net.save_parameters(f)
    return f


def _jnet(init):
    net = jmx.gluon.model_zoo.get_model("resnet18_v1", classes=CLASSES)
    net.load_parameters(init)
    return net


def _tnet(init):
    with tmx.cpu():
        net = tmx.gluon.model_zoo.get_model("resnet18_v1", classes=CLASSES)
    net.load_parameters(init)
    return net


def _jstep(net, amp=None):
    loss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    return JTrainStep(net, lambda out, y: loss(out, y),
                      jmx.optimizer.SGD(**SGD), mesh=None, amp=amp)


def _tstep(net, amp=None, engine_type="naive"):
    return TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     tmx.optimizer.SGD(**SGD), amp=amp,
                     engine_type=engine_type)


def _jax_trainstep(init, amp, b=B):
    net = _jnet(init)
    ts = _jstep(net, amp)
    losses = [float(np.asarray(ts(jmx.nd.array(x), jmx.nd.array(y))))
              for x, y in _batches(b=b)]
    ts.sync()
    return net, ts, losses


@pytest.fixture(scope="module")
def jax_f32(init):
    return _jax_trainstep(init, None)


@pytest.fixture(scope="module")
def jax_imperative(init):
    """The JAX imperative loop: record, backward, Trainer.step, the net
    hybridized (one compiled forward, which threads BatchNorm's state
    tape as the eager calls do, at a third of their compile time)."""
    net = _jnet(init)
    net.hybridize()
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in _batches():
        with jmx.autograd.record():
            loss = loss_fn(net(jmx.nd.array(x)), jmx.nd.array(y))
        loss.backward()
        trainer.step(B)
        losses.append(float(loss.mean().asnumpy()))
    return net, losses


def _port_trainstep(init, amp=None, b=B):
    net = _tnet(init)
    ts = _tstep(net, amp)
    losses = [ts(torch.from_numpy(x), torch.from_numpy(y))
              for x, y in _batches(b=b)]
    return net, ts, losses


def _moves(net, init):
    """Each trainable weight's move since ``init``."""
    start = _trainable(_jnet(init))
    return {k: v - start[k] for k, v in _trainable(net).items()}


def _rel(a, b):
    """``|a - b|`` over ``|b|``, in norm."""
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("amp", [None, "bfloat16"], ids=["f32", "bf16"])
def test_trainstep_matches_jax(init, jax_f32, amp):
    """Three SGD steps: the losses, and each trainable weight's move from
    the initial weights, against the JAX TrainStep's. In bf16 (B=16) the
    losses and the moves are held against the f32 run's: the port's may
    be off by at most ``BF16_RATIO`` times as much as JAX's bf16 ones
    are, and each move by less than its own length."""
    if amp is None:
        jnet, _, jlosses = jax_f32
        tnet, ts, tlosses = _port_trainstep(init)
    else:
        jnet, _, jlosses = _jax_trainstep(init, amp, BF16_B)
        tnet, ts, tlosses = _port_trainstep(init, amp, BF16_B)
    for got in tlosses:
        assert got.dim() == 0 and got.dtype == torch.float32
    got = [float(x) for x in tlosses]
    jmove, tmove = _moves(jnet, init), _moves(tnet, init)
    if amp is None:
        np.testing.assert_allclose(got, jlosses, **F32)
        for k, want in jmove.items():
            assert _rel(tmove[k], want) <= MOVE_RTOL, k
        return
    fnet, _, flosses = _jax_trainstep(init, None, BF16_B)
    f32 = np.asarray(flosses)
    terr = np.abs(np.asarray(got) - f32).mean()
    jerr = np.abs(np.asarray(jlosses) - f32).mean()
    assert terr <= BF16_RATIO * jerr + 1e-3, (got, jlosses, flosses)
    for k, r in _moves(fnet, init).items():
        terr, jerr = _rel(tmove[k], r), _rel(jmove[k], r)
        assert terr <= min(BF16_RATIO * jerr + BF16_SLACK, BF16_MOVE_MAX), \
            (k, terr, jerr)
    # the statistics moved, in the f32 parameters, with no low-precision
    # copy
    fresh = _stats(_jnet(init))
    for k, v in _stats(tnet).items():
        assert not np.allclose(v, fresh[k]), k
    assert all(p.tensor().dtype == torch.float32
               for p in tnet.collect_params().values() if p.is_state)
    assert not any("running" in name for name in ts._low)


def test_trainstep_statistics_match_the_imperative_loops(init, jax_f32,
                                                        jax_imperative):
    """After three TrainStep steps the port's moving statistics equal its
    own imperative loop's bit for bit (and so its losses and weights) and
    the JAX imperative loop's at f32 tolerance; the JAX TrainStep's are
    still the initial ones."""
    tnet, ts, tlosses = _port_trainstep(init)
    inet = _tnet(init)
    trainer = tmx.gluon.Trainer(inet.collect_params(), "sgd", dict(SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for (x, y), want in zip(_batches(), tlosses):
        with tmx.cpu():
            xa, ya = tmx.nd.array(x), tmx.nd.array(y)
        with tmx.autograd.record():
            loss = loss_fn(inet(xa), ya)
        loss.backward()
        trainer.step(B)
        assert float(loss.mean().asnumpy()) == float(want)
    for (k, a), b in zip(tnet.state_dict().items(),
                         inet.state_dict().values()):
        assert torch.equal(a, b), k
    jnet, jlosses = jax_imperative
    np.testing.assert_allclose([float(x) for x in tlosses], jlosses, **F32)
    got, want = _stats(tnet), _stats(jnet)
    _close(got, want, F32, "stats ")
    fresh = _stats(_jnet(init))
    assert all(not np.allclose(got[k], fresh[k]) for k in fresh)
    jts_net = jax_f32[0]
    _close(_stats(jts_net), fresh, dict(rtol=0, atol=0), "JAX TrainStep ")


def test_window_of_two_equals_two_calls(init):
    data = [tuple(torch.from_numpy(a) for a in b) for b in _batches(2)]
    net1, net2 = _tnet(init), _tnet(init)
    ts1, ts2 = _tstep(net1), _tstep(net2)
    want = torch.stack([ts1(*b) for b in data])
    got = ts2.run(iter(data), steps=2, window=2)
    assert torch.equal(got, want)
    assert ts2._window_dispatches == 1
    for (k, a), b in zip(net1.state_dict().items(),
                         net2.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoints_carry_the_statistics_across_packages(init, jax_f32,
                                                          tmp_path):
    """A JAX TrainStep checkpoint restores the port's step (its moving
    statistics are the initial, randomly drawn ones); the port's, after
    three steps that moved them, restores the JAX step."""
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "port")
    _, jts, _ = jax_f32
    jts.save(d_jax)
    tnet = _tnet(init)
    ts = _tstep(tnet)
    assert ts.restore(d_jax) and ts.optimizer.num_update == STEPS
    jnet = jax_f32[0]
    _close(_stats(tnet), _stats(jnet), dict(rtol=0, atol=0))
    _close(_trainable(tnet), _trainable(jnet), dict(rtol=0, atol=0))
    x, y = _batches(1, seed=5)[0]
    ts(torch.from_numpy(x), torch.from_numpy(y))
    ts.save(d_port)
    jnet2 = _jnet(init)
    jts2 = _jstep(jnet2)
    assert jts2.restore(d_port) and jts2.optimizer.num_update == STEPS + 1
    jts2.sync()
    _close(_stats(jnet2), _stats(tnet), dict(rtol=0, atol=0))
    _close(_trainable(jnet2), _trainable(tnet), dict(rtol=0, atol=0))


def _lenet_run(mx, weights, steps=4):
    """LeNet (the zoo's, hybridized) through record / backward /
    Trainer("adam").step from ``weights`` (structural name -> array) on
    seeded (8, 1, 28, 28) batches."""
    rs = np.random.RandomState(3)
    with mx.cpu():
        net = mx.gluon.model_zoo.vision.get_model("lenet")
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(weights[k])
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 2e-3})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(steps):
        with mx.cpu():
            x = mx.nd.array(rs.rand(8, 1, 28, 28).astype(np.float32))
            y = mx.nd.array(rs.randint(0, 10, 8).astype(np.int32))
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(8)
        losses.append(float(loss.mean().asnumpy()))
    return net, losses


def test_lenet_record_trainer_matches_jax():
    shapes = {"features.0.weight": (6, 1, 5, 5), "features.0.bias": (6,),
              "features.2.weight": (16, 6, 5, 5), "features.2.bias": (16,),
              "features.5.weight": (120, 400), "features.5.bias": (120,),
              "features.6.weight": (84, 120), "features.6.bias": (84,),
              "output.weight": (10, 84), "output.bias": (10,)}
    rs = np.random.RandomState(11)
    weights = {k: (rs.randn(*s) * 0.1).astype(np.float32)
               for k, s in shapes.items()}
    jnet, jlosses = _lenet_run(jmx, weights)
    tnet, tlosses = _lenet_run(tmx, weights)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6)
    want = {k: p.data().asnumpy()
            for k, p in jnet._collect_params_with_prefix().items()}
    for k, p in tnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(p.data().asnumpy(), want[k], err_msg=k,
                                   rtol=1e-4, atol=1e-5)

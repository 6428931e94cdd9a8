"""examples/torch_train_word_lm.py (the port's word-level LSTM language
model) against examples/train_word_lm.py (the JAX package's) at a tiny
width (embed and hidden 16, one LSTM layer, vocabulary of the corpus, B 4,
bptt 6, dropout 0, tied weights) from one ``.params`` file: the synthetic
corpus and ``batchify``, the tied-weight refusal, three steps of the
example's Gluon loop (``record`` / ``backward`` / ``Trainer("adam",
clip_gradient)``) against the JAX example's loop, and three ``TrainStep``
steps (naive) against the JAX ``TrainStep``; then ``--save``.

Tolerances are tests/test_torch_transformer.py's f32 ones: losses 1e-5
relative, and after three Adam steps no weight beyond the sign-flip bound
2 * lr * steps with 99.9% of them within 1e-2 * lr."""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.parallel import TrainStep

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import torch_train_word_lm as tex  # noqa: E402
import train_word_lm as jex  # noqa: E402

B, BPTT, WIDTH, STEPS, LR, CLIP = 4, 6, 16, 3, 1e-3, 0.25


def _corpus():
    return jex.synthetic_corpus(n_tokens=B * BPTT * (STEPS + 1) + B,
                                vocab=50)


def _adam_close(final, want):
    err = np.concatenate([np.abs(final[k] - want[k]).ravel() for k in want])
    assert err.max() <= 2 * LR * STEPS
    assert (err > 1e-2 * LR).mean() <= 1e-3


def _params(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def test_corpus_and_batchify_match_the_jax_example():
    for kw in ({}, {"n_tokens": 1001, "vocab": 37, "seed": 3}):
        np.testing.assert_array_equal(tex.synthetic_corpus(**kw),
                                      jex.synthetic_corpus(**kw))
    c = jex.synthetic_corpus(n_tokens=103, vocab=20)
    np.testing.assert_array_equal(tex.batchify(c, 5), jex.batchify(c, 5))
    assert tex.batchify(c, 5).shape == (20, 5)


def test_tied_weights_need_equal_widths():
    for mod in (jex, tex):
        with tmx.cpu(), pytest.raises(ValueError, match="tied weights"):
            mod.RNNModel(30, 16, 8, tie_weights=True)


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """A JAX net and the path of its .params; the port's net builder."""
    corpus = _corpus()
    vocab = int(corpus.max()) + 1
    x = jex.batchify(corpus, B)[:BPTT]
    jmx.random.seed(0)
    jnet = jex.RNNModel(vocab, WIDTH, WIDTH, num_layers=1, dropout=0.0,
                        tie_weights=True)
    jnet.initialize(jmx.init.Xavier())
    jnet(jnd.array(x, dtype="int32"))
    d = tmp_path_factory.mktemp("wlm")
    fname = str(d / "jax.params")
    jnet.save_parameters(fname)
    np.save(d / "corpus.npy", corpus)

    def port_net():
        with tmx.cpu():
            net = tex.RNNModel(vocab, WIDTH, WIDTH, num_layers=1,
                               dropout=0.0, tie_weights=True)
            net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
            net(tmx.nd.array(x, dtype="int32"))
            net.load_parameters(fname)
        return net

    def jax_net():
        net = jex.RNNModel(vocab, WIDTH, WIDTH, num_layers=1, dropout=0.0,
                           tie_weights=True)
        net.initialize(jmx.init.Xavier())
        net(jnd.array(x, dtype="int32"))
        net.load_parameters(fname)
        return net

    return jax_net, port_net, str(d), vocab


def test_gluon_loop_matches_the_jax_example(nets):
    jax_net, port_net, d, vocab = nets
    data = jex.batchify(_corpus(), B)
    # the JAX example's loop (examples/train_word_lm.py main), STEPS batches
    jnet = jax_net()
    trainer = jmx.gluon.Trainer(jnet.collect_params(), "adam",
                                {"learning_rate": LR, "clip_gradient": CLIP})
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    want = []
    for i in range(0, STEPS * BPTT, BPTT):
        x = jnd.array(data[i:i + BPTT], dtype="int32")
        y = jnd.array(data[i + 1:i + 1 + BPTT], dtype="int32")
        with jmx.autograd.record():
            out = jnet(x)
            loss = loss_fn(out.reshape(-1, vocab), y.reshape(-1))
        loss.backward()
        trainer.step(x.shape[1])
        want.append(float(loss.mean().asnumpy()))
    tnet = port_net()
    args = tex.build_parser().parse_args(
        ["--device", "cpu", "--data", os.path.join(d, "corpus.npy"),
         "--batch-size", str(B), "--bptt", str(BPTT), "--epochs", "2",
         "--lr", str(LR), "--clip", str(CLIP), "--tied", "--save",
         os.path.join(d, "port.params")])
    got = []
    epochs = tex.train(args, net=tnet,
                       on_step=lambda step, loss: got.append(loss) or
                       step == STEPS)
    assert len(epochs) == 1 and epochs[0] == pytest.approx(np.mean(got))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    final = _params(tnet)
    _adam_close(final, _params(jnet))
    np.testing.assert_array_equal(final["encoder.weight"],
                                  final["decoder.weight"])
    saved = tmx.nd.load(os.path.join(d, "port.params"))
    np.testing.assert_array_equal(saved["rnn.parameters"].asnumpy(),
                                  final["rnn.parameters"])


def test_trainstep_matches_jax(nets):
    jax_net, port_net, _, vocab = nets
    data = jex.batchify(_corpus(), B)
    x, y = data[:BPTT], data[1:BPTT + 1]

    def loss(fn):
        return lambda out, lab: fn(out.reshape((-1, vocab)),
                                   lab.reshape((-1,)))

    jnet = jax_net()
    jts = JTrainStep(jnet, loss(jmx.gluon.loss.SoftmaxCrossEntropyLoss()),
                     jopt.Adam(learning_rate=LR, clip_gradient=CLIP),
                     mesh=None)
    jb = [jnd.array(a, dtype="int32") for a in (x, y)]
    want = [float(np.asarray(jts(*jb))) for _ in range(STEPS)]
    jts.sync()
    tnet = port_net()
    ts = TrainStep(tnet, loss(tmx.gluon.loss.SoftmaxCrossEntropyLoss()),
                   topt.Adam(learning_rate=LR, clip_gradient=CLIP),
                   engine_type="naive")
    with tmx.cpu():
        tb = [tmx.nd.array(a, dtype="int32")._data for a in (x, y)]
    got = [float(ts(*tb)) for _ in range(STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _adam_close(_params(tnet), _params(jnet))
    assert ts.compiled_programs == 1

"""The port's example routes against the JAX package's examples:
examples/torch_train_dcgan.py against examples/train_dcgan.py,
examples/torch_generate_gpt2.py against examples/generate_gpt2.py and
examples/torch_train_imagenet_resnet.py against
examples/train_imagenet_resnet.py, each from the same weights (the JAX
example's own build functions monkeypatched to hand over nets that hold the
port's, carried in a ``.params`` file or a dict of arrays).

Tolerances: DCGAN losses rtol 1e-4 over three D/G iterations at the
example's widths (B 4), and after them no weight beyond Adam's sign-flip
bound 2 * lr * steps, with 99.9% within 1e-2 * lr
(tests/test_torch_word_lm.py's rule), the BatchNorm statistics rtol 1e-4;
generate_gpt2's greedy tokens equal (default, ``--paged``, ``--speculate
2``, ``--share-prefix``; the sampled ``--samples 3`` by its counts and
forks); the ImageNet route's synthetic batches equal and two ``TrainStep``
losses at resnet18, 64x64, B 4 rtol 1e-4. (At 32x32 and B 2 the last
stage's BatchNorm normalizes two values a channel and the example's lr 0.1
makes the second loss chaotic: JAX's own moves by 4% when its weights are
perturbed by 1e-7 relative; at 64x64, B 4 by 1e-7.)"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.inference import ContinuousBatcher as JBatcher
from mxnet_tpu.models import gpt2 as jgpt2
from mxnet_tpu.parallel import TrainStep as JTrainStep
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.models import gpt2 as tgpt2
from test_torch_engine import _lively_weights

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import generate_gpt2 as jgen  # noqa: E402
import torch_generate_gpt2 as tgen  # noqa: E402
import torch_train_dcgan as tdcgan  # noqa: E402
import torch_train_imagenet_resnet as tres  # noqa: E402
import train_dcgan as jdcgan  # noqa: E402
import train_imagenet_resnet as jres  # noqa: E402

CPU = tmx.cpu()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one intra-op thread for these small nets: under a loaded
    test run (several workers, each with a thread a core) its thread pool
    made each small op wait (DCGAN's three iterations 7x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_init(net):
    """A JAX net whose ``initialize`` (called by the JAX example after
    building) leaves the loaded weights alone."""
    net.initialize = lambda *a, **k: None
    return net


def _params(net):
    n = len(net.prefix)
    return {k[n:]: p.data().asnumpy() for k, p in net.collect_params().items()}


# -- DCGAN -------------------------------------------------------------------
DC_B, DC_STEPS, DC_LR = 4, 3, 2e-4


def test_dcgan_three_iterations_match_jax(tmp_path, monkeypatch):
    with CPU:
        tmx.random.seed(0)
        tgen_net = tdcgan.build_generator()
        tdisc = tdcgan.build_discriminator()
        tgen_net.initialize(tmx.init.Normal(0.02), ctx=CPU)
        tdisc.initialize(tmx.init.Normal(0.02), ctx=CPU)
        z = tmx.nd.array(np.zeros((1, 64, 1, 1), np.float32), ctx=CPU)
        tdisc(tgen_net(z))
    jnets = []
    for name, tnet, build in (("gen", tgen_net, jdcgan.build_generator),
                              ("disc", tdisc, jdcgan.build_discriminator)):
        f = str(tmp_path / f"{name}.params")
        tnet.save_parameters(f)
        jnet = build()
        jnet.load_parameters(f)
        jnet.hybridize()  # one compiled forward, not an eager op at a time
        jnets.append(_no_init(jnet))
    monkeypatch.setattr(jdcgan, "build_generator", lambda: jnets[0])
    monkeypatch.setattr(jdcgan, "build_discriminator", lambda: jnets[1])
    jd, jg, jgen_net, jdisc = jdcgan.train(
        epochs=1, batch_size=DC_B, lr=DC_LR, n_samples=DC_B * DC_STEPS,
        log=lambda *_: None)
    args = tdcgan.build_parser().parse_args(
        ["--epochs", "1", "--batch-size", str(DC_B), "--lr", str(DC_LR),
         "--n-samples", str(DC_B * DC_STEPS), "--device", "cpu"])
    td, tg, _, _ = tdcgan.train(args, gen=tgen_net, disc=tdisc,
                                log=lambda *_: None)
    assert len(td) == len(jd) == DC_STEPS
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    for jnet, tnet in ((jgen_net, tgen_net), (jdisc, tdisc)):
        want, got = _params(jnet), _params(tnet)
        assert sorted(want) == sorted(got)
        stats = [k for k in want if "running" in k]
        for k in stats:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)
        err = np.concatenate([np.abs(got[k] - want[k]).ravel()
                              for k in want if k not in stats])
        assert err.max() <= 2 * DC_LR * DC_STEPS
        assert (err > 1e-2 * DC_LR).mean() <= 1e-3


def test_dcgan_shapes_and_synthetic_data():
    np.testing.assert_array_equal(tdcgan.synthetic_blobs(5),
                                  jdcgan.synthetic_blobs(5))
    with CPU:
        tmx.random.seed(0)
        gen, disc = tdcgan.build_generator(), tdcgan.build_discriminator()
        gen.initialize(tmx.init.Normal(0.02), ctx=CPU)
        disc.initialize(tmx.init.Normal(0.02), ctx=CPU)
        img = gen(tmx.nd.array(np.random.RandomState(0).randn(2, 64, 1, 1)
                               .astype(np.float32), ctx=CPU))
        assert img.shape == (2, 1, 32, 32)
        assert np.abs(img.asnumpy()).max() <= 1.0
        assert disc(img).size == 2


# -- generate_gpt2 -----------------------------------------------------------
GEN_FLAGS = [[], ["--paged"], ["--speculate", "2"], ["--share-prefix"]]
GEN_BASE = ["--requests", "4", "--max-new-tokens", "12"]


@pytest.fixture(scope="module")
def gpt2_pair():
    """gpt2_tiny at the example's vocabulary (2048) and max length (256)
    in both packages, with the lively weights of test_torch_engine.py."""
    cfg = dict(jgpt2.gpt2_configs["gpt2_tiny"], vocab_size=2048,
               max_length=256)
    jmx.random.seed(0)
    jnet = jgpt2.GPT2Model(dropout=0.0, **cfg)
    jnet.initialize()
    jnet(jmx.nd.array(np.zeros((1, 4)), dtype="int32"))
    weights = _lively_weights(jnet)
    for name, p in jnet._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[name]))
    tnet = tgpt2.GPT2Model(dropout=0.0, device="cpu", **cfg)
    tser.load_mxnet_params(tnet, weights)
    return _no_init(jnet), tnet


def _jax_run(flags, jnet, monkeypatch):
    """The JAX example's main() with ``flags``: its GPT-2 is ``jnet``, and
    the requests its batcher took are returned."""
    submitted = []

    class Recording(JBatcher):
        def submit(self, *a, **k):
            r = super().submit(*a, **k)
            submitted.extend(getattr(r, "samples", None) or [r])
            return r

    monkeypatch.setattr(jgen.gpt2, "get_gpt2", lambda *a, **k: jnet)
    monkeypatch.setattr(jgen, "ContinuousBatcher", Recording)
    monkeypatch.setattr(sys, "argv", ["generate_gpt2.py", *flags])
    jgen.main()
    return submitted


@pytest.mark.parametrize("flags", GEN_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_generate_greedy_tokens_match_jax(flags, gpt2_pair, monkeypatch,
                                          capsys):
    jnet, tnet = gpt2_pair
    jreqs = _jax_run(GEN_BASE + flags, jnet, monkeypatch)
    # the telemetry the example prints is process-wide: count this run alone
    tmx.observability.REGISTRY.reset()
    got = tgen.main(GEN_BASE + flags + ["--device", "cpu"], net=tnet)
    assert len(got["requests"]) == len(jreqs) == 4
    for t, j in zip(got["requests"], jreqs):
        assert t["prompt"] == [int(v) for v in j.prompt]
        assert t["tokens"] == [int(v) for v in j.result()]
    out = capsys.readouterr().out
    assert "compiled programs:" in out
    if flags:
        assert got["pages"]["peak"] > 0 and "pages: peak" in out
    if flags[:1] == ["--speculate"]:
        assert got["accept_rate"] == 1.0  # the target drafts for itself
    if flags == ["--share-prefix"]:
        assert got["prefix"]["hits"] == 3 and got["prefix"]["prefills"] == 4


def test_generate_samples_fork_from_one_prompt(gpt2_pair, capsys):
    _, tnet = gpt2_pair
    tmx.observability.REGISTRY.reset()
    got = tgen.main(["--samples", "3", "--max-new-tokens", "8", "--device",
                     "cpu"], net=tnet)
    reqs = got["requests"]
    assert len(reqs) == 3 and [r["forked"] for r in reqs] == [False, True, True]
    assert all(len(r["tokens"]) == 8 for r in reqs)
    assert len({tuple(r["prompt"]) for r in reqs}) == 1
    assert got["prefix"]["forks"] == 2
    assert "2 forks" in capsys.readouterr().out


# -- ImageNet ResNet ---------------------------------------------------------
def test_synthetic_batches_match_jax():
    for (tx, ty), (jx, jy) in zip(
            tres.synthetic_batches(3, 2, (3, 8, 8), ctx=CPU),
            jres.synthetic_batches(3, 2, (3, 8, 8))):
        np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
        np.testing.assert_array_equal(ty.asnumpy(), jy.asnumpy())


RES_B, RES_SIZE = 4, 64


def _resnet18(tmp_path):
    with CPU:
        tmx.random.seed(0)
        tnet = tmx.gluon.model_zoo.vision.get_resnet(1, 18, classes=1000)
        tnet.initialize(tmx.init.MSRAPrelu(), ctx=CPU)
        x0, _ = next(tres.synthetic_batches(RES_B, 1, (3, RES_SIZE, RES_SIZE),
                                            ctx=CPU))
        tnet(x0)
    f = str(tmp_path / "r18.params")
    tnet.save_parameters(f)
    return tnet, f


def test_resnet_trainstep_matches_jax(tmp_path):
    tnet, f = _resnet18(tmp_path)
    jnet = jres.get_resnet(1, 18, classes=1000)
    jnet.load_parameters(f)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    step = JTrainStep(jnet, lambda out, y: loss_fn(out, y),
                      jopt.SGD(learning_rate=0.1, momentum=0.9, wd=1e-4))
    want = [float(np.asarray(step(x, y)))
            for x, y in jres.synthetic_batches(RES_B, 2,
                                               (3, RES_SIZE, RES_SIZE))]
    args = tres.build_parser().parse_args(
        ["--layers", "18", "--image-size", str(RES_SIZE), "--batch-size",
         str(RES_B), "--steps", "2", "--device", "cpu"])
    got = tres.train(args, net=tnet)
    np.testing.assert_allclose(got["losses"], want, rtol=1e-4)


def test_resnet_record_route(tmp_path):
    from mxnet_tpu_torch.io import recordio

    rs = np.random.RandomState(0)
    path = str(tmp_path / "data.rec")
    rec = recordio.IndexedRecordIO(str(tmp_path / "data.idx"), path, "w")
    for i in range(6):
        img = rs.randint(0, 256, (40, 40, 3)).astype(np.uint8)
        rec.write_idx(i, recordio.pack_img(
            recordio.IRHeader(0, float(i % 4), i, 0), img, img_fmt=".npy"))
    rec.close()
    args = tres.build_parser().parse_args(
        ["--layers", "18", "--image-size", "32", "--batch-size", "2",
         "--steps", "3", "--rec", path, "--data-threads", "2",
         "--device", "cpu"])
    got = tres.train(args)
    assert len(got["losses"]) == 3 and np.isfinite(got["losses"]).all()
    assert got["decode_img_per_s"] > 0


def test_resnet_refuses_data_parallel():
    args = tres.build_parser().parse_args(["--dp", "2", "--device", "cpu"])
    with pytest.raises(tmx.MXNetError, match="ROADMAP item 4"):
        tres.train(args)

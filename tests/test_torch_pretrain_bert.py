"""``examples/torch_pretrain_bert.py`` (BERT pretraining through LAMB and
``TrainStep(n_model_inputs=4)``) on the CPU at bert_tiny (2 layers, 128
units, vocab 30522), B=2, T=16, 4 masked positions, dropout 0:

- in f32 (``--dtype float32``), the example's route from the JAX net's
  weights against the JAX example's (``examples/pretrain_bert.py``:
  ``get_bert``, ``LAMB``, ``TrainStep(n_model_inputs=4)``, the same
  ``make_batch`` draws), at tests/test_torch_bert.py's f32 tolerance:
  losses to 1e-5 relative, no weight further than 2·lr·steps, 99.9%
  within 1e-2·lr;
- the default ``--dtype bfloat16`` route (``amp.init`` +
  ``amp.convert_model``): bf16 weights, their f32 masters, finite losses
  that fall over a repeated batch;
- ``TrainStep.save``/``restore`` of that route: two more steps after a
  restore are bit-identical to two more steps of the saved run (weights,
  masters, LAMB moments, step count), and the example's ``--ckpt-dir``
  resumes;
- ``--tp`` other than 1 raises."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.models import bert as jbert
from mxnet_tpu.parallel import TrainStep as JTrainStep
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.models import bert as tbert
from test_torch_vision_layers import name_counters  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, T, M, LR, STEPS = 2, 16, 4, 1e-3, 3
ARGS = ["--device", "cpu", "--model", "bert_tiny", "--batch-size", str(B),
        "--seq-length", str(T), "--num-masked", str(M), "--lr", str(LR),
        "--steps", str(STEPS - 1)]


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_pretrain_bert", ROOT / "examples" / "torch_pretrain_bert.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


def _jax_make_batch(rs):
    """examples/pretrain_bert.py's ``make_batch`` at (B, T, M)."""
    vocab = jbert.bert_configs["bert_tiny"]["vocab_size"]
    return (jnd.array(rs.randint(0, vocab, (B, T)), dtype="int32"),
            jnd.array(rs.randint(0, 2, (B, T)), dtype="int32"),
            jnd.full((B,), T, dtype="int32"),
            jnd.array(rs.randint(0, T, (B, M)), dtype="int32"),
            jnd.array(rs.randint(0, vocab, (B, M)), dtype="int32"),
            jnd.ones((B, M)),
            jnd.array(rs.randint(0, 2, (B,)), dtype="int32"))


def _jax_params(jnet):
    return {k: np.asarray(p.data().asnumpy())
            for k, p in jnet._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX example's route in f32 at dropout 0: its initial weights,
    the losses of its STEPS steps and its final weights."""
    jmx.random.seed(0)
    jnet = jbert.get_bert("bert_tiny", pretrain_head=True, max_length=T,
                          dropout=0.0)
    jnet.initialize()
    rs = np.random.RandomState(0)
    batch = _jax_make_batch(rs)
    _ = jnet(*batch[:4])
    init = _jax_params(jnet)

    def loss_fn(out, labels, weights, nsp_labels):
        mlm, nsp = out
        return jbert.pretrain_loss(mlm.astype("float32"),
                                   nsp.astype("float32"), labels, weights,
                                   nsp_labels)

    step = JTrainStep(jnet, loss_fn, jopt.LAMB(learning_rate=LR), mesh=None,
                      n_model_inputs=4, amp=None)
    losses = [float(np.asarray(step(*batch)))]
    for _ in range(STEPS - 1):
        losses.append(float(np.asarray(step(*_jax_make_batch(rs)))))
    step.sync()
    return init, losses, _jax_params(jnet)


def _port_net(init=None):
    net = tbert.get_bert("bert_tiny", pretrain_head=True, max_length=T,
                         dropout=0.0, device="cpu", seed=1)
    if init is not None:
        tser.load_mxnet_params(net, init)
    return net


def _train(extra, net, engine_type=None):
    from mxnet_tpu_torch.contrib import amp

    try:
        return EX.train(EX.build_parser().parse_args(ARGS + extra), net=net,
                        engine_type=engine_type)
    finally:
        amp._reset()


def test_f32_route_matches_the_jax_example(jax_run):
    init, jlosses, jfinal = jax_run
    net = _port_net(init)
    res = _train(["--dtype", "float32"], net)
    losses = [float(x) for x in res["losses"]]
    assert len(losses) == STEPS
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-5 * abs(want)
    final = tser.mxnet_params(net)
    assert sorted(final) == sorted(jfinal)
    err = np.concatenate([np.abs(final[k] - jfinal[k]).ravel()
                          for k in jfinal])
    assert err.max() <= 2 * LR * STEPS
    assert (err > 1e-2 * LR).mean() <= 1e-3
    assert int(res["step"].step_count) == STEPS


def _state(ts):
    out = [p.detach().clone() for _, p in ts._plist]
    for name in sorted(ts.opt_state):
        out.extend(t.clone() for t in ts.opt_state[name])
    out.extend(ts._master[n].clone() for n in sorted(ts._master))
    out.append(ts.step_count.clone())
    return out


def test_bf16_route_trains_through_f32_masters_and_resumes(tmp_path):
    """The example's default route: bf16 weights with f32 masters; the
    loss falls over a repeated batch; a restore into a fresh net and step
    continues bit for bit. The fresh net is named as the first (the block
    counters set back), as in the fresh process that resumes."""
    counts = dict(tblock._GLOBAL_COUNT)
    net = _port_net()
    res = _train([], net)
    ts = res["step"]
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    assert ts._master and all(m.dtype == torch.float32
                              for m in ts._master.values())
    for name, p in ts._plist:
        assert torch.equal(p.detach(), ts._master[name].to(torch.bfloat16))
    assert all(np.isfinite(float(x)) for x in res["losses"])
    vocab = tbert.bert_configs["bert_tiny"]["vocab_size"]
    batch = EX.make_batch(B, T, M, vocab, np.random.RandomState(5),
                          tmx.cpu())
    falling = [float(ts(*batch)) for _ in range(4)]
    assert falling[-1] < falling[0]
    ts.save(str(tmp_path))
    more = [EX.make_batch(B, T, M, vocab, np.random.RandomState(s), tmx.cpu())
            for s in (6, 7)]
    want_losses = [float(ts(*b)) for b in more]
    want = _state(ts)
    from mxnet_tpu_torch.contrib import amp

    tblock._GLOBAL_COUNT.clear()
    tblock._GLOBAL_COUNT.update(counts)
    fresh = _port_net()
    amp.init("bfloat16")
    try:
        amp.convert_model(fresh)
        ts2 = tmx.TrainStep(fresh, EX.loss_fn, EX.make_optimizer("lamb", LR),
                            n_model_inputs=4)
    finally:
        amp._reset()
    assert ts2.restore(str(tmp_path))
    assert [float(ts2(*b)) for b in more] == want_losses
    got = _state(ts2)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ckpt_dir_resumes(tmp_path, capsys):
    _train(["--dtype", "float32", "--ckpt-dir", str(tmp_path)], _port_net())
    _train(["--dtype", "float32", "--ckpt-dir", str(tmp_path)], _port_net())
    out = capsys.readouterr().out
    assert f"resumed from step {STEPS}" in out
    assert out.count("bert_tiny:") == 2 and "seq/s, final loss" in out


def test_tensor_parallelism_is_refused():
    with pytest.raises(ValueError, match="--tp 2"):
        EX.train(EX.build_parser().parse_args(ARGS + ["--tp", "2"]))

"""``HybridBlock.export`` and ``SymbolBlock`` in the port
(mxnet_tpu_torch/gluon/block.py) against the JAX package's: an MLP,
``lenet``, ``resnet18_v1`` at 32x32 (tests/test_export.py's cases) and
transformer_tiny (``input_names=("src_ids", "tgt_ids", "src_valid")``).
Each net is built in both packages with the same weights (the port's,
crossed over as a ``.params`` file); the two ``symbol.json`` files have
the same node list (ops, attributes, inputs, heads) and argument names,
and the ``.params`` files the same arrays; each package's
``SymbolBlock.imports`` of the other package's files gives the port net's
forward. Also: the imported block fine-tunes through a Gluon ``Trainer``
like the net it came from, BatchNorm traces with ``training: False`` and
writes no statistic, and the blocks that do not trace in the JAX package
(GPT-2, BERT, the fused RNN layers) raise ``MXNetError``.

Tolerances: forward rtol 1e-4, atol 1e-5 (ResNet's 1e-3 / 1e-4, as
tests/test_export.py's), the fine-tuned parameters rtol 1e-5, atol 1e-6;
graphs and arrays exactly equal."""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.models import transformer as ttf

from test_torch_vision_layers import name_counters  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)
NAMES = ("src_ids", "tgt_ids", "src_valid")


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(8, activation="relu"), mx.gluon.nn.Dense(3))
    return net


def _lenet(mx):
    return mx.gluon.model_zoo.get_model("lenet")


def _resnet(mx):
    return mx.gluon.model_zoo.get_model("resnet18_v1", classes=7)


def _transformer(mx):
    mod = jtf if mx is jmx else ttf
    kw = {} if mx is jmx else dict(device="cpu")
    return mod.get_transformer("transformer_tiny", dropout=0.0,
                               vocab_size=211, **kw)


def _inputs(case):
    rs = np.random.RandomState(0)
    if case == "transformer":
        return (rs.randint(1, 211, (3, 7)).astype(np.float32),
                rs.randint(1, 211, (3, 5)).astype(np.float32),
                np.array([7, 4, 2], np.float32))
    shape = {"mlp": (4, 5), "lenet": (2, 1, 28, 28),
             "resnet": (2, 3, 32, 32)}[case]
    return (rs.rand(*shape).astype(np.float32),)


BUILD = {"mlp": _mlp, "lenet": _lenet, "resnet": _resnet,
         "transformer": _transformer}


class Pair:
    """One case built in both packages with the port's weights, and both
    exports."""

    def __init__(self, case, tmp):
        for m in (jblock, tblock):  # the same block names in both
            m._GLOBAL_COUNT.clear()
        self.case = case
        self.x = _inputs(case)
        with tmx.cpu():
            self.t = BUILD[case](tmx)
            if case != "transformer":
                self.t.initialize(tmx.init.Xavier())
            self.t_out = self.t(*[tmx.nd.array(a) for a in self.x]).asnumpy()
        self.j = BUILD[case](jmx)
        fname = str(tmp / f"{case}.params")
        self.t.save_parameters(fname)
        # the JAX parameters take the file's values and shapes; drawing
        # them first (initialize) costs seconds of JAX compiles and is
        # overwritten
        self.j.load_parameters(fname)
        names = NAMES if case == "transformer" else ("data",)
        self.files = {"jax": self.j.export(str(tmp / f"j{case}"),
                                           input_names=names),
                      "port": self.t.export(str(tmp / f"t{case}"),
                                            input_names=names)}
        self.names = names


@pytest.fixture(scope="module")
def pairs(tmp_path_factory, name_counters):  # noqa: F811
    tmp = tmp_path_factory.mktemp("export")
    return {c: Pair(c, tmp) for c in BUILD}


def _graph(fname):
    """The JSON graph with op nodes' auto-generated names taken out."""
    g = json.load(open(fname))
    for n in g["nodes"]:
        if n["op"] != "null":
            n.pop("name")
    return g


@pytest.mark.parametrize("case", list(BUILD))
def test_export_files_match(pairs, case):
    p = pairs[case]
    (js, jparams), (ts, tparams) = p.files["jax"], p.files["port"]
    assert _graph(js) == _graph(ts)
    assert jmx.sym.load(js).list_arguments() == \
        tmx.sym.load(ts).list_arguments()
    ja = {k: v.asnumpy() for k, v in jmx.nd.load(jparams).items()}
    ta = {k: v.asnumpy() for k, v in tmx.nd.load(tparams).items()}
    assert sorted(ja) == sorted(ta) and all(k.startswith("arg:") for k in ta)
    for k in ta:
        np.testing.assert_array_equal(ja[k], ta[k])
    ops = [n["op"] for n in json.load(open(ts))["nodes"]]
    if case == "transformer":  # as the JAX export of transformer_tiny
        assert len(ops) == 215 and ops.count("LayerNorm") == 10
        assert ops.count("multi_head_attention") == 6
        assert len(tmx.sym.load(ts).list_arguments()) == 71
    if case == "resnet":  # BatchNorm traced with training off
        bn = [n for n in json.load(open(ts))["nodes"]
              if n["op"] == "BatchNorm"]
        assert bn and all(n["_raw_attrs"]["training"] is False for n in bn)
        assert tmx.sym.load(ts).list_auxiliary_states() == []


@pytest.mark.parametrize("case", list(BUILD))
@pytest.mark.parametrize("reader", ["jax", "port"])
def test_symbolblock_imports_the_other_packages_file(pairs, case, reader):
    p = pairs[case]
    sym_file, params = p.files["port" if reader == "jax" else "jax"]
    tol = dict(rtol=1e-3, atol=1e-4) if case == "resnet" else FWD
    if reader == "port":
        sb = tmx.gluon.SymbolBlock.imports(sym_file, list(p.names), params,
                                           ctx=tmx.cpu())
        with tmx.cpu():
            got = sb(*[tmx.nd.array(a) for a in p.x]).asnumpy()
    else:
        sb = jmx.gluon.SymbolBlock.imports(sym_file, list(p.names), params)
        got = sb(*[jmx.nd.array(a) for a in p.x]).asnumpy()
    np.testing.assert_allclose(got, p.t_out, **tol)


def test_trace_writes_no_batchnorm_statistic(pairs):
    """Tracing the ResNet leaves its moving statistics as they were."""
    net = pairs["resnet"].t
    stats = {k: p.data().asnumpy().copy()
             for k, p in net.collect_params().items() if "running" in k}
    net.trace_symbol("data")
    for k, p in net.collect_params().items():
        if k in stats:
            np.testing.assert_array_equal(p.data().asnumpy(), stats[k])


def test_symbolblock_finetunes_like_its_net(pairs, tmp_path):
    """Three Gluon ``Trainer("adam")`` steps of the imported MLP equal three
    steps of the net it was exported from."""
    x = np.random.RandomState(1).rand(4, 5).astype(np.float32)
    p = pairs["mlp"]
    with tmx.cpu():
        net = _mlp(tmx)
        net.initialize()
        net.load_parameters(_save(p.t, tmp_path))
        sym_file, params = p.files["port"]
        sb = tmx.gluon.SymbolBlock.imports(sym_file, ["data"], params,
                                           ctx=tmx.cpu())
        assert all(q.grad_req == "write" for q in sb.collect_params().values())
        results = []
        for block in (net, sb):
            tr = tmx.gluon.Trainer(block.collect_params(), "adam",
                                   {"learning_rate": 0.01})
            for _ in range(3):
                with tmx.autograd.record():
                    loss = (block(tmx.nd.array(x)) ** 2).sum()
                loss.backward()
                tr.step(4)
            results.append(block(tmx.nd.array(x)).asnumpy())
        before = p.t(tmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(results[1], results[0], rtol=1e-5, atol=1e-6)
    assert not np.allclose(results[0], before)


def _save(net, tmp_path):
    fname = str(tmp_path / "mlp.params")
    net.save_parameters(fname)
    return fname


def test_blocks_that_do_not_trace_raise():
    from mxnet_tpu_torch.models import get_bert

    with tmx.cpu():
        nets = [tmx.models.get_gpt2("gpt2_tiny", vocab_size=64, device="cpu"),
                get_bert("bert_tiny", vocab_size=64, device="cpu"),
                tmx.gluon.rnn.LSTM(8, input_size=4)]
        nets[2].initialize()
    for net in nets:
        with pytest.raises(MXNetError, match="does not trace"):
            net.trace_symbol("data")


def test_example_export_imports(tmp_path):
    """``examples/torch_train_transformer_wmt.py --export`` writes the
    symbolic export, as the JAX example does; its SymbolBlock gives the
    trained net's logits."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import torch_train_transformer_wmt as tex

    prefix = str(tmp_path / "wmt")
    args = tex.build_parser().parse_args([
        "--device", "cpu", "--n-sent", "32", "--vocab-size", "32",
        "--buckets", "8", "--max-len", "8", "--min-len", "4",
        "--batch-size", "16", "--epochs", "1", "--dropout", "0.0",
        "--num-layers", "1", "--units", "32", "--hidden-size", "64",
        "--num-heads", "2", "--export", prefix])
    net = tex.build_net(args, tmx.cpu())
    tex.train(args, net=net)
    sb = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", list(NAMES),
                                       prefix + "-0000.params", ctx=tmx.cpu())
    src, tgt, valid = [tmx.nd.array(a, ctx=tmx.cpu()) for a in
                       _inputs("transformer")]
    src, tgt = src % 32, tgt % 32
    np.testing.assert_allclose(sb(src, tgt, valid).asnumpy(),
                               net(src, tgt, valid).asnumpy(), **FWD)

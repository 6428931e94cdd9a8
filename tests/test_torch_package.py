"""Boundaries of the PyTorch/CUDA port: it (and chip_smoke.py and the
port's tools/torch_*.py, which run on the card's machine) imports neither
JAX nor the JAX package, its entry points run on the card unless the
caller names the CPU, and chip_smoke.py fails, printing no result, without
a card."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import gpt2 as tgpt2

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")
TINY = dict(num_layers=1, units=16, num_heads=2, max_length=32,
            vocab_size=11, dropout=0.0)
TINY_BERT = dict(TINY, hidden_size=32)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


#: the modules of the serving-resilience slice, imported by name
RESILIENCE_MODULES = (
    "mxnet_tpu_torch.observability", "mxnet_tpu_torch.observability.metrics",
    "mxnet_tpu_torch.observability.events", "mxnet_tpu_torch.resilience",
    "mxnet_tpu_torch.resilience.faults", "mxnet_tpu_torch.resilience.retry",
    "mxnet_tpu_torch.resilience.serving", "mxnet_tpu_torch.inference.batcher")


def test_import_leaves_jax_out_of_sys_modules():
    """Importing the package, its kernel build module, the resilience and
    telemetry modules and the port's drill tool (and building its tiny
    plan and net) pulls in no JAX module."""
    code = ("import sys, importlib, importlib.util, mxnet_tpu_torch, "
            "mxnet_tpu_torch.ops.cuda_common; "
            f"[importlib.import_module(m) for m in {RESILIENCE_MODULES!r}]; "
            "spec = importlib.util.spec_from_file_location('drill', "
            "'tools/torch_servedrill.py'); "
            "mod = sys.modules['drill'] = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(mod); mod.tiny_plan(); mod.tiny_net(device='cpu'); "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
                         + sorted((ROOT / "tools").glob("torch_*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.get_gpt2("gpt2_tiny", **TINY)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.models.get_bert("bert_tiny", **TINY_BERT)
    net = tgpt2.GPT2Model(**TINY, device="cpu")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.GenerationEngine(net, batch_size=1, prefill_buckets=(8,))
    eng = mt.GenerationEngine(net, batch_size=1, prefill_buckets=(8,),
                              device="cpu")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.ContinuousBatcher(eng)
    assert mt.ContinuousBatcher(eng, device="cpu").engine is eng


def _tensors(obj):
    return list(obj.parameters()) if isinstance(obj, torch.nn.Module) \
        else [t for pair in obj for t in pair]


# the public constructors below the entry points, each with its arguments
# but no device
CONSTRUCTORS = {
    "Dense": lambda **kw: mt.gluon.nn.Dense(4, in_units=3, **kw),
    "Embedding": lambda **kw: mt.gluon.nn.Embedding(5, 3, **kw),
    "LayerNorm": lambda **kw: mt.gluon.nn.LayerNorm(in_channels=3, **kw),
    "alloc_kv_cache": lambda **kw: mt.ops.attention.alloc_kv_cache(
        1, 2, 8, 4, 2, **kw),
    "alloc_paged_kv_cache": lambda **kw: mt.ops.attention.alloc_paged_kv_cache(
        3, 2, 4, 4, 2, **kw),
    "GPT2Block": lambda **kw: tgpt2.GPT2Block(16, 2, **kw),
    "BERTModel": lambda **kw: tbert.BERTModel(
        **dict(TINY_BERT, dropout=0.0), **kw),
    "BERTEncoderLayer": lambda **kw: tbert.BERTEncoderLayer(16, 32, 2, **kw),
    "get_bert": lambda **kw: tbert.get_bert("bert_tiny", **TINY_BERT, **kw),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(monkeypatch, name):
    """Without a device these build on the card, and without a card they
    raise as GPT2Model does; device="cpu" stays available on request."""
    make = CONSTRUCTORS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        make()
    tensors = _tensors(make(device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a card, in the checkout or in a directory that holds only the
    script, chip_smoke.py exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


#: the modules of the imperative MXNet surface, imported by name
SURFACE_MODULES = (
    "mxnet_tpu_torch.context", "mxnet_tpu_torch.registry",
    "mxnet_tpu_torch.random", "mxnet_tpu_torch.ndarray",
    "mxnet_tpu_torch.autograd", "mxnet_tpu_torch.initializer",
    "mxnet_tpu_torch.gluon.parameter", "mxnet_tpu_torch.gluon.block",
    "mxnet_tpu_torch.gluon.trainer", "mxnet_tpu_torch.gluon.nn",
    "mxnet_tpu_torch.contrib.amp")


def test_surface_modules_import_no_jax():
    """The imperative surface's modules, the namespace the package exports
    (as ``mxnet_tpu/__init__.py`` does) and a CPU training step through
    them pull in no JAX module."""
    code = ("import sys, importlib, mxnet_tpu_torch as mx; "
            f"[importlib.import_module(m) for m in {SURFACE_MODULES!r}]; "
            "assert all(hasattr(mx, n) for n in ('nd', 'NDArray', "
            "'autograd', 'random', 'init', 'gluon', 'cpu', 'gpu', "
            "'Context', 'current_context')); "
            "d = mx.gluon.nn.Dense(2, in_units=3, device='cpu'); "
            "d.initialize(); t = mx.gluon.Trainer(d.collect_params(), 'adam'); "
            "x = mx.nd.ones((4, 3), ctx=mx.cpu()); "
            "exec('with mx.autograd.record():\\n    l = d(x).sum()'); "
            "l.backward(); t.step(4); "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_default_context_is_the_card(monkeypatch):
    """current_context() is gpu(0); a Parameter initialized with no context
    allocates there, so without a card it raises, and mx.cpu() (argument
    or scope) is taken only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mt.current_context() == mt.gpu(0) == mt.Context("gpu", 0)
    p = mt.gluon.Parameter("w", shape=(2, 3))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        p.initialize()
    p.initialize(ctx=mt.cpu())
    assert p.data().context == mt.cpu()
    q = mt.gluon.Parameter("v", shape=(2,))
    with mt.cpu():
        q.initialize()
    assert q.tensor().device.type == "cpu"
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.nd.ones((2,))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        mt.gluon.nn.Dense(2, in_units=2)


#: the modules of the training-loop slice, imported by name
LOOP_MODULES = (
    "mxnet_tpu_torch.checkpoint", "mxnet_tpu_torch.monitor",
    "mxnet_tpu_torch.io", "mxnet_tpu_torch.io.io",
    "mxnet_tpu_torch.io.prefetch", "mxnet_tpu_torch.gluon.data",
    "mxnet_tpu_torch.gluon.data.dataset", "mxnet_tpu_torch.gluon.data.sampler",
    "mxnet_tpu_torch.gluon.data.dataloader",
    "mxnet_tpu_torch.resilience.integrity",
    "mxnet_tpu_torch.resilience.preemption",
    "mxnet_tpu_torch.parallel.train_step")


def test_loop_modules_import_no_jax(tmp_path):
    """The training loop's modules, and a CPU run through them (a
    DataLoader through ``TrainStep.run`` in windows, a checkpoint saved and
    restored, ``Trainer.run``), pull in no JAX module."""
    code = ("import sys, importlib, numpy as np, torch, mxnet_tpu_torch as mx; "
            f"[importlib.import_module(m) for m in {LOOP_MODULES!r}]; "
            "assert all(hasattr(mx, n) for n in ('io', 'mon', 'monitor', "
            "'checkpoint', 'Monitor')) and hasattr(mx.gluon, 'data'); "
            "net = torch.nn.Linear(3, 2); "
            "ds = mx.gluon.data.ArrayDataset(np.ones((8, 3), np.float32), "
            "np.zeros((8, 2), np.float32)); "
            "dl = mx.gluon.data.DataLoader(ds, batch_size=2); "
            "ts = mx.TrainStep(net, lambda o, y: ((o - y) ** 2).mean(), "
            "mx.optimizer.Adam()); "
            "assert ts.run(dl, steps=4, window=2).shape == (4,); "
            f"ts.save({str(tmp_path)!r}); assert ts.restore({str(tmp_path)!r}); "
            "d = mx.gluon.nn.Dense(2, in_units=3, device='cpu'); d.initialize(); "
            "t = mx.gluon.Trainer(d.collect_params(), 'sgd'); "
            "t.run(d, lambda o, y: ((o - y) ** 2).mean(), dl, steps=2, "
            "window=2); "
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout

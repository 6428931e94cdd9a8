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
from mxnet_tpu_torch.models import gpt2 as tgpt2

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mxnet_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")
TINY = dict(num_layers=1, units=16, num_heads=2, max_length=32,
            vocab_size=11, dropout=0.0)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.ops.cuda_common; "
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

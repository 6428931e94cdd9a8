"""The port's ``metric.py`` against the JAX package's: every metric class
and registry name, updated with the same batches (NDArrays, and tensors
or numpy arrays on the port's side), gives the same ``get()``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _batches(kind, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        if kind == "class":
            p = rs.rand(6, 5).astype(np.float32)
            p /= p.sum(axis=1, keepdims=True)
            out.append((rs.randint(0, 5, 6).astype(np.float32), p))
        elif kind == "binary":
            out.append((rs.randint(0, 2, 8).astype(np.float32),
                        rs.rand(8, 2).astype(np.float32)))
        else:
            out.append((rs.randn(4, 3).astype(np.float32),
                        rs.randn(4, 3).astype(np.float32)))
    return out


CASES = {
    "acc": ("class", {}), "top_k_acc": ("class", {"top_k": 3}),
    "f1": ("binary", {}), "mcc": ("binary", {}), "mae": ("reg", {}),
    "mse": ("reg", {}), "rmse": ("reg", {}), "ce": ("class", {}),
    "perplexity": ("class", {"ignore_label": 2}),
    "nll_loss": ("class", {}), "pcc": ("reg", {}), "loss": ("reg", {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    kind, kw = CASES[name]
    jm = jmx.metric.create(name, **kw)
    tm = tmx.metric.create(name, **kw)
    for i, (label, pred) in enumerate(_batches(kind)):
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        # the port takes NDArrays, tensors and numpy arrays alike
        tl, tp = [(tmx.nd.array(label, ctx=tmx.cpu()),
                   tmx.nd.array(pred, ctx=tmx.cpu())),
                  (torch.from_numpy(label), torch.from_numpy(pred)),
                  (label, pred)][i]
        tm.update([tl], [tp])
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    tm.reset()
    assert np.isnan(tm.get()[1]) or name in ("f1", "mcc")


def test_composite_and_custom_metrics_match_jax():
    def feval(label, pred):
        return float(pred.max(axis=-1).sum() - label.mean())

    jm = jmx.metric.create(["acc", jmx.metric.CustomMetric(feval, "maxerr")])
    tm = tmx.metric.create(["acc", tmx.metric.CustomMetric(feval, "maxerr")])
    for label, pred in _batches("class"):
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        tm.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)


def test_accuracy_sums_stay_on_the_device_until_get():
    m = tmx.metric.Accuracy()
    m.update([torch.tensor([1, 0])], [torch.tensor([[0.1, 0.9], [0.8, 0.2]])])
    assert torch.is_tensor(m.sum_metric)
    assert m.get() == ("accuracy", 1.0)

"""Evaluation metrics: the port of ``mxnet_tpu/metric.py``.

The same ``update(labels, preds)`` batch protocol, classes and registry
names. The sums of the metrics that reduce on the device (Accuracy,
TopKAccuracy, MAE, MSE, RMSE, CrossEntropy, Perplexity, Loss) stay there
as 0-d tensors, and only ``get()`` reads them: an update does not wait
for the card. Labels and predictions are NDArrays, tensors or arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE", "RMSE",
           "CrossEntropy", "Perplexity", "Loss", "PearsonCorrelation", "MCC",
           "NegativeLogLikelihood", "CustomMetric", "CompositeEvalMetric",
           "create"]


def _as_raw(x):
    x = x._data if hasattr(x, "_data") else x
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _host(x):
    """A label or prediction as a numpy array (bfloat16 as float32)."""
    t = _as_raw(x).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _add(acc, value):
    """``acc + value``, the sum kept on ``value``'s device."""
    if torch.is_tensor(acc) and torch.is_tensor(value):
        acc = acc.to(value.device)
    return acc + value


def _listify(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(self.sum_metric) / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        return list(zip(_listify(name), _listify(value)))


class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kw):
        self.axis = axis
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            if pred.dim() > label.dim():
                pred = torch.argmax(pred, dim=self.axis)
            pred = pred.reshape(-1).to(torch.int32)
            label = label.reshape(-1).to(device=pred.device,
                                         dtype=torch.int32)
            self.sum_metric = _add(self.sum_metric, (pred == label).sum())
            self.num_inst += label.numel()


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kw):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            idx = torch.argsort(pred, dim=-1, stable=True)[:, -self.top_k:]
            lab = label.to(device=idx.device, dtype=torch.int64)
            hit = (idx == lab[:, None]).any(dim=-1)
            self.sum_metric = _add(self.sum_metric, hit.sum())
            self.num_inst += label.shape[0]


class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kw):
        super().__init__(name, **kw)
        self.average = average

    def reset(self):
        self.tp = self.fp = self.fn = 0.0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _host(label).reshape(-1).astype(int)
            p = _host(pred)
            pred_lab = p.argmax(axis=-1).reshape(-1) if p.ndim > 1 else (p > 0.5).astype(int).reshape(-1)
            self.tp += float(((pred_lab == 1) & (label == 1)).sum())
            self.fp += float(((pred_lab == 1) & (label == 0)).sum())
            self.fn += float(((pred_lab == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        prec = self.tp / max(self.tp + self.fp, 1e-12)
        rec = self.tp / max(self.tp + self.fn, 1e-12)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        return self.name, f1


class MAE(EvalMetric):
    def __init__(self, name="mae", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            diff = label.to(pred.device).reshape(pred.shape) - pred
            self.sum_metric = _add(self.sum_metric, diff.abs().sum())
            self.num_inst += pred.numel()


class MSE(EvalMetric):
    def __init__(self, name="mse", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            diff = label.to(pred.device).reshape(pred.shape) - pred
            self.sum_metric = _add(self.sum_metric, diff.square().sum())
            self.num_inst += pred.numel()


class RMSE(MSE):
    def __init__(self, name="rmse", **kw):
        super().__init__(name, **kw)

    def get(self):
        name, value = super().get()
        return name, value ** 0.5


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kw):
        self.eps = eps
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            lab = label.to(device=pred.device, dtype=torch.int64)
            prob = torch.gather(pred, -1, lab.reshape(-1, 1))
            self.sum_metric = _add(self.sum_metric,
                                   (-torch.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kw):
        super().__init__(name=name, **kw)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label, pred = _as_raw(label), _as_raw(pred)
            lab = label.reshape(-1).to(device=pred.device, dtype=torch.int64)
            prob = torch.gather(pred.reshape(lab.shape[0], -1), 1,
                                lab[:, None])[:, 0]
            nll = -torch.log(prob + self.eps)
            if self.ignore_label is not None:
                mask = lab != self.ignore_label
                self.sum_metric = _add(self.sum_metric, (nll * mask).sum())
                self.num_inst += int(mask.sum())
            else:
                self.sum_metric = _add(self.sum_metric, nll.sum())
                self.num_inst += lab.shape[0]

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(float(self.sum_metric) / self.num_inst))


class Loss(EvalMetric):
    def __init__(self, name="loss", **kw):
        super().__init__(name, **kw)

    def update(self, _, preds):
        for pred in _listify(preds):
            pred = _as_raw(pred)
            self.sum_metric = _add(self.sum_metric, pred.sum())
            self.num_inst += pred.numel()


class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pcc", **kw):
        super().__init__(name, **kw)

    def reset(self):
        self._x, self._y = [], []
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            self._x.append(_host(label).reshape(-1))
            self._y.append(_host(pred).reshape(-1))
            self.num_inst += 1

    def get(self):
        if not self._x:
            return self.name, float("nan")
        x, y = np.concatenate(self._x), np.concatenate(self._y)
        return self.name, float(np.corrcoef(x, y)[0, 1])


class MCC(EvalMetric):
    def __init__(self, name="mcc", **kw):
        super().__init__(name, **kw)

    def reset(self):
        self.tp = self.tn = self.fp = self.fn = 0.0
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            label = _host(label).reshape(-1).astype(int)
            p = _host(pred)
            pred_lab = p.argmax(axis=-1).reshape(-1) if p.ndim > 1 else (p > 0.5).astype(int).reshape(-1)
            self.tp += float(((pred_lab == 1) & (label == 1)).sum())
            self.tn += float(((pred_lab == 0) & (label == 0)).sum())
            self.fp += float(((pred_lab == 1) & (label == 0)).sum())
            self.fn += float(((pred_lab == 0) & (label == 1)).sum())
            self.num_inst += 1

    def get(self):
        num = self.tp * self.tn - self.fp * self.fn
        den = ((self.tp + self.fp) * (self.tp + self.fn) * (self.tn + self.fp) * (self.tn + self.fn)) ** 0.5
        return self.name, num / den if den else 0.0


class NegativeLogLikelihood(EvalMetric):
    """Mean -log P(label) (reference metric.py NegativeLogLikelihood)."""

    def __init__(self, eps=1e-12, name="nll-loss", **kw):
        self.eps = eps
        super().__init__(name, **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            lab = _host(label).astype(np.int64).ravel()
            p = _host(pred).reshape(len(lab), -1)
            picked = p[np.arange(len(lab)), lab]
            self.sum_metric = self.sum_metric - np.log(picked + self.eps).sum()
            self.num_inst += len(lab)


class CustomMetric(EvalMetric):
    def __init__(self, feval, name="custom", allow_extra_outputs=False, **kw):
        self._feval = feval
        super().__init__(f"custom({name})", **kw)

    def update(self, labels, preds):
        for label, pred in zip(_listify(labels), _listify(preds)):
            v = self._feval(_host(label), _host(pred))
            if isinstance(v, tuple):
                s, n = v
                self.sum_metric = self.sum_metric + s
                self.num_inst += n
            else:
                self.sum_metric = self.sum_metric + v
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kw):
        self.metrics = [create(m) for m in (metrics or [])]
        super().__init__(name, **kw)

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, vals = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(_listify(n))
            vals.extend(_listify(v))
        return names, vals


_REGISTRY = {
    "acc": Accuracy, "accuracy": Accuracy, "top_k_accuracy": TopKAccuracy, "top_k_acc": TopKAccuracy,
    "f1": F1, "mae": MAE, "mse": MSE, "rmse": RMSE, "ce": CrossEntropy, "cross-entropy": CrossEntropy,
    "perplexity": Perplexity, "loss": Loss, "pcc": PearsonCorrelation, "mcc": MCC,
    "nll_loss": NegativeLogLikelihood, "nll-loss": NegativeLogLikelihood,
}


def create(metric, *args, **kwargs):
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, (list, tuple)):
        return CompositeEvalMetric(list(metric))
    return _REGISTRY[metric.lower()](*args, **kwargs)


np_metric = create

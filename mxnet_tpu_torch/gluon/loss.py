"""Loss blocks (``HybridBlock``s, so also ``torch.nn.Module``s).

Counterpart of ``mxnet_tpu/gluon/loss.py``: the same classes, arguments
and reductions (each loss is weighted, then averaged over all but the
batch axis). ``SoftmaxCrossEntropyLoss`` takes the fused kernels
(``ops/softmax_xent.py``) for sparse labels on logits whose class axis is
last, under the dispatch rule of ``xent_kernel_supported``; dense labels,
``from_logits``, float16 and 1-D input take the ``log_softmax -> pick``
composition, as in the JAX package. ``CTCLoss`` runs the ``CTCLoss`` op
(``ops/nn.py``), unreduced: one loss a sequence.
"""
from __future__ import annotations

import math

import torch

from ..ops import nn as _nn
from ..ops import softmax_xent as _sx
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "CosineEmbeddingLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _batch_mean(loss):
    """``loss.reshape((B, -1)).mean(axis=1)``."""
    return loss.reshape(loss.shape[0], -1).mean(dim=1)


def _log_softmax(x, axis):
    """``ops/nn.py`` ``log_softmax``: f32 math, the result in x's dtype."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return torch.log_softmax(x.float(), dim=axis).to(x.dtype)
    return torch.log_softmax(x, dim=axis)


def _pick(data, index, axis):
    """``ops/core.py`` ``pick`` with ``mode='clip'``: out-of-range indices
    are clipped into ``[0, C)``."""
    ax = axis % data.dim()
    idx = index.to(torch.int64).unsqueeze(ax).clamp(0, data.shape[ax] - 1)
    return torch.gather(data, ax, idx).squeeze(ax)


class Loss(HybridBlock):
    """Base of the loss blocks: a scalar ``weight`` and the batch axis.
    Called on NDArrays, a loss is an imperative block call (recorded
    under ``autograd.record``); its forward works on tensors."""

    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return _batch_mean(_apply_weighting(loss, self._weight / 2,
                                            sample_weight))


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            # log-sum-exp stable BCE on logits
            max_val = torch.maximum(-pred, 0.0 * pred)
            log_term = torch.log(torch.exp(-max_val) + torch.exp(-pred - max_val))
            loss = pred - pred * label + max_val + log_term
            if pos_weight is not None:
                loss = loss + (pos_weight - 1) * label * (max_val + log_term)
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """Sparse labels by default, dense (one-hot or soft) labels with
    ``sparse_label=False``, log-probabilities with ``from_logits=True``,
    and the class ``axis``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if (self._sparse_label and not self._from_logits
                and _sx.xent_kernel_supported(pred, self._axis)):
            # the fused kernels: the (N, C) log-softmax of the composition
            # below exists in neither direction
            loss = _sx.softmax_cross_entropy_fused(pred, label)
        else:
            if not self._from_logits:
                pred = _log_softmax(pred, self._axis)
            if self._sparse_label:
                loss = -_pick(pred, label, self._axis)
            else:
                loss = -(pred * label.reshape(pred.shape)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss if loss.dim() <= 1 else _batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _log_softmax(pred, self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        sim = (input1 * input2).sum(dim=1) / (
            torch.sqrt(torch.square(input1).sum(dim=1))
            * torch.sqrt(torch.square(input2).sum(dim=1)) + 1e-12)
        label = label.reshape(sim.shape)
        loss = torch.where(label == 1, 1 - sim, torch.relu(sim - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SquaredHingeLoss(Loss):
    """max(0, margin - pred·label)², label in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        loss = torch.square(torch.relu(self._margin - pred * label))
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """log(1 + exp(-pred·label)); ``label_format`` 'signed' {-1, 1} or
    'binary' {0, 1}."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise ValueError(f"unknown label_format {label_format!r}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "binary":
            label = 2 * label - 1
        loss = torch.relu(-pred * label) \
            + torch.log(1 + torch.exp(-torch.abs(pred * label)))
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class TripletLoss(Loss):
    """max(0, margin + |a - p|² - |a - n|²) over the trailing axes."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        d = torch.square(pred - positive) - torch.square(pred - negative)
        loss = torch.relu(d.reshape(d.shape[0], -1).sum(dim=1) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """pred - label·log(pred) (with Stirling's term when ``compute_full``);
    with ``from_logits`` pred is the log-rate."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = label.reshape(pred.shape)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = (label * torch.log(label + epsilon) - label
                        + 0.5 * torch.log(2 * math.pi * (label + epsilon)))
            loss = loss + stirling * (label > 1)
        return _batch_mean(_apply_weighting(loss, self._weight, sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification over activations laid out
    ``layout`` ("NTC" or "TNC") and labels laid out ``label_layout`` ("NT"
    or "TN"), with optional per-sequence lengths; one loss a sequence,
    weighted."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 prefix=None, params=None):
        if layout not in ("NTC", "TNC"):
            raise ValueError(f"unsupported layout {layout!r}")
        if label_layout not in ("NT", "TN"):
            raise ValueError(f"unsupported label_layout {label_layout!r}")
        super().__init__(weight, int(label_layout.find("N")), prefix=prefix,
                         params=params)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        loss = _nn.ctc_loss(pred, label, data_lengths=pred_lengths,
                            label_lengths=label_lengths,
                            use_data_lengths=pred_lengths is not None,
                            use_label_lengths=label_lengths is not None)
        return _apply_weighting(loss, self._weight, sample_weight)

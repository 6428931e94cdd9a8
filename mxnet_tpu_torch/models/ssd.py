"""SSD single-shot detector (reference shape: ``example/ssd`` + GluonCV
``model_zoo/ssd``): multi-scale conv features, per-scale class + box heads,
anchors from ``MultiBoxPrior``, training targets from ``MultiBoxTarget``,
decode+NMS via ``MultiBoxDetection``: the contrib detection family in one
model.

Counterpart of ``mxnet_tpu/models/ssd.py``: the same blocks and block
prefixes, so ``.params`` files move between the packages. Every shape is
static (fixed anchor counts per scale) and the targets need no host read,
so a ``TrainStep`` whose loss calls :func:`ssd_train_targets` captures the
whole step as one CUDA graph.
"""
from __future__ import annotations

from .. import initializer as init
from .. import ndarray as nd
from ..gluon import HybridBlock, nn

__all__ = ["SSD", "get_ssd", "ssd_train_targets", "ssd_loss"]


def _pred_head(num_out, prefix):
    """3x3 conv head emitting per-anchor class scores or box offsets
    (the caller reshapes (N, A*K, H, W) -> (N, H*W*A, K))."""
    return nn.Conv2D(num_out, 3, padding=1, prefix=prefix + "conv_",
                     weight_initializer=init.Xavier())


class SSD(HybridBlock):
    """Small SSD: a downsampling backbone with detection heads at several
    scales. ``sizes``/``ratios`` follow the reference's per-scale anchor
    configuration."""

    def __init__(self, num_classes=2, filters=(16, 32, 64),
                 sizes=((0.2, 0.27), (0.37, 0.44), (0.54, 0.62)),
                 ratios=((1.0, 2.0, 0.5),) * 3, **kwargs):
        super().__init__(**kwargs)
        assert len(filters) == len(sizes) == len(ratios)
        self.num_classes = num_classes  # foreground classes
        self._sizes = sizes
        self._ratios = ratios
        with self.name_scope():
            self.stages = nn.HybridSequential(prefix="")
            self.cls_heads = nn.HybridSequential(prefix="")
            self.box_heads = nn.HybridSequential(prefix="")
            for i, f in enumerate(filters):
                stage = nn.HybridSequential(prefix=f"stage{i}_")
                stage.add(nn.Conv2D(f, 3, padding=1, activation="relu",
                                    prefix=f"s{i}_conv0_"),
                          nn.Conv2D(f, 3, padding=1, activation="relu",
                                    prefix=f"s{i}_conv1_"),
                          nn.MaxPool2D(2, 2))
                self.stages.add(stage)
                a = len(sizes[i]) + len(ratios[i]) - 1  # anchors per pixel
                self.cls_heads.add(_pred_head(a * (num_classes + 1),
                                              prefix=f"cls{i}_"))
                self.box_heads.add(_pred_head(a * 4, prefix=f"box{i}_"))

    def hybrid_forward(self, F, x):
        anchors, cls_preds, box_preds = [], [], []
        for stage, ch, bh, sizes, ratios in zip(
                self.stages, self.cls_heads, self.box_heads,
                self._sizes, self._ratios):
            x = stage(x)
            anchors.append(F.contrib.MultiBoxPrior(x, sizes=sizes,
                                                   ratios=ratios))
            c = ch(x)  # (N, A*(C+1), H, W)
            cls_preds.append(F.reshape(F.transpose(c, axes=(0, 2, 3, 1)),
                                       shape=(0, -1, self.num_classes + 1)))
            b = bh(x)  # (N, A*4, H, W)
            box_preds.append(F.reshape(F.transpose(b, axes=(0, 2, 3, 1)),
                                       shape=(0, -1, 4)))
        anchors = F.concat(*anchors, dim=1)            # (1, A_total, 4)
        cls_preds = F.concat(*cls_preds, dim=1)        # (N, A_total, C+1)
        box_preds = F.reshape(F.concat(*box_preds, dim=1),
                              shape=(0, -1))           # (N, A_total*4)
        return anchors, cls_preds, box_preds

    def detect(self, x, threshold=0.01, nms_threshold=0.45):
        """Inference: decode + NMS -> (N, A, 6) rows [cls, score, box]."""
        anchors, cls_preds, box_preds = self(x)
        cls_prob = nd.transpose(nd.softmax(cls_preds, axis=-1),
                                axes=(0, 2, 1))
        return nd.contrib.MultiBoxDetection(
            cls_prob, box_preds, anchors, threshold=threshold,
            nms_threshold=nms_threshold)


def ssd_train_targets(anchors, labels, cls_preds, overlap_threshold=0.5,
                      negative_mining_ratio=3.0):
    """MultiBoxTarget with the reference's default 3:1 hard negative mining.
    cls_preds here is (N, A, C+1), transposed to the op's (N, C+1, A)."""
    cls_prob = nd.transpose(nd.softmax(cls_preds, axis=-1), axes=(0, 2, 1))
    return nd.contrib.MultiBoxTarget(
        anchors, labels, cls_prob, overlap_threshold=overlap_threshold,
        negative_mining_ratio=negative_mining_ratio)


def ssd_loss(cls_preds, box_preds, cls_target, loc_target, loc_mask,
             ignore_label=-1.0):
    """SSD loss: softmax CE over matched+mined anchors + smooth-L1 on
    matched offsets (reference example/ssd train loss)."""
    n, a, k = cls_preds.shape
    logp = nd.reshape(nd.log_softmax(cls_preds, axis=-1), shape=(n * a, k))
    tgt = nd.reshape(cls_target, shape=(n * a,))
    keep = (tgt != ignore_label)
    nll = -nd.pick(logp, nd.maximum(tgt, 0.0 * tgt), axis=-1)
    cls_loss = (nll * keep).sum() / (keep.sum() + 1e-6)

    diff = (box_preds - loc_target) * loc_mask
    adiff = diff.abs()
    sl1 = nd.where(adiff < 1.0, 0.5 * diff * diff, adiff - 0.5)
    loc_loss = sl1.sum() / (loc_mask.sum() + 1e-6)
    return cls_loss + loc_loss


def get_ssd(num_classes=2, **kwargs):
    return SSD(num_classes=num_classes, **kwargs)

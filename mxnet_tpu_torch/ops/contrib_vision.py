"""The detection operators: anchors (``MultiBoxPrior``), training targets
(``MultiBoxTarget``), decoding and NMS (``MultiBoxDetection``,
``box_nms``, ``box_iou``), ``ROIAlign``, ``ROIPooling``,
``DeformableConvolution``, ``index_array`` and ``getnnz``.

Counterpart of ``mxnet_tpu/ops/contrib_vision.py``: every name, alias,
parameter, default and ``nout`` it registers, over torch, with gradients
from autograd. None of them is a hand-written kernel in the JAX package
(each is a jnp/lax composition there), so each is a plain composition
here, with static shapes and no host read, so that a captured step
(``StepGraph``) can hold it.

Designs:

  - **Bilinear sampling** (``ROIAlign``, ``DeformableConvolution``) is JAX's
    ``_bilinear_gather`` rule (a sample outside (-1, H) x (-1, W) weighs 0,
    the rest are clipped into the map) over a channels-last copy of the
    map: each of the 4 corners is one ``index_select`` of whole C-rows.
    The gathers run in chunks of rois (of images for the deformable
    convolution) of at most ``GATHER_ELEMS`` gathered elements, so the
    forward's peak memory does not grow with the roi count.
  - **box_nms** sorts stably (``torch.sort(stable=True)``, as
    ``jnp.argsort``; invalid rows all sort last) and, with ``topk=k``,
    builds only the k x k IoU block of the first k sorted rows: no later
    row can be kept. The greedy pass is a loop of k fused row updates over
    the precomputed suppression mask ``S`` (IoU above the threshold, the
    same class unless ``force_suppress``, later rows only): at row ``i``,
    ``keep *= 1 - S[i] * keep[i]``, two launches a row and no host read.
    With ``topk=-1`` k is every row, so a detection at the 32x32 SSD's
    1,344 anchors takes 2,688 launches in that loop.
  - **MultiBoxTarget** is JAX's vectorised matching. The force-match gives
    an anchor that several ground truths name as their best to the LAST of
    them, as JAX's ``.at[].set`` does on the CPU: a ``scatter_reduce``
    ("amax") of the row index, where an ``index_put_`` with duplicate
    indices would write in no fixed order on the card. Padded rows (class
    -1) scatter to a spare slot that is dropped (``mode="drop"``). Hard
    negatives are ranked by a stable sort, and their count is JAX's
    ``int32(matched.sum() * ratio)``.
  - **ROIPooling** follows MXNet's ``roi_pooling.cc``, not the JAX op,
    which samples a bin at ``ceil(H / pooled_h)`` points and misses rows:
    corners rounded half away from zero (C ``round``; ``jnp.round`` rounds
    half to even), bins ``[floor(i*h/ph) + y1, ceil((i+1)*h/ph) + y1)``
    with ``h = max(y2 - y1 + 1, 1)`` clipped to the map, 0 for an empty
    bin or a roi whose batch index is negative, and the exact maximum of
    each bin's cells. The maximum is read from a 2-D sparse table of
    (value, cell) pairs (power-of-two windows, four overlapping windows a
    bin), built in channel chunks; its gradient goes to the bin's first
    maximal cell in row-major order, MXNet's argmax.
  - ``index_array`` and ``getnnz`` give int32, the port's index dtype (the
    JAX package's with x64 off; MXNet gives int64).
  - ``ROIAlign`` with ``sample_ratio <= 0`` keeps JAX's static
    ``ceil(H/ph) x ceil(W/pw)`` sampling grid for every roi (MXNet adapts
    the count to each roi).
"""
from __future__ import annotations

import math

import torch

from ..registry import register

__all__ = ["roi_align", "deformable_convolution", "multibox_prior",
           "box_iou", "box_nms", "multibox_detection", "multibox_target",
           "index_array", "getnnz", "roi_pooling", "GATHER_ELEMS"]

#: most elements one corner gather of ROIAlign / DeformableConvolution
#: makes at a time (a chunk of rois or images)
GATHER_ELEMS = 1 << 25
#: most (value, cell) entries of one channel chunk of ROIPooling's table
TABLE_ELEMS = 1 << 24


# --------------------------------------------------------------------------
# bilinear sampling (ROIAlign, DeformableConvolution)
# --------------------------------------------------------------------------
def _bilinear(feat, base, y, x, H, W):
    """Sample rows of ``feat`` (P, C), a channels-last map whose image
    ``base // (H*W)`` starts at row ``base`` (broadcast against ``y``), at
    fractional (y, x): the result has ``y.shape + (C,)``. A sample outside
    (-1, H) x (-1, W) gives 0, the others are clipped into the map (JAX's
    ``_bilinear_gather``)."""
    valid = (y > -1.0) & (y < H) & (x > -1.0) & (x < W)
    y = y.clamp(0.0, H - 1)
    x = x.clamp(0.0, W - 1)
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    y1 = (y0 + 1).clamp_max(H - 1)
    x1 = (x0 + 1).clamp_max(W - 1)
    ly, lx = y - y0f, x - x0f
    hy, hx = 1.0 - ly, 1.0 - lx
    shape = y.shape + (feat.shape[1],)

    def take(yi, xi):
        rows = (base + yi * W + xi).reshape(-1)
        return feat.index_select(0, rows).reshape(shape)

    val = (take(y0, x0) * (hy * hx)[..., None]
           + take(y0, x1) * (hy * lx)[..., None]
           + take(y1, x0) * (ly * hx)[..., None]
           + take(y1, x1) * (ly * lx)[..., None])
    return val * valid.to(feat.dtype)[..., None]


def _chunk(n_items, per_item):
    """Items a chunk of at most GATHER_ELEMS gathered elements holds."""
    return max(1, min(n_items, GATHER_ELEMS // max(per_item, 1)))


# --------------------------------------------------------------------------
# ROIAlign (reference: src/operator/contrib/roi_align.cc)
# --------------------------------------------------------------------------
@register("_contrib_ROIAlign")
def roi_align(data, rois, pooled_size=None, spatial_scale=1.0, sample_ratio=-1,
              position_sensitive=False, aligned=False):
    """ROI Align. data: (N,C,H,W); rois: (R,5) [batch_idx, x1, y1, x2, y2].

    ``position_sensitive=True`` gives PSROIAlign (R-FCN): channel
    ``c*ph*pw + bin`` feeds output channel ``c`` at that bin. A roi whose
    batch index is negative gives zeros. ``sample_ratio <= 0`` samples
    every roi on JAX's static ``ceil(H/pooled_h) x ceil(W/pooled_w)``
    grid."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    dt, dev = data.dtype, data.device
    rois = rois.to(dt)
    offset = 0.5 if aligned else 0.0
    if int(sample_ratio) > 0:
        sr_h = sr_w = int(sample_ratio)
    else:
        sr_h = max(1, -(-H // ph))
        sr_w = max(1, -(-W // pw))
    cout = C // (ph * pw) if position_sensitive else C
    R = rois.shape[0]
    if R == 0:
        return data.new_zeros((0, cout, ph, pw))
    feat = data.permute(0, 2, 3, 1).reshape(N * H * W, C)
    py = torch.arange(ph, dtype=dt, device=dev)
    px = torch.arange(pw, dtype=dt, device=dev)
    sy = (torch.arange(sr_h, dtype=dt, device=dev) + 0.5) / sr_h
    sx = (torch.arange(sr_w, dtype=dt, device=dev) + 0.5) / sr_w
    gy = py[:, None] + sy[None, :]                           # (ph, sr_h)
    gx = px[:, None] + sx[None, :]                           # (pw, sr_w)
    outs = []
    step = _chunk(R, ph * pw * sr_h * sr_w * C)
    for r0 in range(0, R, step):
        rr = rois[r0:r0 + step]
        b = rr[:, 0].to(torch.int64).clamp(0, N - 1)
        x1, y1, x2, y2 = [rr[:, i] * spatial_scale - offset
                          for i in range(1, 5)]
        rw, rh = x2 - x1, y2 - y1
        if not aligned:
            rw, rh = rw.clamp_min(1.0), rh.clamp_min(1.0)
        bin_h, bin_w = rh / ph, rw / pw
        ys = y1[:, None, None] + gy * bin_h[:, None, None]   # (r, ph, sr_h)
        xs = x1[:, None, None] + gx * bin_w[:, None, None]   # (r, pw, sr_w)
        n = rr.shape[0]
        yg = ys[:, :, None, :, None].expand(n, ph, pw, sr_h, sr_w)
        xg = xs[:, None, :, None, :].expand(n, ph, pw, sr_h, sr_w)
        base = (b * (H * W))[:, None, None, None, None]
        vals = _bilinear(feat, base, yg, xg, H, W)   # (r, ph, pw, sh, sw, C)
        vals = vals.mean(dim=(3, 4))                 # (r, ph, pw, C)
        if position_sensitive:
            vals = vals.reshape(n, ph * pw, cout, ph * pw)
            vals = torch.diagonal(vals, dim1=1, dim2=3).reshape(
                n, cout, ph, pw)
        else:
            vals = vals.permute(0, 3, 1, 2)
        keep = (rr[:, 0] >= 0).to(dt)[:, None, None, None]
        outs.append(vals * keep)
    return torch.cat(outs, 0) if len(outs) > 1 else outs[0]


# --------------------------------------------------------------------------
# DeformableConvolution (reference: contrib/deformable_convolution.cc)
# --------------------------------------------------------------------------
@register("_contrib_DeformableConvolution")
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=None, num_group=1,
                           num_deformable_group=1, no_bias=False):
    """Deformable conv v1: the sampling grid displaced by a learned offset
    map. data (N,C,H,W); offset (N, 2*dg*kh*kw, OH, OW) ordered (dg, kh,
    kw, [y,x]) as in the reference kernel; weight (O, C/g, kh, kw). The
    columns are gathered bilinearly (channels-last), the product is one
    ``torch.matmul`` a group, and the gradients of data, offset and weight
    are autograd's through both."""
    N, C, H, W = data.shape
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph, pw = int(pad[0]), int(pad[1])
    OH = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    OW = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = int(num_deformable_group)
    O = int(num_filter) if num_filter else weight.shape[0]
    g = int(num_group)
    cg = C // dg
    dt, dev = data.dtype, data.device
    base_y = (torch.arange(OH, device=dev) * sh - ph).to(dt)
    base_x = (torch.arange(OW, device=dev) * sw - pw).to(dt)
    ky = (torch.arange(kh, device=dev) * dh).to(dt)
    kx = (torch.arange(kw, device=dev) * dw).to(dt)
    grid_y = base_y[None, None, None, :, None] + ky[None, :, None, None, None]
    grid_x = base_x[None, None, None, None, :] + kx[None, None, :, None, None]
    off = offset.reshape(N, dg, kh, kw, 2, OH, OW)
    # (N*dg*H*W, cg): group d of image n starts at row (n*dg + d)*H*W
    feat = data.reshape(N, dg, cg, H, W).permute(0, 1, 3, 4, 2).reshape(
        N * dg * H * W, cg)
    wmat = weight.reshape(g, O // g, (C // g) * kh * kw)
    outs = []
    step = _chunk(N, C * kh * kw * OH * OW)
    for n0 in range(0, N, step):
        n = min(step, N - n0)
        o = off[n0:n0 + n]
        yy = grid_y + o[:, :, :, :, 0]               # (n, dg, kh, kw, OH, OW)
        xx = grid_x + o[:, :, :, :, 1]
        img = torch.arange(n0, n0 + n, device=dev)[:, None] * dg + \
            torch.arange(dg, device=dev)[None, :]
        base = (img * (H * W))[:, :, None, None, None, None]
        # (n, dg, kh, kw, OH, OW, cg)
        cols = _bilinear(feat, base, yy, xx, H, W)
        cols = cols.permute(0, 1, 6, 2, 3, 4, 5).reshape(
            n, g, (C // g) * kh * kw, OH * OW)
        outs.append(torch.matmul(wmat, cols).reshape(n, O, OH, OW))
    out = torch.cat(outs, 0) if len(outs) > 1 else outs[0]
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, O, 1, 1)
    return out


# --------------------------------------------------------------------------
# MultiBoxPrior (reference: contrib/multibox_prior.cc)
# --------------------------------------------------------------------------
_PRIORS = {}  # (shape, parameters, device) -> the anchors, made once


@register("_contrib_MultiBoxPrior")
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor box generation. data: (N,C,H,W) -> (1, H*W*A, 4) corner boxes.

    Widths carry the reference's ``in_h/in_w`` aspect correction
    (multibox_prior.cc: ``w = size * in_h / in_w * sqrt(ratio)``) so that
    ratio-1 anchors are square in pixel space on non-square feature maps.
    The boxes depend on the shape alone: they are made once per shape,
    parameters and device (f32, the JAX op's operations in its order) and
    read from then on, also inside a captured step."""
    H, W = data.shape[2], data.shape[3]
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    steps = tuple(float(s) for s in steps)
    offsets = tuple(float(o) for o in offsets)
    key = (H, W, sizes, ratios, bool(clip), steps, offsets, data.device)
    boxes = _PRIORS.get(key)
    if boxes is not None:
        return boxes
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    f32 = torch.float32
    cy = (torch.arange(H, dtype=f32, device=dev) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=f32, device=dev) + offsets[1]) * step_x
    # MXNet: num_anchors = len(sizes) + len(ratios) - 1 (all sizes with
    # ratios[0], then sizes[0] with ratios[1:])
    ar = H / W
    whs = [(s * ar * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
           for s in sizes]
    whs += [(sizes[0] * ar * math.sqrt(r), sizes[0] / math.sqrt(r))
            for r in ratios[1:]]
    wh = torch.stack([torch.stack([torch.full((), w, dtype=f32, device=dev),
                                   torch.full((), h, dtype=f32, device=dev)])
                      for w, h in whs])                       # (A, 2)
    A = wh.shape[0]
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")          # (H, W)
    centers = torch.stack([cxg, cyg], -1)[:, :, None, :]      # (H,W,1,2)
    half = wh[None, None, :, :] / 2.0                         # (1,1,A,2)
    boxes = torch.cat([centers - half, centers + half], -1)   # (H,W,A,4)
    boxes = boxes.reshape(1, H * W * A, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    if not capturing:  # made inside a capture, it lives in the graph's pool
        _PRIORS[key] = boxes  # lint: disable=JH005 -- a memo: a race stores equal boxes
    return boxes


# --------------------------------------------------------------------------
# box_iou / box_nms (reference: contrib/bounding_box.cc)
# --------------------------------------------------------------------------
def _to_corner(b):
    cx, cy, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _pairwise_iou(lhs, rhs, fmt="corner"):
    if fmt == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    tl = torch.maximum(lhs[..., :, None, :2], rhs[..., None, :, :2])
    br = torch.minimum(lhs[..., :, None, 2:], rhs[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_l = (lhs[..., 2] - lhs[..., 0]) * (lhs[..., 3] - lhs[..., 1])
    area_r = (rhs[..., 2] - rhs[..., 0]) * (rhs[..., 3] - rhs[..., 1])
    union = area_l[..., :, None] + area_r[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


@register("_contrib_box_iou")
def box_iou(lhs, rhs, format="corner"):
    return _pairwise_iou(lhs, rhs, fmt=format)


def _greedy_keep(sup, keep):
    """JAX's greedy pass: row ``i``, if still kept, drops every later row
    it suppresses. ``sup`` (B, k, k) holds the suppressions (later rows
    only), ``keep`` (B, k) the candidates; k row updates of two launches
    each, no host read."""
    supf = sup.to(torch.float32)
    keep = keep.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=keep.device)
    for i in range(keep.shape[1]):
        keep.mul_(torch.addcmul(one, supf[:, i], keep[:, i:i + 1],
                                value=-1.0))
    return keep > 0


@register("_contrib_box_nms")
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Static-shape NMS: the rows sorted by score (stably, invalid rows
    last), suppressed rows' score -1 (MXNet convention).

    data: (..., N, K) rows [id?, score, x1, y1, x2, y2, ...]. With
    ``topk=k`` only the first k sorted rows can be kept, and only their
    k x k IoU block is built."""
    batched = data.dim() == 3
    if not batched:
        data = data[None]
    cs, si, ii = int(coord_start), int(score_index), int(id_index)
    B, N, K = data.shape
    scores = data[..., si]
    valid = scores > valid_thresh
    if ii >= 0 and background_id >= 0:
        valid = valid & (data[..., ii] != background_id)
    key = torch.where(valid, -scores, float("inf"))
    order = torch.sort(key, dim=1, stable=True).indices
    rows = torch.gather(data, 1, order[..., None].expand(B, N, K))
    svalid = torch.gather(valid, 1, order)
    k = N if topk < 0 else min(int(topk), N)
    head = rows[:, :k]
    sup = _pairwise_iou(head[..., cs:cs + 4], head[..., cs:cs + 4],
                        fmt=in_format) > overlap_thresh
    if not force_suppress and ii >= 0:
        sup = sup & (head[..., ii][:, :, None] == head[..., ii][:, None, :])
    sup = torch.triu(sup, diagonal=1)
    keep = _greedy_keep(sup, svalid[:, :k])
    if k < N:
        keep = torch.cat([keep, keep.new_zeros((B, N - k))], 1)
    cols = list(rows.unbind(-1))
    cols[si] = torch.where(keep, cols[si], -1.0)
    if in_format != out_format:
        b = cols[cs:cs + 4]
        if out_format == "corner":   # center (x,y,w,h) -> corner
            x, y, w, h = b
            b = [x - w / 2, y - h / 2, x + w / 2, y + h / 2]
        else:                        # corner -> center
            x1_, y1_, x2_, y2_ = b
            b = [(x1_ + x2_) / 2, (y1_ + y2_) / 2, x2_ - x1_, y2_ - y1_]
        cols[cs:cs + 4] = b
    out = torch.stack(cols, -1)
    return out if batched else out[0]


# --------------------------------------------------------------------------
# MultiBoxDetection (reference: contrib/multibox_detection.cc)
# --------------------------------------------------------------------------
@register("_contrib_MultiBoxDetection")
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode SSD predictions -> (N, num_anchors, 6) rows [cls, score, 4
    box], sorted by score; suppressed rows carry -1 in the class and score
    columns.

    cls_prob (N, num_classes, A), loc_pred (N, A*4), anchor (1, A, 4
    corner)."""
    N, _, A = cls_prob.shape
    loc = loc_pred.reshape(N, A, 4)
    anc = anchor.reshape(A, 4)
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    v = [float(x) for x in variances]
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], -1)    # (N, A, 4)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    # best non-background class per anchor
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    cls_id = torch.argmax(fg, dim=1).to(cls_prob.dtype)          # (N, A)
    score = torch.amax(fg, dim=1)
    cls_id = torch.where(score > threshold, cls_id, -1.0)
    score = torch.where(score > threshold, score, -1.0)
    rows = torch.cat([cls_id[..., None], score[..., None], boxes], -1)
    out = box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                  topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                  force_suppress=force_suppress)
    # reference convention (multibox_detection.cc): suppressed rows carry
    # cls_id -1 too, not just score -1; callers filter on column 0
    cls_col = torch.where(out[..., 1:2] < 0, -1.0, out[..., 0:1])
    return torch.cat([cls_col, out[..., 1:]], dim=-1)


@register("_contrib_index_array")
def index_array(data, axes=None):
    """Per-element index coordinates: output shape data.shape +
    (len(axes),), int32. The grid spans the FULL data shape; ``axes`` only
    selects which coordinates are emitted (reference
    contrib/index_array.cc, which emits int64)."""
    shape = tuple(data.shape)
    axes = tuple(range(len(shape))) if axes is None else \
        tuple(int(a) for a in axes)
    grids = torch.meshgrid(*[torch.arange(n, dtype=torch.int32,
                                          device=data.device)
                             for n in shape], indexing="ij")
    return torch.stack([grids[a] for a in axes], dim=-1)


@register("_contrib_getnnz")
def getnnz(data, axis=None):
    nz = data != 0
    out = nz.sum() if axis is None else nz.sum(dim=int(axis))
    return out.to(torch.int32)


# --------------------------------------------------------------------------
# MultiBoxTarget (reference: contrib/multibox_target.cc) -- SSD training-side
# anchor matching + offset encoding
# --------------------------------------------------------------------------
@register("_contrib_MultiBoxTarget", nout=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground-truth boxes and encode regression targets.

    anchor (1, A, 4 corner), label (N, M, 5) rows [cls, xmin, ymin, xmax,
    ymax] padded with cls=-1, cls_pred (N, num_classes, A) (used only for
    hard negative mining when enabled). Returns loc_target (N, A*4),
    loc_mask (N, A*4), cls_target (N, A) where cls_target = matched class
    + 1 (0 = background, ``ignore_label`` for a negative not mined).

    Each valid ground truth's best anchor is force-matched (an anchor
    named by several goes to the last of them); any anchor whose best
    IoU exceeds overlap_threshold matches its best ground truth (the first
    of equal ones). Static shapes, no host read."""
    A = anchor.shape[-2]
    anc = anchor.reshape(A, 4)
    v = [float(x) for x in variances]
    N, M = label.shape[0], label.shape[1]
    dev = label.device
    cls = label[..., 0]                                   # (N, M)
    boxes = label[..., 1:5]                               # (N, M, 4)
    valid = cls >= 0
    iou = _pairwise_iou(anc, boxes)                       # (N, A, M)
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_gt = torch.argmax(iou, dim=2)                    # (N, A)
    best_iou = torch.amax(iou, dim=2)
    matched = best_iou > overlap_threshold
    # force-match: each valid gt claims its best anchor, the last gt of a
    # shared anchor winning; padded rows go to the spare slot A, dropped
    best_anchor = torch.argmax(iou, dim=1)                # (N, M)
    safe_anchor = torch.where(valid, best_anchor, A)
    forced_gt = torch.full((N, A + 1), -1, dtype=torch.int64, device=dev)
    rows = torch.arange(M, device=dev).expand(N, M)
    forced_gt.scatter_reduce_(1, safe_anchor, rows, reduce="amax")
    forced_gt = forced_gt[:, :A]
    forced = forced_gt >= 0
    gt_idx = torch.where(forced, forced_gt, best_gt)
    matched = matched | forced
    mb = torch.gather(boxes, 1, gt_idx[..., None].expand(N, A, 4))
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    aw = (anc[:, 2] - anc[:, 0]).clamp_min(1e-12)
    ah = (anc[:, 3] - anc[:, 1]).clamp_min(1e-12)
    gcx = (mb[..., 0] + mb[..., 2]) / 2
    gcy = (mb[..., 1] + mb[..., 3]) / 2
    gw = (mb[..., 2] - mb[..., 0]).clamp_min(1e-12)
    gh = (mb[..., 3] - mb[..., 1]).clamp_min(1e-12)
    loc_t = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                         torch.log(gw / aw) / v[2],
                         torch.log(gh / ah) / v[3]], dim=-1)   # (N, A, 4)
    loc_t = torch.where(matched[..., None], loc_t, 0.0)
    loc_m = matched[..., None].expand(N, A, 4).to(torch.float32)
    cls_t = torch.where(matched, torch.gather(cls, 1, gt_idx) + 1.0, 0.0)
    if negative_mining_ratio > 0:
        # hard negative mining: keep the top-k background anchors by the
        # background-class loss proxy (1 - P(bg)); the rest -> ignore_label.
        # Only anchors whose proxy exceeds negative_mining_thresh qualify.
        proxy = 1.0 - cls_pred[:, 0, :]                   # (N, A)
        eligible = (~matched) & (proxy > negative_mining_thresh)
        neg_score = torch.where(eligible, proxy, float("-inf"))
        k = (matched.sum(1).to(torch.float32) * negative_mining_ratio).to(
            torch.int32).clamp_min(int(minimum_negative_samples))
        order = torch.sort(-neg_score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(N, A))
        keep_neg = eligible & (rank < k[:, None])
        cls_t = torch.where(matched | keep_neg, cls_t, float(ignore_label))
    return loc_t.reshape(N, A * 4), loc_m.reshape(N, A * 4), cls_t


# --------------------------------------------------------------------------
# ROIPooling (reference: src/operator/roi_pooling.cc)
# --------------------------------------------------------------------------
def _round_half_away(x):
    """C ``round`` of float32 values: half away from zero (in float64, where
    ``|x| + 0.5`` is exact)."""
    x = x.double()
    return torch.sign(x) * torch.floor(x.abs() + 0.5)


def _window(n, levels):
    """For lengths ``n`` >= 1 (an int64 tensor): the level ``floor(log2(n))``
    and its window ``2**level``, by comparisons (no host read)."""
    level = torch.zeros_like(n)
    width = torch.ones_like(n)
    for j in range(1, levels):
        over = n >= (1 << j)
        level = torch.where(over, j, level)
        width = torch.where(over, 1 << j, width)
    return level, width


def _merge(av, ai, bv, bi):
    """The maximum of two (value, cell) pairs, the lower cell of equal
    values (MXNet's scan keeps the first maximum in row-major order)."""
    take = (bv > av) | ((bv == av) & (bi < ai))
    return torch.where(take, bv, av), torch.where(take, bi, ai)


def _sparse_table(x, Lh, Lw):
    """(value, cell) of the maximum of every [h, h + 2^lh) x [w, w + 2^lw)
    window of ``x`` (N, H, W, c), for lh < Lh, lw < Lw: two tensors of
    shape (Lh, Lw, N, H, W, c); a window that passes the map's edge holds
    the part inside it."""
    N, H, W, c = x.shape
    val = x.new_empty((Lh, Lw, N, H, W, c))
    idx = torch.empty((Lh, Lw, N, H, W, c), dtype=torch.int32,
                      device=x.device)
    val[0, 0] = x
    idx[0, 0] = torch.arange(H * W, dtype=torch.int32,
                             device=x.device).reshape(1, H, W, 1)
    for lw in range(1, Lw):  # along w, then along h
        s = 1 << (lw - 1)
        a, b = val[0, lw - 1], idx[0, lw - 1]
        val[0, lw], idx[0, lw] = a, b
        val[0, lw, :, :, :W - s], idx[0, lw, :, :, :W - s] = _merge(
            a[:, :, :W - s], b[:, :, :W - s], a[:, :, s:], b[:, :, s:])
    for lh in range(1, Lh):
        s = 1 << (lh - 1)
        a, b = val[lh - 1], idx[lh - 1]
        val[lh], idx[lh] = a, b
        val[lh, :, :, :H - s], idx[lh, :, :, :H - s] = _merge(
            a[:, :, :H - s], b[:, :, :H - s], a[:, :, s:], b[:, :, s:])
    return val, idx


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0):
    """Max ROI pooling by MXNet's integer-bin rule (roi_pooling.cc): the
    scaled corners rounded half away from zero, bin ``i`` of a roi rows
    ``[floor(i*h/ph) + y1, ceil((i+1)*h/ph) + y1)`` with ``h = max(y2 - y1
    + 1, 1)`` (columns alike) clipped to the map, the exact maximum of its
    cells (its gradient to the first maximal cell in row-major order), 0
    for an empty bin and for a roi whose batch index is negative.

    Diverges from the JAX op, which samples each bin at ``ceil(H/ph)``
    points and rounds half to even (ROADMAP section 3)."""
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    dev = data.device
    R = rois.shape[0]
    if R == 0:
        return data.new_zeros((0, C, ph, pw))
    r = rois.to(torch.float32)
    b = r[:, 0].to(torch.int64)
    live = b >= 0
    b = b.clamp(0, N - 1)
    x1, y1, x2, y2 = [_round_half_away(r[:, i] * spatial_scale).long()
                      for i in range(1, 5)]
    # true f32 quotients, as the C code's: a CUDA tensor divided by a host
    # scalar is multiplied by its reciprocal, one ulp off, which moves a
    # bin edge that lands on an integer
    ph_t, pw_t = (torch.full((), float(v), device=dev) for v in (ph, pw))
    bin_h = (y2 - y1 + 1).clamp_min(1).to(torch.float32) / ph_t
    bin_w = (x2 - x1 + 1).clamp_min(1).to(torch.float32) / pw_t
    i = torch.arange(ph, dtype=torch.float32, device=dev)
    j = torch.arange(pw, dtype=torch.float32, device=dev)
    hs = (torch.floor(i[None] * bin_h[:, None]).long()
          + y1[:, None]).clamp(0, H)
    he = (torch.ceil((i[None] + 1) * bin_h[:, None]).long()
          + y1[:, None]).clamp(0, H)
    ws = (torch.floor(j[None] * bin_w[:, None]).long()
          + x1[:, None]).clamp(0, W)
    we = (torch.ceil((j[None] + 1) * bin_w[:, None]).long()
          + x1[:, None]).clamp(0, W)
    empty = (he <= hs)[:, :, None] | (we <= ws)[:, None, :]     # (R, ph, pw)
    Lh, Lw = H.bit_length(), W.bit_length()  # floor(log2) + 1
    lh, sh = _window((he - hs).clamp_min(1), Lh)                # (R, ph)
    lw, sw = _window((we - ws).clamp_min(1), Lw)                # (R, pw)
    h_a = hs.clamp(0, H - 1)
    h_b = (he - sh).clamp(0, H - 1)
    w_a = ws.clamp(0, W - 1)
    w_b = (we - sw).clamp(0, W - 1)
    # table row of (level, image, h, w), broadcast to (R, ph, pw)
    lvl = (lh[:, :, None] * Lw + lw[:, None, :]) * N + b[:, None, None]

    def row(hh, ww):
        return ((lvl * H + hh[:, :, None]) * W + ww[:, None, :]).reshape(-1)

    corners = [row(h_a, w_a), row(h_a, w_b), row(h_b, w_a), row(h_b, w_b)]
    cells = []
    step = max(1, TABLE_ELEMS // (Lh * Lw * N * H * W))
    with torch.no_grad():
        for c0 in range(0, C, step):
            x = data[:, c0:c0 + step].permute(0, 2, 3, 1)
            val, idx = _sparse_table(x, Lh, Lw)
            c = x.shape[3]
            val, idx = val.reshape(-1, c), idx.reshape(-1, c)
            bv, bi = val[corners[0]], idx[corners[0]]
            for q in corners[1:]:
                bv, bi = _merge(bv, bi, val[q], idx[q])
            cells.append(bi)
            del val, idx
    cell = torch.cat(cells, 1) if len(cells) > 1 else cells[0]
    cell = cell.reshape(R, ph, pw, C).permute(0, 3, 1, 2).long()
    chan = torch.arange(C, device=dev)[None, :, None, None]
    lin = (b[:, None, None, None] * C + chan) * (H * W) + cell
    out = data.reshape(-1)[lin]                             # (R, C, ph, pw)
    drop = empty[:, None] | ~live[:, None, None, None]
    return torch.where(drop, torch.zeros((), dtype=data.dtype, device=dev),
                       out)

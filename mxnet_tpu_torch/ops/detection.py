"""SSD detection ops: ``MultiBoxPrior``, ``MultiBoxTarget``,
``MultiBoxDetection`` and ``smooth_l1``.

Counterpart of ``mxnet_tpu/ops/detection.py``, with its own copy of
``_attr_floats``: the same layouts, matching and NMS semantics and the
same arithmetic, term by term.  What the JAX package vmaps over the
batch is a batch dimension written out here; the bipartite matching's
``fori_loop`` over the L ground-truth slots is a Python loop of L
batched rounds.  Stable sorts throughout, as ``jnp.argsort``: invalid
rows (score -1) and the non-candidates of hard-negative mining tie.

``MultiBoxDetection`` decodes, scores and sorts in the input dtype and
returns float32 rows whatever that dtype (its class column is float32,
as the JAX op's), so its greedy NMS is always ``cuda_kernels.nms`` over
float32 rows (``csrc/nms.cu`` on the card, its plain version on the
CPU).  ``MultiBoxTarget``'s ``cls_target`` has the labels' dtype.  The
targets and the detections carry no gradient, as the JAX ops stop it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, attr_bool, attr_float
from . import cuda_kernels
from .registry import register

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "smooth_l1"]


def _attr_floats(v, default):
    if v is None:
        return tuple(default)
    s = str(v).strip().strip("()[]")
    if not s:
        return tuple(default)
    return tuple(float(x) for x in s.split(",") if x.strip())


# ---------------------------------------------------------------------------
# smooth_l1
# ---------------------------------------------------------------------------


def smooth_l1(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """0.5 (sigma x)^2 where |x| < 1/sigma^2, else |x| - 0.5/sigma^2."""
    s2 = sigma * sigma
    return torch.where(x.abs() < 1.0 / s2, 0.5 * s2 * x * x,
                       x.abs() - 0.5 / s2)


@register("smooth_l1", arg_names=("data",),
          infer_shape=lambda attrs, s: (s, [s[0]], []),
          doc="Smooth L1: 0.5(sx)^2 if |x|<1/s^2 else |x|-0.5/s^2")
def _smooth_l1_op(op_ctx, attrs, inputs, aux):
    return [smooth_l1(inputs[0], attr_float(attrs.get("scalar", 1.0), 1.0))]


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------


def _prior_counts(attrs):
    sizes = _attr_floats(attrs.get("sizes"), (1.0,))
    ratios = _attr_floats(attrs.get("ratios"), (1.0,))
    return sizes, ratios, len(sizes) + len(ratios) - 1


def multibox_prior(h: int, w: int, sizes, ratios, clip: bool = False,
                   device=None) -> torch.Tensor:
    """Anchors (1, h*w*apx, 4) ltrb of an h x w feature map: per pixel,
    ``sizes`` at ratio 1, then ``ratios[1:]`` at ``sizes[0]``."""
    step_x, step_y = 1.0 / w, 1.0 / h
    cy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * step_x
    # half-extents in float64, cast once (as the JAX package builds
    # them); host scalars, so no host-to-device copy (a CUDA graph
    # cannot record one)
    ws = [s / 2 for s in sizes] + [sizes[0] * np.sqrt(r) / 2
                                   for r in ratios[1:]]
    hs = [s / 2 for s in sizes] + [sizes[0] / np.sqrt(r) / 2
                                   for r in ratios[1:]]
    CX = cx[None, :].expand(h, w)
    CY = cy[:, None].expand(h, w)
    boxes = torch.stack([torch.stack([CX - x, CY - y, CX + x, CY + y], -1)
                         for x, y in zip(np.float32(ws).tolist(),
                                         np.float32(hs).tolist())], dim=2)
    out = boxes.reshape(1, h * w * len(ws), 4)
    return out.clamp(0.0, 1.0) if clip else out


def _multibox_prior_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, None, None
    if len(d) != 4:
        raise MXNetError("MultiBoxPrior data must be 4D (B,C,H,W)")
    _, _, apx = _prior_counts(attrs)
    return in_shapes, [(1, d[2] * d[3] * apx, 4)], []


@register("MultiBoxPrior", arg_names=("data",),
          infer_shape=_multibox_prior_infer,
          doc="Generate prior (anchor) boxes (SSD)")
def _multibox_prior_op(op_ctx, attrs, inputs, aux):
    sizes, ratios, _ = _prior_counts(attrs)
    x = inputs[0]
    return [multibox_prior(x.shape[2], x.shape[3], sizes, ratios,
                           attr_bool(attrs.get("clip"), False), x.device)]


# ---------------------------------------------------------------------------
# IoU and box encoding
# ---------------------------------------------------------------------------


def _iou_matrix(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """anchors (..., A, 4) ltrb, gt (..., L, 4) ltrb → (..., A, L) IoU."""
    al, at, ar, ab = [anchors[..., :, i:i + 1] for i in range(4)]
    gl, gt_, gr, gb = [gt[..., None, :, i] for i in range(4)]
    iw = torch.clamp(torch.minimum(ar, gr) - torch.maximum(al, gl), min=0.0)
    ih = torch.clamp(torch.minimum(ab, gb) - torch.maximum(at, gt_), min=0.0)
    inter = iw * ih
    union = ((ar - al) * (ab - at) + (gr - gl) * (gb - gt_)) - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)


def _encode_loc(anchors, gt_boxes, variances):
    """(gx-ax)/aw/vx, (gy-ay)/ah/vy, log(gw/aw)/vw, log(gh/ah)/vh;
    anchors (A, 4), gt_boxes (B, A, 4) → (B, A, 4)."""
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = gt_boxes[..., 2] - gt_boxes[..., 0]
    gh = gt_boxes[..., 3] - gt_boxes[..., 1]
    gx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5
    gy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5

    def safe(x):
        return torch.clamp(x, min=1e-12)

    return torch.stack([(gx - ax) / safe(aw) / vx,
                        (gy - ay) / safe(ah) / vy,
                        torch.log(safe(gw) / safe(aw)) / vw,
                        torch.log(safe(gh) / safe(ah)) / vh], dim=-1)


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------


def multibox_target(anchors: torch.Tensor, labels: torch.Tensor,
                    cls_preds: torch.Tensor, overlap_threshold: float = 0.5,
                    ignore_label: float = -1.0, neg_ratio: float = -1.0,
                    neg_thresh: float = 0.5,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets: anchors (1, A, 4), labels (B, L, 5) rows
    [cls, l, t, r, b] (a -1 class ends the list), cls_preds (B, C, A)
    logits → (loc_target (B, A*4), loc_mask (B, A*4), cls_target (B, A)).

    Bipartite matching first (each round takes the best remaining
    anchor/ground-truth pair), then every other anchor whose best IoU
    exceeds ``overlap_threshold``; negatives are the rest, or with
    ``neg_ratio`` > 0 the hardest ``neg_ratio`` x positives among those
    with IoU below ``neg_thresh`` (by the largest non-background
    probability).  cls_target is class + 1 for positives, 0 for
    negatives, ``ignore_label`` elsewhere."""
    anchors = anchors.reshape(-1, 4)
    B, L = labels.shape[0], labels.shape[1]
    A = anchors.shape[0]
    dev = labels.device
    bidx = torch.arange(B, device=dev)
    # a -1 class terminates the list
    valid = torch.cumprod((labels[:, :, 0] != -1.0).to(torch.int32), 1) > 0
    has_gt = valid.sum(1) > 0
    iou = _iou_matrix(anchors, labels[:, :, 1:5])  # (B, A, L)
    iou = torch.where(valid[:, None, :], iou, -1.0)

    # stage 1: bipartite matching, the best remaining pair per round
    a_matched = torch.zeros((B, A), dtype=torch.bool, device=dev)
    g_matched = ~valid  # invalid slots never match
    match_gt = torch.full((B, A), -1, dtype=torch.long, device=dev)
    match_iou = torch.full((B, A), -1.0, dtype=torch.float32, device=dev)
    for _ in range(L):
        m = torch.where(a_matched[:, :, None] | g_matched[:, None, :],
                        -torch.inf, iou).reshape(B, A * L)
        flat = torch.argmax(m, dim=1)  # the first maximum, as jnp.argmax
        ai, gi = flat // L, flat % L
        best = m[bidx, flat]
        take = best > 1e-6
        a_matched[bidx, ai] |= take
        g_matched[bidx, gi] |= take
        match_gt[bidx, ai] = torch.where(take, gi, match_gt[bidx, ai])
        match_iou[bidx, ai] = torch.where(take, best, match_iou[bidx, ai])

    # stage 2: threshold matching for the rest
    best_iou = iou.max(dim=2).values
    best_gt = torch.argmax(iou, dim=2)  # the first maximum
    match_gt = torch.where(a_matched, match_gt, best_gt)
    match_iou = torch.where(a_matched, match_iou, best_iou)
    positive = (a_matched | (best_iou > overlap_threshold)) & has_gt[:, None]

    # stage 3: negatives (hard mining, or all the rest)
    if neg_ratio > 0:
        num_positive = positive.sum(1)
        num_negative = torch.minimum(
            (num_positive * neg_ratio).to(torch.float32).to(torch.int64),
            A - num_positive)
        m = torch.max(cls_preds, dim=1).values  # (B, A)
        p = torch.exp(cls_preds - m[:, None])
        prob_pos = torch.max(p[:, 1:], dim=1).values / torch.sum(p, dim=1)
        cand = ~positive & (match_iou < neg_thresh) & (match_iou >= 0)
        score = torch.where(cand, prob_pos, -torch.inf)
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(B, A))
        negative = cand & (rank < num_negative[:, None])
    else:
        negative = ~positive & has_gt[:, None]

    # stage 4: emit the targets
    gt = torch.gather(labels, 1, match_gt[:, :, None].expand(B, A, 5))
    loc_t = _encode_loc(anchors, gt[..., 1:5], variances)
    loc_target = torch.where(positive[..., None], loc_t, 0.0).reshape(B, -1)
    loc_mask = positive[..., None].expand(B, A, 4).to(
        torch.float32).reshape(B, -1)
    # the labels' dtype, as the JAX op's weakly typed scalars keep it
    cls_target = torch.where(positive, gt[..., 0] + 1.0,
                             torch.where(negative, 0.0, ignore_label).to(
                                 labels.dtype))
    return loc_target, loc_mask, cls_target


def _multibox_target_infer(attrs, in_shapes):
    a, l, c = in_shapes
    if a is None or l is None or c is None:
        return in_shapes, None, None
    num_anchors = a[-2]
    b = l[0]
    return in_shapes, [(b, num_anchors * 4), (b, num_anchors * 4),
                       (b, num_anchors)], []


@register("MultiBoxTarget", arg_names=("anchor", "label", "cls_pred"),
          out_names=("loc_target", "loc_mask", "cls_target"),
          infer_shape=_multibox_target_infer,
          doc="Compute SSD training targets")
def _multibox_target_op(op_ctx, attrs, inputs, aux):
    anchors, labels, cls_preds = (x.detach() for x in inputs)
    return list(multibox_target(
        anchors, labels, cls_preds,
        overlap_threshold=attr_float(attrs.get("overlap_threshold", 0.5),
                                     0.5),
        ignore_label=attr_float(attrs.get("ignore_label", -1.0), -1.0),
        neg_ratio=attr_float(attrs.get("negative_mining_ratio", -1.0), -1.0),
        neg_thresh=attr_float(attrs.get("negative_mining_thresh", 0.5), 0.5),
        variances=_attr_floats(attrs.get("variances"),
                               (0.1, 0.1, 0.2, 0.2))))


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------


def multibox_detection(cls_prob: torch.Tensor, loc_pred: torch.Tensor,
                       anchors: torch.Tensor, threshold: float = 0.01,
                       clip: bool = True, nms_threshold: float = 0.5,
                       force_suppress: bool = False,
                       variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """Decode and suppress: cls_prob (B, C, A), loc_pred (B, A*4),
    anchors (1, A, 4) → float32 rows (B, A, 6) [cls, score, l, t, r, b]
    sorted by score; rows below ``threshold`` and rows NMS suppresses have
    cls -1 (the first also score -1)."""
    anchors = anchors.reshape(-1, 4)
    B, C, A = cls_prob.shape
    vx, vy, vw, vh = variances
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    lp = loc_pred.reshape(B, A, 4)
    ox = lp[..., 0] * vx * aw + ax
    oy = lp[..., 1] * vy * ah + ay
    ow = torch.exp(lp[..., 2] * vw) * aw / 2
    oh = torch.exp(lp[..., 3] * vh) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    score = torch.max(cls_prob[:, 1:], dim=1).values  # best non-background
    # float32 class ids make float32 rows, as the JAX op's concatenate
    # promotes them; the score and boxes keep their rounding
    cid = torch.argmax(cls_prob[:, 1:], dim=1).to(torch.float32)
    keep = score >= threshold
    cid = torch.where(keep, cid, -1.0)
    score = torch.where(keep, score, -1.0)
    rows = torch.cat([cid[..., None], score[..., None].float(),
                      boxes.float()], dim=-1)
    order = torch.argsort(-score, dim=1, stable=True)  # invalid rows sink
    rows = torch.gather(rows, 1, order[..., None].expand(B, A, 6))
    if 0 < nms_threshold <= 1:
        rows = cuda_kernels.nms(rows.contiguous(), nms_threshold,
                                force_suppress)
    return rows


def _multibox_detection_infer(attrs, in_shapes):
    c, l, a = in_shapes
    if c is None:
        return in_shapes, None, None
    return in_shapes, [(c[0], c[2], 6)], []


@register("MultiBoxDetection", arg_names=("cls_prob", "loc_pred", "anchor"),
          infer_shape=_multibox_detection_infer,
          kernel=True,
          doc="Decode + NMS multibox predictions")
def _multibox_detection_op(op_ctx, attrs, inputs, aux):
    cls_prob, loc_pred, anchors = (x.detach() for x in inputs)
    return [multibox_detection(
        cls_prob, loc_pred, anchors,
        threshold=attr_float(attrs.get("threshold", 0.01), 0.01),
        clip=attr_bool(attrs.get("clip", True), True),
        nms_threshold=attr_float(attrs.get("nms_threshold", 0.5), 0.5),
        force_suppress=attr_bool(attrs.get("force_suppress", False), False),
        variances=_attr_floats(attrs.get("variances"),
                               (0.1, 0.1, 0.2, 0.2)))]

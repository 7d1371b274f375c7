"""ATSS training loss (port of paa_tpu/modeling/atss_loss.py; reference
paa_core/modeling/rpn/atss/loss.py), batched on the device.

- POSITIVE_TYPE 'ATSS' (loss.py:131-186): per (GT, level) the TOPK
  anchors nearest by centre distance are candidates (k argmin passes,
  first index on ties); the IoU threshold is the candidates' IoU mean +
  std (divisor k - 1) per GT, reached with ``>=``; a positive's anchor
  centre must lie inside its GT by more than 0.01; an anchor claimed by
  several GTs goes to the one of highest IoU (the first on ties).
- 'IoU' (loss.py:188-224): the matcher at FG/BG thresholds with
  low-quality matches, then positives whose anchor centre is not inside
  the GT become ignored (-1).
- 'SSC' (loss.py:93-131): FCOS's constraints at the anchor centres
  (inside the GT by 0.01, the largest distance within the level's size
  range), conflicts to the smallest GT.
- Losses (loss.py:241-276): focal over the positive count; GIoU weighted
  by the centerness targets over their sum, times REG_LOSS_WEIGHT; the
  centerness BCE over the positive count. With USE_IOU_PRED the branch
  learns the IoU of the decoded box with its GT and weights the GIoU
  (PAA's rule). Without a branch: GIoU over the positive count.
  Under a process group the positive count and the weight sum are
  summed over the ranks and divided as ``paa_loss`` divides them, so
  DDP's gradient mean gives the global batch's step.

Candidate counts are fixed (TOPK per level), so only padded GTs need a
mask. The two stages run inside ``record_function`` spans
(``SPAN_ASSIGN``, ``SPAN_LOSSES``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..ops.focal_loss import sigmoid_focal_loss
from ..structures.boxes import box_iou
from ..utils import comm
from .box_coder import decode_box, encode_box
from .matcher import match_anchors
from .paa_loss import bce_with_logits, bottom_k_iterative, giou_loss

INF = 1e8
SPAN_ASSIGN = "atss_loss/assignment"
SPAN_LOSSES = "atss_loss/losses"
SSC_OBJECT_SIZES = ((-1.0, 64.0), (64.0, 128.0), (128.0, 256.0),
                    (256.0, 512.0), (512.0, INF))


@dataclass(frozen=True)
class ATSSLossConfig:
    gamma: float = 2.0
    alpha: float = 0.25
    topk: int = 9
    fg_iou_threshold: float = 0.5
    bg_iou_threshold: float = 0.4
    reg_loss_weight: float = 2.0
    positive_type: str = "ATSS"
    use_iou_pred: bool = False
    iou_loss_weight: float = 0.5

    @staticmethod
    def from_cfg(cfg):
        a = cfg.MODEL.ATSS
        return ATSSLossConfig(
            gamma=a.LOSS_GAMMA,
            alpha=a.LOSS_ALPHA,
            topk=a.TOPK,
            fg_iou_threshold=a.FG_IOU_THRESHOLD,
            bg_iou_threshold=a.BG_IOU_THRESHOLD,
            reg_loss_weight=a.REG_LOSS_WEIGHT,
            positive_type=a.POSITIVE_TYPE,
            use_iou_pred=a.USE_IOU_PRED,
            iou_loss_weight=a.IOU_LOSS_WEIGHT,
        )


def _centers(boxes):
    return ((boxes[..., 2] + boxes[..., 0]) / 2.0,
            (boxes[..., 3] + boxes[..., 1]) / 2.0)


def _labels_of(gt_labels, assigned, is_assigned):
    """The assigned GT's label where ``is_assigned``, else 0; int32."""
    return torch.where(is_assigned, gt_labels.gather(1, assigned.long()),
                       torch.zeros((), dtype=gt_labels.dtype,
                                   device=gt_labels.device)).to(torch.int32)


def atss_assign(gt_boxes, gt_labels, anchors, level_counts, topk):
    """gt_boxes (B, G, 4), gt_labels (B, G) (0 = padding), anchors (N, 4).
    Returns labels (B, N) int32 (0 background) and the assigned GT
    (B, N) int32."""
    bsz, num_gt = gt_labels.shape
    n = anchors.shape[0]
    gt_valid = gt_labels > 0
    iou_t = box_iou(gt_boxes, anchors[None])  # (B, G, N)

    acx, acy = _centers(anchors)
    gcx, gcy = _centers(gt_boxes)  # (B, G)
    dist = torch.sqrt((acx[None, None, :] - gcx[..., None]) ** 2
                      + (acy[None, None, :] - gcy[..., None]) ** 2)

    cand_chunks = []
    start = 0
    for count in level_counts:
        _, idx = bottom_k_iterative(dist[..., start:start + count],
                                    min(topk, count))
        cand_chunks.append(idx + start)
        start += count
    cand_idx = torch.cat(cand_chunks, dim=-1)  # (B, G, K)

    cand_ious = iou_t.gather(-1, cand_idx)
    k_total = cand_ious.shape[-1]
    mean = cand_ious.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((cand_ious - mean) ** 2).sum(dim=-1, keepdim=True)
                     / max(k_total - 1, 1))
    is_pos = cand_ious >= mean + std

    ccx, ccy = acx[cand_idx], acy[cand_idx]  # (B, G, K)
    l = ccx - gt_boxes[..., 0:1]
    t = ccy - gt_boxes[..., 1:2]
    r = gt_boxes[..., 2:3] - ccx
    b = gt_boxes[..., 3:4] - ccy
    in_gt = torch.minimum(torch.minimum(l, r), torch.minimum(t, b)) > 0.01
    is_pos = is_pos & in_gt & gt_valid[:, :, None]

    # a GT's candidates are distinct anchors, so a plain scatter writes
    # each (GT, anchor) once
    pos_gn = torch.zeros(bsz, num_gt, n, dtype=torch.bool,
                         device=anchors.device)
    pos_gn.scatter_(-1, cand_idx, is_pos)
    ious_inf = torch.where(pos_gn, iou_t,
                           torch.full((), -INF, device=anchors.device))
    best_val, assigned = ious_inf.max(dim=1)  # first GT on ties
    assigned = assigned.to(torch.int32)
    return _labels_of(gt_labels, assigned, best_val > -INF / 2), assigned


def _level_ranges(level_counts, device):
    """Per-anchor (lo, hi) of SSC_OBJECT_SIZES, (N,) each."""
    lo = torch.cat([torch.full((c,), SSC_OBJECT_SIZES[i][0])
                    for i, c in enumerate(level_counts)])
    hi = torch.cat([torch.full((c,), SSC_OBJECT_SIZES[i][1])
                    for i, c in enumerate(level_counts)])
    return lo.to(device), hi.to(device)


def ssc_assign(gt_boxes, gt_labels, anchors, level_counts):
    """POSITIVE_TYPE 'SSC': inside the GT by 0.01 at the anchor centre,
    the largest of l/t/r/b within the level's size range, conflicts to
    the smallest GT (+1 areas; the first on ties). Returns (labels,
    assigned) as ``atss_assign``."""
    gt_valid = gt_labels > 0
    acx, acy = _centers(anchors)
    l = acx[None, :, None] - gt_boxes[:, None, :, 0]  # (B, N, G)
    t = acy[None, :, None] - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - acx[None, :, None]
    b = gt_boxes[:, None, :, 3] - acy[None, :, None]
    reg = torch.stack([l, t, r, b], dim=-1)
    in_box = reg.amin(dim=-1) > 0.01
    lo, hi = _level_ranges(level_counts, anchors.device)
    max_reg = reg.amax(dim=-1)
    cared = (max_reg >= lo[None, :, None]) & (max_reg <= hi[None, :, None])
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0)
            * (gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0))  # (B, G)
    loc_area = torch.where(in_box & cared & gt_valid[:, None, :],
                           area[:, None, :],
                           torch.full((), INF, device=anchors.device))
    min_area, assigned = loc_area.min(dim=-1)
    assigned = assigned.to(torch.int32)
    return _labels_of(gt_labels, assigned, min_area < INF), assigned


def iou_assign(gt_boxes, gt_labels, anchors, fg_thresh, bg_thresh):
    """POSITIVE_TYPE 'IoU': the matcher with low-quality matches, then
    positives whose anchor centre is not inside the GT by 0.01 become
    ignored (-1). Returns (labels with -1 ignored, the matched GT clamped
    to >= 0)."""
    gt_valid = gt_labels > 0
    matched = match_anchors(box_iou(gt_boxes, anchors[None]), gt_valid,
                            fg_thresh, bg_thresh,
                            allow_low_quality_matches=True)
    clamped = matched.clamp(min=0)
    labels = torch.where(
        matched >= 0, gt_labels.gather(1, clamped.long()),
        torch.where(matched == -2, -1, 0).to(gt_labels.dtype))
    matched_boxes = gt_boxes.gather(
        1, clamped.long()[:, :, None].expand(-1, -1, 4))
    acx, acy = _centers(anchors)
    l = acx[None] - matched_boxes[..., 0]
    t = acy[None] - matched_boxes[..., 1]
    r = matched_boxes[..., 2] - acx[None]
    b = matched_boxes[..., 3] - acy[None]
    in_gt = torch.minimum(torch.minimum(l, r), torch.minimum(t, b)) > 0.01
    labels = torch.where((labels > 0) & ~in_gt, -1, labels)
    return labels.to(torch.int32), clamped


def compute_centerness_targets(reg_targets, anchors):
    """sqrt((min/max of l, r) * (min/max of t, b)) of the decoded GT
    about the anchor centre (loss.py:226-240)."""
    gts = decode_box(reg_targets, anchors)
    acx, acy = _centers(anchors)
    l = acx - gts[..., 0]
    t = acy - gts[..., 1]
    r = gts[..., 2] - acx
    b = gts[..., 3] - acy
    ratio = ((torch.minimum(l, r) / torch.maximum(l, r))
             * (torch.minimum(t, b) / torch.maximum(t, b)))
    return torch.sqrt(ratio.clamp(min=0.0))


def pairwise_iou_aligned(boxes_a, boxes_b):
    """Elementwise IoU of aligned (..., 4) boxes, +1 convention, widths
    and the union clamped (paa_tpu's ``_pairwise_iou_aligned``)."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1) + 1).clamp(
        min=0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1) + 1).clamp(
        min=0.0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1).clamp(min=0.0) * (ay2 - ay1 + 1).clamp(min=0.0)
    area_b = (bx2 - bx1 + 1).clamp(min=0.0) * (by2 - by1 + 1).clamp(min=0.0)
    return inter / (area_a + area_b - inter).clamp(min=1e-6)


def atss_assignment(gt_boxes, gt_labels, anchors, level_counts, lc):
    """(labels, assigned) of ``lc.positive_type``."""
    if lc.positive_type == "ATSS":
        return atss_assign(gt_boxes, gt_labels, anchors, level_counts,
                           lc.topk)
    if lc.positive_type == "IoU":
        return iou_assign(gt_boxes, gt_labels, anchors,
                          lc.fg_iou_threshold, lc.bg_iou_threshold)
    if lc.positive_type == "SSC":
        return ssc_assign(gt_boxes, gt_labels, anchors, level_counts)
    raise NotImplementedError(lc.positive_type)


def atss_loss(outputs, gt_boxes, gt_labels, anchors, level_counts, lc):
    """The ATSS losses of one batch: outputs 'cls_logits' (B, N, C),
    'box_regression' (B, N, 4) and, unless the head has no branch,
    'iou_pred' (B, N) (centerness or IoU logits); gt_boxes (B, G, 4),
    gt_labels (B, G) (0 = padding); anchors (N, 4); lc: ATSSLossConfig.
    Returns {loss_cls, loss_reg[, loss_centerness], num_pos}."""
    cls_logits = outputs["cls_logits"].to(torch.float32)
    box_regression = outputs["box_regression"].to(torch.float32)
    centerness = outputs.get("iou_pred")
    if centerness is not None:
        centerness = centerness.to(torch.float32)
    anchors = anchors.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)

    with record_function(SPAN_ASSIGN):
        labels, assigned = atss_assignment(gt_boxes, gt_labels, anchors,
                                           level_counts, lc)
        matched_boxes = gt_boxes.gather(
            1, assigned.long()[:, :, None].expand(-1, -1, 4))
        reg_targets = encode_box(matched_boxes, anchors[None])

    with record_function(SPAN_LOSSES):
        pos = labels > 0
        posf = pos.to(torch.float32)
        world = comm.get_world_size()
        num_pos = comm.all_reduce_sum(posf.sum())
        num_pos_norm = num_pos.clamp(min=float(world)) / world
        loss_cls = sigmoid_focal_loss(cls_logits, labels, lc.gamma,
                                      lc.alpha).sum() / num_pos_norm
        reg = giou_loss(box_regression, reg_targets, anchors[None])
        out = {"loss_cls": loss_cls, "num_pos": num_pos}
        if centerness is None:
            # no branch: GIoU over the positive count
            out["loss_reg"] = ((reg * posf).sum() / num_pos_norm
                               * lc.reg_loss_weight)
            return out
        if lc.use_iou_pred:
            # the branch learns the IoU of the decoded box with its GT,
            # which weights the GIoU (paa/loss.py:328-337)
            pred_boxes = decode_box(box_regression, anchors[None])
            targets = torch.where(
                pos, pairwise_iou_aligned(pred_boxes, matched_boxes),
                0.0).detach()
            branch = (bce_with_logits(centerness, targets) * posf).sum() \
                / num_pos_norm * lc.iou_loss_weight
        else:
            targets = torch.where(
                pos, compute_centerness_targets(reg_targets, anchors[None]),
                0.0)
            branch = (bce_with_logits(centerness, targets) * posf).sum() \
                / num_pos_norm
        reg_norm = comm.all_reduce_sum(targets.sum()).clamp(
            min=1e-6) / world
        out["loss_reg"] = ((reg * targets).sum() / reg_norm
                           * lc.reg_loss_weight)
        out["loss_centerness"] = branch
    return out

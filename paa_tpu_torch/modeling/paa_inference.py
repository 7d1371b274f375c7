"""PAA post-processing (port of paa_tpu/modeling/paa_inference.py,
reference paa_core/modeling/rpn/paa/inference.py).

Per level: the INFERENCE_TH threshold on the raw cls scores (compared in
float32 logit space), score fusion ``sqrt(cls * iou_pred)``, per-image
selection of PRE_NMS_TOP_N candidates, decode. Across levels: clip,
one batched class-aware NMS (ops/nms.py, the CUDA kernel on the card)
emitting DETECTIONS_PER_IMG picks, then optional score voting.

Static shapes throughout, with validity masks, like the JAX package:
each level yields exactly min(PRE_NMS_TOP_N, n * C) candidate slots, so
the NMS input of the PAA-R50 model at 800x1344 is (B, 5000).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.nms import nms_batched
from ..structures.boxes import box_iou, clip_to_image
from .box_coder import decode_box

_SCORE_VOTING_SIGMA = 0.025  # reference inference.py:128
_IOU_VOTE_MIN = 0.01  # reference inference.py:141
_SMALL_TIER = 128


def _logit(th):
    """sigmoid(x) > th  <=>  x.float() > logit(th), with the threshold
    rounded to float32 as in the JAX package (comparing in bf16 would
    drop borderline candidates)."""
    return torch.tensor(math.log(th) - math.log1p(-th), dtype=torch.float32)


@dataclass(frozen=True)
class PostProcessConfig:
    pre_nms_thresh: float = 0.05
    pre_nms_top_n: int = 1000
    nms_thresh: float = 0.6
    detections_per_img: int = 100
    num_classes: int = 80  # WITHOUT background
    score_voting: bool = True

    @staticmethod
    def from_cfg(cfg):
        return PostProcessConfig(
            pre_nms_thresh=cfg.MODEL.PAA.INFERENCE_TH,
            pre_nms_top_n=cfg.MODEL.PAA.PRE_NMS_TOP_N,
            nms_thresh=cfg.MODEL.PAA.NMS_TH,
            detections_per_img=cfg.TEST.DETECTIONS_PER_IMG,
            num_classes=cfg.MODEL.PAA.NUM_CLASSES - 1,
            score_voting=cfg.MODEL.PAA.INFERENCE_SCORE_VOTING,
        )


def _select_level_batched(cls_logits, box_regression, iou_pred, anchors,
                          pp):
    """Candidate selection of one level for the whole batch.

    cls_logits (B, n, C); box_regression (B, n, 4); iou_pred (B, n);
    anchors (n, 4). Returns boxes (B, K, 4), scores (B, K), labels
    (B, K) int32 and valid (B, K) with K = min(pre_nms_top_n, n * C).

    Three tiers, chosen on the data exactly as the JAX package chooses
    them, because the candidate order (and so NMS's keep_idx) depends on
    the tier: when no image has more than 128 (or more than K)
    thresholded candidates they are emitted in index order into 128 (or
    K) slots; otherwise the top K by fused score, ties to the lower
    index. The choice reads the largest count on the host: one sync per
    level, which eager PyTorch can afford where XLA needed a lax.cond.
    """
    bsz, n, c = cls_logits.shape
    m_flat = n * c
    k = min(pp.pre_nms_top_n, m_flat)
    dev = cls_logits.device
    logits = cls_logits.to(torch.float32).reshape(bsz, m_flat)
    cand = logits > _logit(pp.pre_nms_thresh).to(dev)
    total = cand.sum(dim=1)
    max_cand = int(total.max())
    small = min(_SMALL_TIER, k)

    if max_cand <= k:  # compaction: the first kk candidates, index order
        kk = small if max_cand <= small else k
        rank = torch.cumsum(cand, dim=1)
        slot = torch.where(cand & (rank <= kk), rank - 1, kk)
        flat_idx = torch.zeros(bsz, kk + 1, dtype=torch.int64, device=dev)
        flat_idx.scatter_(
            1, slot, torch.arange(m_flat, device=dev).expand(bsz, m_flat))
        flat_idx = flat_idx[:, :kk]
        sel_iou = iou_pred.to(torch.float32).gather(1, flat_idx // c)
        score = torch.sqrt(torch.sigmoid(logits.gather(1, flat_idx))
                           * torch.sigmoid(sel_iou))
        slot_valid = (torch.arange(1, kk + 1, device=dev)[None, :]
                      <= total[:, None])
        score = torch.where(slot_valid, score, -1.0)
    else:  # top k in score order; a stable sort breaks ties like top_k
        kk = k
        fused = torch.sqrt(
            torch.sigmoid(logits).reshape(bsz, n, c)
            * torch.sigmoid(iou_pred.to(torch.float32))[..., None])
        masked = torch.where(cand, fused.reshape(bsz, m_flat), -1.0)
        score, flat_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
        score, flat_idx = score[:, :k], flat_idx[:, :k]

    anchor_idx = flat_idx // c
    labels = (flat_idx % c + 1).to(torch.int32)
    reg_sel = box_regression.to(torch.float32).gather(
        1, anchor_idx[..., None].expand(bsz, kk, 4))
    boxes = decode_box(reg_sel, anchors[anchor_idx])
    if kk < k:  # pad to the static k slots; padding is invalid
        pad = k - kk
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        score = torch.nn.functional.pad(score, (0, pad), value=-1.0)
        labels = torch.nn.functional.pad(labels, (0, pad))
    return boxes, score, labels, score > 0.0


def _score_vote(kept_boxes, kept_labels, kept_valid,
                cand_boxes, cand_scores, cand_labels, cand_valid):
    """Score voting (reference inference.py:123-157), batched: kept
    (B, D, ...) against candidates (B, K, ...)."""
    ious = box_iou(kept_boxes, cand_boxes)  # (B, D, K), +1 convention
    same_label = kept_labels[:, :, None] == cand_labels[:, None, :]
    pos = (ious > _IOU_VOTE_MIN) & same_label & cand_valid[:, None, :]
    pis = torch.where(
        pos,
        torch.exp(-((1.0 - ious) ** 2) / _SCORE_VOTING_SIGMA)
        * cand_scores[:, None, :],
        0.0,
    )
    denom = pis.sum(dim=2, keepdim=True)
    voted = torch.bmm(pis, cand_boxes) / denom.clamp(min=1e-12)
    use_vote = (denom[..., 0] > 0) & kept_valid
    return torch.where(use_vote[..., None], voted, kept_boxes)


def paa_candidates(outputs, image_sizes, anchors, level_counts, pp):
    """The NMS input: per-level selection, concatenated and clipped.

    Returns boxes (B, K, 4) float32, scores (B, K) float32, labels
    (B, K) int32 and valid (B, K) bool, K = sum of per-level slots."""
    parts = []
    start = 0
    for count in level_counts:
        sl = slice(start, start + count)
        parts.append(_select_level_batched(
            outputs["cls_logits"][:, sl],
            outputs["box_regression"][:, sl],
            outputs["iou_pred"][:, sl],
            anchors[sl],
            pp,
        ))
        start += count
    boxes, scores, labels, valid = (
        torch.cat([p[j] for p in parts], dim=1) for j in range(4)
    )
    # (B, 2) sizes broadcast as (B, 1) against the (B, K) coordinates
    boxes = clip_to_image(boxes, image_sizes.to(boxes.dtype))
    return boxes, scores, labels, valid


def paa_postprocess(outputs, image_sizes, anchors, level_counts, pp):
    """Batched post-processing.

    outputs: dict with 'cls_logits' (B, N, C), 'box_regression' (B, N, 4)
    and 'iou_pred' (B, N); image_sizes (B, 2) (h, w) of the
    un-padded content; anchors (N, 4) float32 on the same device;
    level_counts: per-level anchor counts summing to N.

    Returns a dict of (B, detections_per_img, ...) tensors: boxes,
    scores, labels (int32) and valid (bool)."""
    boxes, scores, labels, valid = paa_candidates(
        outputs, image_sizes, anchors, level_counts, pp)
    keep_idx, keep_scores, keep_valid = nms_batched(
        boxes, scores, labels, valid, pp.nms_thresh,
        pp.detections_per_img, class_aware=True,
    )
    keep = keep_idx.to(torch.int64)
    kept_boxes = boxes.gather(1, keep[..., None].expand(*keep.shape, 4))
    kept_labels = labels.gather(1, keep)
    if pp.score_voting:
        kept_boxes = _score_vote(kept_boxes, kept_labels, keep_valid,
                                 boxes, scores, labels, valid)
    return {
        "boxes": torch.where(keep_valid[..., None], kept_boxes, 0.0),
        "scores": torch.where(keep_valid, keep_scores, 0.0),
        "labels": torch.where(keep_valid, kept_labels, 0),
        "valid": keep_valid,
    }

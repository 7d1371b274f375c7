"""PAA post-processing (port of paa_tpu/modeling/paa_inference.py,
reference paa_core/modeling/rpn/paa/inference.py).

Per level: the INFERENCE_TH threshold on the raw cls scores (compared in
float32 logit space), score fusion ``sqrt(cls * iou_pred)`` (``sigmoid(cls)``
for a head without the branch: RetinaNet, the ATSS ablation without
one, PAA with USE_IOU_PRED off), per-image selection of PRE_NMS_TOP_N
candidates, decode (anchor deltas, or FCOS's l/t/r/b distances through
``decode_fn`` after a per-level ``reg_scale``). Across levels: clip,
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
from torch.profiler import record_function

from ..ops.nms import nms_batched
from ..structures.boxes import box_iou, clip_to_image
from .box_coder import decode_box

_SCORE_VOTING_SIGMA = 0.025  # reference inference.py:128
_IOU_VOTE_MIN = 0.01  # reference inference.py:141
_SMALL_TIER = 128
# the span of the whole post-processing, which the benchmark's
# serve.postprocess_ms and serve.postprocess_idle_ms read, and the one
# around each level's host read of its largest candidate count
# (serve.sync_idle_ms reads the idle gaps that open inside it)
SPAN_POSTPROCESS = "detector/postprocess"
SPAN_SYNC_TIER = "sync/select_tier"


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


def _fuse(cls_prob, iou_logits):
    """sqrt(cls * sigmoid(iou)), or the cls score without a branch."""
    if iou_logits is None:
        return cls_prob
    return torch.sqrt(cls_prob * torch.sigmoid(iou_logits.to(torch.float32)))


def _select_level_batched(cls_logits, box_regression, iou_pred, anchors,
                          pp, decode_fn=None, reg_scale=1.0):
    """Candidate selection of one level for the whole batch.

    cls_logits (B, n, C); box_regression (B, n, 4); iou_pred (B, n) or
    None; anchors (n, 4). ``decode_fn(reg, anchors)`` replaces the
    anchor-delta decode (FCOS's ``decode_ltrb``), and the regression is
    multiplied by ``reg_scale`` before it (FCOS's NORM_REG_TARGETS
    stride). Returns boxes (B, K, 4), scores (B, K), labels (B, K) int32
    and valid (B, K) with K = min(pre_nms_top_n, n * C).

    Three tiers, chosen on the data exactly as the JAX package chooses
    them, because the candidate order (and so NMS's keep_idx) depends on
    the tier: when no image has more than 128 (or more than K)
    thresholded candidates they are emitted in index order into 128 (or
    K) slots; otherwise the top K by fused score, ties to the lower
    index. The choice reads the largest count on the host: one sync per
    level, which eager PyTorch can afford where XLA needed a lax.cond.
    Under ``torch.export`` (serving.py) the choice is ``torch.cond`` on
    the device, as the JAX package's lax.cond, with the same tiers.
    """
    bsz, n, c = cls_logits.shape
    m_flat = n * c
    k = min(pp.pre_nms_top_n, m_flat)
    dev = cls_logits.device
    logits = cls_logits.to(torch.float32).reshape(bsz, m_flat)
    cand = logits > _logit(pp.pre_nms_thresh).to(dev)
    total = cand.sum(dim=1)
    small = min(_SMALL_TIER, k)

    def compaction(kk):  # the first kk candidates, index order
        def tier(logits, cand, total, *iou):
            rank = torch.cumsum(cand, dim=1)
            slot = torch.where(cand & (rank <= kk), rank - 1, kk)
            flat_idx = torch.zeros(bsz, kk + 1, dtype=torch.int64,
                                   device=dev).scatter(
                1, slot, torch.arange(m_flat, device=dev).expand(bsz,
                                                                 m_flat))
            flat_idx = flat_idx[:, :kk]
            score = _fuse(torch.sigmoid(logits.gather(1, flat_idx)),
                          iou[0].gather(1, flat_idx // c) if iou else None)
            slot_valid = (torch.arange(1, kk + 1, device=dev)[None, :]
                          <= total[:, None])
            return pad(flat_idx, torch.where(slot_valid, score, -1.0))
        return tier

    def top_k(logits, cand, total, *iou):
        # top k in score order; a stable sort breaks ties like top_k
        fused = _fuse(torch.sigmoid(logits).reshape(bsz, n, c),
                      iou[0][..., None] if iou else None)
        masked = torch.where(cand, fused.reshape(bsz, m_flat), -1.0)
        score, flat_idx = torch.sort(masked, dim=1, descending=True,
                                     stable=True)
        return pad(flat_idx[:, :k], score[:, :k])

    def pad(flat_idx, score):
        """The k static slots (the ones past kk invalid) and a mask of
        the padding, each a fresh dense tensor: torch.cond's branches
        must agree in strides, also those of a batch of one."""
        kk = flat_idx.shape[1]
        dense = torch.contiguous_format
        padded = torch.arange(k, device=dev)[None, :].expand(bsz, k) >= kk
        return (torch.nn.functional.pad(flat_idx, (0, k - kk)).clone(
                    memory_format=dense),
                torch.nn.functional.pad(score, (0, k - kk), value=-1.0
                                        ).clone(memory_format=dense),
                padded.clone(memory_format=dense))

    operands = (logits, cand, total,
                *(() if iou_pred is None else (iou_pred,)))
    if torch.compiler.is_exporting():
        max_cand = total.max()

        def above_small(*ops):
            return torch.cond(max_cand <= k, compaction(k), top_k, ops)

        flat_idx, score, padded = torch.cond(
            max_cand <= small, compaction(small), above_small, operands)
    else:
        with record_function(SPAN_SYNC_TIER):
            max_cand = int(total.max())
        tier = (compaction(small) if max_cand <= small else
                compaction(k) if max_cand <= k else top_k)
        flat_idx, score, padded = tier(*operands)

    anchor_idx = flat_idx // c
    labels = (flat_idx % c + 1).to(torch.int32)
    reg_sel = box_regression.to(torch.float32).gather(
        1, anchor_idx[..., None].expand(bsz, k, 4))
    boxes = (decode_fn or decode_box)(reg_sel * reg_scale,
                                      anchors[anchor_idx])
    # the padding slots hold zeros, as the JAX package pads them
    boxes = torch.where(padded[..., None], 0.0, boxes)
    labels = torch.where(padded, 0, labels)
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


def paa_candidates(outputs, image_sizes, anchors, level_counts, pp,
                   decode_fn=None, reg_scales=None):
    """The NMS input: per-level selection, concatenated and clipped.
    ``decode_fn`` and the per-level ``reg_scales`` as in
    ``_select_level_batched``.

    Returns boxes (B, K, 4) float32, scores (B, K) float32, labels
    (B, K) int32 and valid (B, K) bool, K = sum of per-level slots."""
    iou_pred = outputs.get("iou_pred")
    parts = []
    start = 0
    for level, count in enumerate(level_counts):
        sl = slice(start, start + count)
        parts.append(_select_level_batched(
            outputs["cls_logits"][:, sl],
            outputs["box_regression"][:, sl],
            None if iou_pred is None else iou_pred[:, sl],
            anchors[sl],
            pp,
            decode_fn=decode_fn,
            reg_scale=1.0 if reg_scales is None else reg_scales[level],
        ))
        start += count
    boxes, scores, labels, valid = (
        torch.cat([p[j] for p in parts], dim=1) for j in range(4)
    )
    # (B, 2) sizes broadcast as (B, 1) against the (B, K) coordinates
    boxes = clip_to_image(boxes, image_sizes.to(boxes.dtype))
    return boxes, scores, labels, valid


def paa_postprocess(outputs, image_sizes, anchors, level_counts, pp,
                    decode_fn=None, reg_scales=None):
    """Batched post-processing.

    outputs: dict with 'cls_logits' (B, N, C), 'box_regression' (B, N, 4)
    and optionally 'iou_pred' (B, N); image_sizes (B, 2) (h, w) of the
    un-padded content; anchors (N, 4) float32 on the same device (FCOS:
    its points tiled to (x, y, x, y)); level_counts: per-level anchor
    counts summing to N; ``decode_fn`` and ``reg_scales`` as in
    ``_select_level_batched``.

    Returns a dict of (B, detections_per_img, ...) tensors: boxes,
    scores, labels (int32) and valid (bool)."""
    with record_function(SPAN_POSTPROCESS):
        boxes, scores, labels, valid = paa_candidates(
            outputs, image_sizes, anchors, level_counts, pp, decode_fn,
            reg_scales)
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

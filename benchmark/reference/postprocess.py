"""Plain PAA post-processing: per-level threshold, score fusion
sqrt(sigmoid(cls) * sigmoid(iou)), the top PRE_NMS_TOP_N candidates by
fused score, the anchor-delta decode, clipping, class-aware greedy NMS
and score voting (the PAA paper's inference; paa_core's
modeling/rpn/paa/inference.py).

Written for the batch as it comes, in float32 (``dtype``: the
correctness control computes it one precision lower, in bfloat16).
Candidate order: fused
score descending, ties to the lower flat (anchor, class) index; an
image with no more than 128 (or PRE_NMS_TOP_N) candidates at a level
keeps them in index order, as the program's static-shape tiers do, so
that greedy NMS meets them in the same order.
"""

from __future__ import annotations

import math

import torch

from .boxes import box_iou, clip, decode

VOTE_SIGMA = 0.025
VOTE_IOU_MIN = 0.01
SMALL_TIER = 128
NEG = -1e30


def _select(cls, reg, iou, anchors, pp, dtype):
    """One level for the batch: boxes (B, K, 4), scores, labels, valid."""
    b, n, c = cls.shape
    m = n * c
    k = min(pp["pre_nms_top_n"], m)
    th = math.log(pp["pre_nms_thresh"]) - math.log1p(-pp["pre_nms_thresh"])
    logits = cls.to(dtype).reshape(b, m)
    cand = logits > torch.tensor(th, dtype=dtype)
    fused = torch.sqrt(torch.sigmoid(logits).reshape(b, n, c)
                       * torch.sigmoid(iou.to(dtype))[..., None]).reshape(b, m)
    most = int(cand.sum(1).max())
    if most <= min(SMALL_TIER, k) or most <= k:
        kk = min(SMALL_TIER, k) if most <= min(SMALL_TIER, k) else k
        # index order: candidates first, by flat index
        key = torch.where(cand, torch.arange(m, device=cls.device), m)
        idx = torch.sort(key, dim=1).values[:, :kk]
        ok = idx < m
        idx = torch.where(ok, idx, 0)
        score = torch.where(ok, fused.gather(1, idx), -1.0)
        pad = k - kk
        idx = torch.nn.functional.pad(idx, (0, pad))
        score = torch.nn.functional.pad(score, (0, pad), value=-1.0)
        filled = torch.nn.functional.pad(ok, (0, pad))
    else:
        masked = torch.where(cand, fused, -1.0)
        score, idx = torch.sort(masked, dim=1, descending=True, stable=True)
        score, idx = score[:, :k], idx[:, :k]
        filled = torch.ones_like(score, dtype=torch.bool)
    a = idx // c
    labels = (idx % c + 1).to(torch.int32)
    boxes = decode(reg.to(dtype).gather(1, a[..., None].expand(b, k, 4)),
                   anchors[a])
    boxes = torch.where(filled[..., None], boxes, 0.0)
    labels = torch.where(filled, labels, 0)
    return boxes, score, labels, score > 0.0


def greedy_nms(boxes, scores, labels, valid, iou_threshold, max_out):
    """Class-aware greedy NMS per row: pick the best live candidate
    (lowest index on ties), drop those of its label that overlap it by
    more than the threshold (IoU with the +1 convention), repeat.
    Returns keep_idx (int32), keep_scores, keep_valid, each (B, max_out)."""
    b, n = scores.shape
    dev = scores.device
    live = torch.where(valid, scores, NEG)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    cols = torch.arange(n, device=dev).expand(b, n)
    keep_idx = torch.zeros(b, max_out, dtype=torch.int32, device=dev)
    keep_scores = torch.full((b, max_out), NEG, dtype=scores.dtype,
                             device=dev)
    keep_valid = torch.zeros(b, max_out, dtype=torch.bool, device=dev)
    for i in range(max_out):
        best = live.max(dim=1, keepdim=True).values
        idx = torch.where(live == best, cols, n).min(1, keepdim=True).values
        idx = idx.clamp(max=n - 1)
        ok = best > NEG / 2
        if not bool(ok.any()):
            break
        g = lambda t: t.gather(1, idx)  # noqa: E731
        w = (torch.minimum(g(x2), x2) - torch.maximum(g(x1), x1)
             + 1.0).clamp(min=0.0)
        h = (torch.minimum(g(y2), y2) - torch.maximum(g(y1), y1)
             + 1.0).clamp(min=0.0)
        inter = w * h
        iou = inter / (g(area) + area - inter)
        drop = ((iou > iou_threshold) & (labels == g(labels))) | (cols == idx)
        live = torch.where(drop & ok, NEG, live)
        keep_idx[:, i] = torch.where(ok, idx, 0)[:, 0].to(torch.int32)
        keep_scores[:, i] = torch.where(ok, best, NEG)[:, 0]
        keep_valid[:, i] = ok[:, 0]
    return keep_idx, keep_scores, keep_valid


def score_vote(kb, kl, kv, cb, cs, cl, cv):
    """Each kept box replaced by the mean of the same-label candidates
    that overlap it (IoU > 0.01), weighted by exp(-(1 - IoU)^2 / 0.025)
    times their score."""
    ious = box_iou(kb, cb)
    pos = (ious > VOTE_IOU_MIN) & (kl[:, :, None] == cl[:, None, :]) \
        & cv[:, None, :]
    pis = torch.where(pos, torch.exp(-((1.0 - ious) ** 2) / VOTE_SIGMA)
                      * cs[:, None, :], 0.0)
    denom = pis.sum(2, keepdim=True)
    voted = torch.bmm(pis, cb) / denom.clamp(min=1e-12)
    use = (denom[..., 0] > 0) & kv
    return torch.where(use[..., None], voted, kb)


def candidates(out, sizes, anchors, counts, pp, dtype=torch.float32):
    """The NMS input of a batch: every level's selection, concatenated,
    boxes clipped to each image's (h, w)."""
    parts, start = [], 0
    for count in counts:
        sl = slice(start, start + count)
        parts.append(_select(out["cls_logits"][:, sl],
                             out["box_regression"][:, sl],
                             out["iou_pred"][:, sl], anchors[sl], pp,
                             dtype))
        start += count
    boxes, scores, labels, valid = (torch.cat([p[j] for p in parts], 1)
                                    for j in range(4))
    return clip(boxes, sizes.to(dtype)), scores, labels, valid


def detect(out, sizes, anchors, counts, pp, dtype=torch.float32):
    """Detections (B, DETECTIONS_PER_IMG): boxes, scores, labels,
    valid, in float32."""
    boxes, scores, labels, valid = candidates(out, sizes, anchors, counts,
                                              pp, dtype)
    keep, kscores, kvalid = greedy_nms(boxes, scores, labels, valid,
                                       pp["nms_thresh"],
                                       pp["detections_per_img"])
    keep = keep.long()
    kb = boxes.gather(1, keep[..., None].expand(*keep.shape, 4))
    kl = labels.gather(1, keep)
    if pp["score_voting"]:
        kb = score_vote(kb, kl, kvalid, boxes, scores, labels, valid)
    return {"boxes": torch.where(kvalid[..., None], kb, 0.0).float(),
            "scores": torch.where(kvalid, kscores, 0.0).float(),
            "labels": torch.where(kvalid, kl, 0),
            "valid": kvalid}

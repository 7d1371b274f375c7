"""Classic RPN (port of paa_tpu/modeling/rpn.py; reference
paa_core/modeling/rpn/{rpn.py,inference.py,loss.py}).

- ``RPNHead`` (rpn.py:77-110): a shared 3x3 conv + ReLU, 1x1 objectness
  (A) and 1x1 deltas (4A), normal(0.01) with bias 0, in the compute
  dtype. Outputs are flattened per level in the (y, x, anchor) order of
  the anchor grid: the NCHW maps are permuted to NHWC first.
- ``select_proposals``: per level, the top PRE_NMS_TOP_N by objectness,
  decode with the (1, 1, 1, 1) box coder, clip, class-agnostic NMS at
  NMS_THRESH keeping POST_NMS_TOP_N; then, per image, the top
  FPN_POST_NMS_TOP_N of all levels by score.

- ``rpn_loss`` (loss.py:92-131): the matcher at FG/BG_IOU_THRESHOLD
  with low-quality matches, anchors straddling the image by more than
  STRADDLE_THRESH ignored, ``balanced_sample`` (BATCH_SIZE_PER_IMAGE at
  POSITIVE_FRACTION), binary cross-entropy over the sampled anchors and
  smooth-L1 (beta 1/9) over the sampled positives, both divided by the
  number sampled.

The sampler draws nothing itself: it takes one uniform in [0, 1) per
candidate for the positives and one for the negatives, and keeps the
highest (ties to the lower index, as ``jax.lax.top_k``). The caller owns
the stream (modeling/two_stage.py), so the same uniforms give the same
samples as the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_batched
from ..structures.boxes import box_iou, clip_to_image
from .box_coder import decode_box, encode_box
from .layers import Conv
from .matcher import match_anchors
from .retinanet_head import smooth_l1

_HEAD_STD = 0.01


class RPNHead(nn.Module):
    """``out_channels`` is the shared conv's width (default
    ``in_channels``): the JAX package's C4 RPN makes it 1,024 whatever
    the body's width (paa_tpu/modeling/two_stage.py:375)."""

    def __init__(self, num_anchors=3, in_channels=256, dtype=torch.float32,
                 out_channels=None):
        super().__init__()
        width = out_channels or in_channels
        self.conv = Conv(in_channels, width, 3, padding=1, bias=True,
                         dtype=dtype, normal_std=_HEAD_STD)
        self.cls_logits = Conv(width, num_anchors, 1, bias=True,
                               dtype=dtype, normal_std=_HEAD_STD)
        self.bbox_pred = Conv(width, num_anchors * 4, 1, bias=True,
                              dtype=dtype, normal_std=_HEAD_STD)

    def forward(self, features):
        logits, reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(
                b, -1))
            reg.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(
                b, -1, 4))
        return {
            "objectness": torch.cat(logits, dim=1),
            "box_regression": torch.cat(reg, dim=1),
        }


@dataclass(frozen=True)
class RPNConfig:
    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 1000
    fpn_post_nms_top_n: int = 1000
    nms_thresh: float = 0.7
    min_size: float = 0.0
    fg_iou_threshold: float = 0.7
    bg_iou_threshold: float = 0.3
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    straddle_thresh: float = 0.0

    @staticmethod
    def from_cfg(cfg, is_train=False):
        r = cfg.MODEL.RPN
        return RPNConfig(
            pre_nms_top_n=(
                r.PRE_NMS_TOP_N_TRAIN if is_train else r.PRE_NMS_TOP_N_TEST
            ),
            post_nms_top_n=(
                r.POST_NMS_TOP_N_TRAIN if is_train
                else r.POST_NMS_TOP_N_TEST
            ),
            fpn_post_nms_top_n=(
                r.FPN_POST_NMS_TOP_N_TRAIN if is_train
                else r.FPN_POST_NMS_TOP_N_TEST
            ),
            nms_thresh=r.NMS_THRESH,
            min_size=r.MIN_SIZE,
            fg_iou_threshold=r.FG_IOU_THRESHOLD,
            bg_iou_threshold=r.BG_IOU_THRESHOLD,
            batch_size_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION,
            straddle_thresh=float(r.STRADDLE_THRESH),
        )


def top_k_stable(x, k):
    """The k largest of each row in descending order, ties to the lower
    index, as jax.lax.top_k orders them (torch.topk on CUDA promises no
    order among ties). Returns (values, int64 indices)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def rpn_nms_input(outputs, image_sizes, anchors, level_counts, rc):
    """Per level: the top pre_nms_top_n by objectness, decoded and
    clipped. Returns the NMS input of all levels as rows, level-major (B
    rows per level), padded with invalid candidates to the largest
    level's k: boxes (L*B, k, 4), scores, labels (zeros) and valid, then
    max_out (the largest keep count), and per level its boxes (B, k_l, 4)
    and keep count."""
    obj = outputs["objectness"]
    reg = outputs["box_regression"]
    bsz = obj.shape[0]
    sizes = image_sizes.to(torch.float32)

    level_boxes, level_scores, level_valid, keep_ns = [], [], [], []
    start = 0
    for count in level_counts:
        sl = slice(start, start + count)
        k = min(rc.pre_nms_top_n, count)
        top_o, idx = top_k_stable(obj[:, sl].to(torch.float32), k)
        reg_sel = reg[:, sl].to(torch.float32).gather(
            1, idx[..., None].expand(bsz, k, 4))
        boxes = decode_box(reg_sel, anchors[sl][idx],
                           weights=(1.0, 1.0, 1.0, 1.0))
        boxes = clip_to_image(boxes, sizes)
        w = boxes[..., 2] - boxes[..., 0] + 1.0
        h = boxes[..., 3] - boxes[..., 1] + 1.0
        level_boxes.append(boxes)
        level_scores.append(top_o)
        level_valid.append((w >= rc.min_size) & (h >= rc.min_size))
        keep_ns.append(min(rc.post_nms_top_n, k))
        start += count

    kmax = max(s.shape[1] for s in level_scores)

    def rows(parts, fill):
        return torch.cat([F.pad(p, (0, 0) * (p.dim() - 2)
                                + (0, kmax - p.shape[1]), value=fill)
                          for p in parts])

    nms_args = (
        rows(level_boxes, 0.0), rows(level_scores, 0.0),
        torch.zeros(len(level_counts) * bsz, kmax, dtype=torch.int32,
                    device=obj.device),
        rows(level_valid, False), max(keep_ns),
    )
    return nms_args, level_boxes, keep_ns


def select_proposals(outputs, image_sizes, anchors, level_counts, rc):
    """Static-shape proposal selection, batched over images.

    outputs: "objectness" (B, N) and "box_regression" (B, N, 4) in the
    anchor order; image_sizes (B, 2) (h, w); anchors (N, 4) float32;
    level_counts: anchors per level. Returns proposals (B, K, 4), scores
    (B, K) float32 and valid (B, K) bool with K = min(fpn_post_nms_top_n,
    the levels' kept slots); invalid slots score -inf.

    The JAX package runs one batched NMS per level. Here all levels go
    to ONE launch as rows (``rpn_nms_input``), with the largest keep
    count as max_out; each level then keeps its own first keep_n slots.
    Rows are independent and a padded candidate is never picked, so the
    picks are the per-level ones, and a row that runs out keeps (0,
    -1e30, False) in its later slots either way."""
    bsz = outputs["objectness"].shape[0]
    (boxes, scores, labels, valid, max_out), level_boxes, keep_ns = \
        rpn_nms_input(outputs, image_sizes, anchors, level_counts, rc)
    kidx, kscores, kvalid = nms_batched(
        boxes, scores, labels, valid, rc.nms_thresh, max_out,
        class_aware=False)
    picked_boxes, picked_scores, picked_valid = [], [], []
    for lvl, (lboxes, keep_n) in enumerate(zip(level_boxes, keep_ns)):
        r = slice(lvl * bsz, (lvl + 1) * bsz)
        li = kidx[r, :keep_n].long()
        picked_boxes.append(lboxes.gather(1, li[..., None].expand(
            bsz, keep_n, 4)))
        picked_scores.append(kscores[r, :keep_n])
        picked_valid.append(kvalid[r, :keep_n])
    boxes = torch.cat(picked_boxes, dim=1)
    scores = torch.cat(picked_scores, dim=1)
    valid = torch.cat(picked_valid, dim=1)
    # FPN: keep the overall top fpn_post_nms_top_n by score
    k = min(rc.fpn_post_nms_top_n, scores.shape[1])
    masked = torch.where(valid, scores, -torch.inf)
    top_s, idx = top_k_stable(masked, k)
    return (
        boxes.gather(1, idx[..., None].expand(bsz, k, 4)),
        top_s,
        torch.isfinite(top_s),
    )


def balanced_sample(labels, u_pos, u_neg, batch_size, positive_fraction):
    """BalancedPositiveNegativeSampler (balanced_positive_negative_sampler
    .py) per row: at most batch_size * positive_fraction positives, the
    negatives filling the rest of batch_size.

    labels: (R, N) int, > 0 positive, 0 negative, < 0 ignored; u_pos,
    u_neg: (R, N) uniforms in [0, 1), the priorities of the positive and
    the negative candidates. Returns bool masks (pos_sel, neg_sel),
    (R, N)."""
    rows, n = labels.shape
    num_pos_cap = min(int(batch_size * positive_fraction), n)
    pos = labels > 0
    neg = labels == 0
    _, pos_idx = top_k_stable(torch.where(pos, u_pos, -1.0), num_pos_cap)
    pos_sel = torch.zeros_like(pos).scatter_(1, pos_idx, True) & pos
    num_neg_target = batch_size - pos_sel.sum(1, keepdim=True)
    k_neg = min(batch_size, n)
    _, neg_idx = top_k_stable(torch.where(neg, u_neg, -1.0), k_neg)
    rank = torch.zeros(rows, n, dtype=torch.int64, device=labels.device)
    rank.scatter_(1, neg_idx, torch.arange(
        1, k_neg + 1, device=labels.device).expand(rows, k_neg))
    neg_sel = (rank > 0) & (rank <= num_neg_target) & neg
    return pos_sel, neg_sel


def rpn_labels(gt_boxes, gt_labels, anchors, rc, image_sizes=None):
    """Per anchor: label (B, N) int32 (1 foreground, 0 background, -1
    ignored: between the thresholds, or straddling the true image size
    by more than straddle_thresh when ``image_sizes`` (B, 2) (h, w) is
    given, as the reference's visibility discard, rpn/loss.py:76-78)
    and the matched GT (B, N), clamped to >= 0."""
    matched = match_anchors(box_iou(gt_boxes, anchors[None]),
                            gt_labels > 0, rc.fg_iou_threshold,
                            rc.bg_iou_threshold,
                            allow_low_quality_matches=True)
    labels = torch.where(matched >= 0, 1,
                         torch.where(matched == -2, -1, 0)).to(torch.int32)
    if image_sizes is not None and rc.straddle_thresh >= 0:
        st = rc.straddle_thresh
        h = image_sizes[:, 0:1].to(torch.float32)
        w = image_sizes[:, 1:2].to(torch.float32)
        visible = ((anchors[None, :, 0] >= -st)
                   & (anchors[None, :, 1] >= -st)
                   & (anchors[None, :, 2] < w + st)
                   & (anchors[None, :, 3] < h + st))
        labels = torch.where(visible, labels, -1)
    return labels, matched.clamp(min=0)


def rpn_loss(outputs, gt_boxes, gt_labels, anchors, rc, draws,
             image_sizes=None, return_aux=False):
    """RPNLossComputation (rpn/loss.py:92-131).

    outputs: "objectness" (B, N) and "box_regression" (B, N, 4);
    gt_boxes (B, G, 4), gt_labels (B, G) with 0 for padding; anchors
    (N, 4) float32; draws: (u_pos, u_neg), each (B, N), the sampler's
    uniforms. Returns loss_objectness, loss_rpn_box_reg and num_pos;
    with ``return_aux`` also the sampled masks "rpn_pos" and "rpn_neg".
    The losses are divided by this process's sampled count (the JAX
    package takes no cross-rank normalizer here)."""
    objectness = outputs["objectness"].to(torch.float32)
    box_regression = outputs["box_regression"].to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)
    labels, matched = rpn_labels(gt_boxes, gt_labels, anchors, rc,
                                 image_sizes)
    matched_boxes = gt_boxes.gather(
        1, matched.long()[..., None].expand(*matched.shape, 4))
    reg_targets = encode_box(matched_boxes, anchors[None],
                             weights=(1.0, 1.0, 1.0, 1.0))

    pos_sel, neg_sel = balanced_sample(
        labels, *draws, rc.batch_size_per_image, rc.positive_fraction)
    posf = pos_sel.to(torch.float32)
    sampled = (pos_sel | neg_sel).to(torch.float32)
    n_sampled = sampled.sum().clamp(min=1.0)

    reg = smooth_l1(box_regression, reg_targets, beta=1.0 / 9)
    loss_reg = (reg * posf[..., None]).sum() / n_sampled
    t = (labels > 0).to(torch.float32)
    bce = -(t * F.logsigmoid(objectness)
            + (1 - t) * F.logsigmoid(-objectness))
    loss_obj = (bce * sampled).sum() / n_sampled
    out = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_reg,
           "num_pos": posf.sum()}
    if return_aux:
        out.update(rpn_pos=pos_sel, rpn_neg=neg_sel)
    return out

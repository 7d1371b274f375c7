"""Classic RPN at inference (port of paa_tpu/modeling/rpn.py; reference
paa_core/modeling/rpn/{rpn.py,inference.py}).

- ``RPNHead`` (rpn.py:77-110): a shared 3x3 conv + ReLU, 1x1 objectness
  (A) and 1x1 deltas (4A), normal(0.01) with bias 0, in the compute
  dtype. Outputs are flattened per level in the (y, x, anchor) order of
  the anchor grid: the NCHW maps are permuted to NHWC first.
- ``select_proposals``: per level, the top PRE_NMS_TOP_N by objectness,
  decode with the (1, 1, 1, 1) box coder, clip, class-agnostic NMS at
  NMS_THRESH keeping POST_NMS_TOP_N; then, per image, the top
  FPN_POST_NMS_TOP_N of all levels by score.

Training (the matcher, the balanced sampler, ``rpn_loss``) is not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms_batched
from ..structures.boxes import clip_to_image
from .box_coder import decode_box
from .layers import Conv

_HEAD_STD = 0.01


class RPNHead(nn.Module):
    def __init__(self, num_anchors=3, in_channels=256, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, in_channels, 3, padding=1, bias=True,
                         dtype=dtype, normal_std=_HEAD_STD)
        self.cls_logits = Conv(in_channels, num_anchors, 1, bias=True,
                               dtype=dtype, normal_std=_HEAD_STD)
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 1, bias=True,
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
    """The inference fields of the JAX package's RPNConfig; the matcher
    and sampler fields come with training."""

    pre_nms_top_n: int = 1000
    post_nms_top_n: int = 1000
    fpn_post_nms_top_n: int = 1000
    nms_thresh: float = 0.7
    min_size: float = 0.0

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

"""RetinaNet head and loss (port of paa_tpu/modeling/retinanet_head.py;
reference paa_core/modeling/rpn/retinanet/).

- Head (retinanet.py:13-90): plain towers of [3x3 conv, ReLU] with no
  norm (so no K3), A = 9 anchors per location (3 ratios x 3 octave
  scales), normal(0.01) convs, the focal-prior cls bias, no Scale.
- Loss (loss.py:19-81): the matcher at FG/BG 0.5/0.4 with low-quality
  matches, anchors between the thresholds ignored (-1); smooth-L1 on
  the positives over max(num_pos * BBOX_REG_WEIGHT, 1); focal over
  num_pos + the number of images. The post-processing is the shared
  one (``paa_postprocess`` without the IoU branch).

The reference divides by each GPU's own counts; the JAX package divides
the global batch by its global counts, and so does the port: under a
process group the positive and image counts are summed over the ranks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..ops.focal_loss import sigmoid_focal_loss
from ..structures.boxes import box_iou
from ..utils import comm
from .atss_head import flatten_level
from .box_coder import encode_box
from .layers import Conv
from .matcher import match_anchors
from .paa_head import _HEAD_STD

SPAN_ASSIGN = "retinanet_loss/assignment"
SPAN_LOSSES = "retinanet_loss/losses"


class PlainTower(nn.Module):
    """num_convs x [3x3 conv, ReLU] (no norm), shared across levels."""

    def __init__(self, channels, num_convs=4, dtype=torch.float32):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv(
                channels, channels, 3, padding=1, bias=True, dtype=dtype,
                normal_std=_HEAD_STD))

    def forward(self, x):
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes, num_anchors=9, in_channels=256,
                 num_convs=4, num_levels=5, prior_prob=0.01,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # WITHOUT background
        self.num_levels = num_levels
        self.cls_tower = PlainTower(in_channels, num_convs, dtype=dtype)
        self.bbox_tower = PlainTower(in_channels, num_convs, dtype=dtype)
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = Conv(
            in_channels, num_anchors * num_classes, 3, padding=1, bias=True,
            dtype=dtype, normal_std=_HEAD_STD, bias_value=bias_value)
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 3, padding=1,
                              bias=True, dtype=dtype, normal_std=_HEAD_STD)

    def forward(self, features):
        if len(features) != self.num_levels:
            raise ValueError(
                f"{len(features)} feature levels, head built for "
                f"{self.num_levels}")
        logits, bbox_reg = [], []
        for feature in features:
            b = feature.shape[0]
            logits.append(flatten_level(
                self.cls_logits(self.cls_tower(feature)), b,
                self.num_classes))
            bbox_reg.append(flatten_level(
                self.bbox_pred(self.bbox_tower(feature)), b, 4))
        return {"cls_logits": torch.cat(logits, dim=1),
                "box_regression": torch.cat(bbox_reg, dim=1)}


def retinanet_head_from_cfg(cfg, dtype=torch.float32):
    r = cfg.MODEL.RETINANET
    return RetinaNetHead(
        num_classes=r.NUM_CLASSES - 1,
        num_anchors=len(r.ASPECT_RATIOS) * r.SCALES_PER_OCTAVE,
        in_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        num_convs=r.NUM_CONVS,
        num_levels=len(r.ANCHOR_STRIDES),
        prior_prob=r.PRIOR_PROB,
        dtype=dtype,
    )


@dataclass(frozen=True)
class RetinaNetLossConfig:
    gamma: float = 2.0
    alpha: float = 0.25
    fg_iou_threshold: float = 0.5
    bg_iou_threshold: float = 0.4
    bbox_reg_beta: float = 0.11
    bbox_reg_weight: float = 4.0

    @staticmethod
    def from_cfg(cfg):
        r = cfg.MODEL.RETINANET
        return RetinaNetLossConfig(
            gamma=r.LOSS_GAMMA,
            alpha=r.LOSS_ALPHA,
            fg_iou_threshold=r.FG_IOU_THRESHOLD,
            bg_iou_threshold=r.BG_IOU_THRESHOLD,
            bbox_reg_beta=r.BBOX_REG_BETA,
            bbox_reg_weight=r.BBOX_REG_WEIGHT,
        )


def smooth_l1(pred, target, beta):
    n = torch.abs(pred - target)
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def retinanet_assign(gt_boxes, gt_labels, anchors, lc):
    """Labels (B, N) int32 (-1 ignored, 0 background) and the matched GT
    (B, N), clamped to >= 0."""
    matched = match_anchors(box_iou(gt_boxes, anchors[None]),
                            gt_labels > 0, lc.fg_iou_threshold,
                            lc.bg_iou_threshold,
                            allow_low_quality_matches=True)
    clamped = matched.clamp(min=0).long()
    labels = torch.where(
        matched >= 0, gt_labels.gather(1, clamped),
        torch.where(matched == -2, -1, 0).to(gt_labels.dtype))
    return labels.to(torch.int32), clamped


def retinanet_loss(outputs, gt_boxes, gt_labels, anchors, level_counts,
                   lc):
    """The RetinaNet losses of one batch: outputs 'cls_logits' (B, N, C)
    and 'box_regression' (B, N, 4); gt_boxes (B, G, 4), gt_labels (B, G)
    (0 = padding); anchors (N, 4); ``level_counts`` unused (the engine's
    loss signature). Returns {loss_retina_cls, loss_retina_reg,
    num_pos}."""
    cls_logits = outputs["cls_logits"].to(torch.float32)
    box_regression = outputs["box_regression"].to(torch.float32)
    anchors = anchors.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)

    with record_function(SPAN_ASSIGN):
        labels, matched = retinanet_assign(gt_boxes, gt_labels, anchors, lc)
        matched_boxes = gt_boxes.gather(
            1, matched[:, :, None].expand(-1, -1, 4))
        reg_targets = encode_box(matched_boxes, anchors[None])

    with record_function(SPAN_LOSSES):
        posf = (labels > 0).to(torch.float32)
        world = comm.get_world_size()
        num_pos = comm.all_reduce_sum(posf.sum())
        n_images = gt_labels.shape[0] * world
        reg = smooth_l1(box_regression, reg_targets, lc.bbox_reg_beta)
        loss_reg = (reg * posf[..., None]).sum() / (
            (num_pos * lc.bbox_reg_weight).clamp(min=1.0) / world)
        loss_cls = sigmoid_focal_loss(cls_logits, labels, lc.gamma,
                                      lc.alpha).sum() / (
            (num_pos + n_images) / world)
    return {"loss_retina_cls": loss_cls, "loss_retina_reg": loss_reg,
            "num_pos": num_pos}

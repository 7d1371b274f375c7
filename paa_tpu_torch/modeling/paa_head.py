"""PAA head (port of paa_tpu/modeling/paa_head.py, reference
paa_core/modeling/rpn/paa/paa.py:15-108): shared 4-conv cls and bbox
towers of [3x3 conv, GroupNorm(32)+ReLU] over all FPN levels,
``cls_logits`` (A*C), per-level ``Scale`` on ``bbox_pred`` (A*4) and the
``iou_pred`` (A*1) branch (left out with USE_IOU_PRED off: the output
then has no ``iou_pred`` key). Focal-prior bias on cls_logits; every head
conv normal(0.01), bias 0. With USE_DCN_IN_TOWER the last conv of each
tower is a modulated deformable conv with bias (ops/dcn.py), followed by
GroupNorm+ReLU as the others.

Outputs are flattened per level to (B, H*W*A, K) in the y, x, anchor
order of the anchor grid: the NCHW maps are permuted to NHWC before the
reshape.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv, DeformConv, GroupNorm32, Scale

_HEAD_STD = 0.01


class ConvTower(nn.Module):
    """num_convs x [3x3 conv, GN(32)+ReLU], shared across levels; the
    last conv deformable (modulated, with bias) when ``use_dcn_last``.
    The PAA, ATSS and FCOS heads' towers."""

    def __init__(self, channels, num_convs=4, use_dcn_last=False,
                 dtype=torch.float32):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            last = use_dcn_last and i == num_convs - 1
            conv = DeformConv if last else Conv
            self.add_module(f"conv{i}", conv(
                channels, channels, 3, padding=1, bias=True, dtype=dtype,
                normal_std=_HEAD_STD))
            self.add_module(f"gn{i}", GroupNorm32(channels))

    def forward(self, x):
        for i in range(self.num_convs):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
        return x


class PAAHead(nn.Module):
    def __init__(self, num_classes, num_anchors=1, in_channels=256,
                 num_convs=4, num_levels=5, prior_prob=0.01,
                 use_dcn_in_tower=False, use_iou_pred=True,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # WITHOUT background
        self.num_levels = num_levels
        self.cls_tower = ConvTower(in_channels, num_convs, use_dcn_in_tower,
                                   dtype=dtype)
        self.bbox_tower = ConvTower(in_channels, num_convs, use_dcn_in_tower,
                                    dtype=dtype)
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = Conv(
            in_channels, num_anchors * num_classes, 3, padding=1, bias=True,
            dtype=dtype, normal_std=_HEAD_STD, bias_value=bias_value)
        self.bbox_pred = Conv(
            in_channels, num_anchors * 4, 3, padding=1, bias=True,
            dtype=dtype, normal_std=_HEAD_STD)
        self.iou_pred = Conv(
            in_channels, num_anchors, 3, padding=1, bias=True, dtype=dtype,
            normal_std=_HEAD_STD) if use_iou_pred else None
        for level in range(num_levels):
            self.add_module(f"scale{level}", Scale(1.0))

    def forward(self, features):
        if len(features) != self.num_levels:
            raise ValueError(
                f"{len(features)} feature levels, head built for "
                f"{self.num_levels}"
            )
        logits, bbox_reg, iou_out = [], [], []
        for level, feature in enumerate(features):
            ct = self.cls_tower(feature)
            bt = self.bbox_tower(feature)
            b = feature.shape[0]
            # (B, A*K, H, W) -> (B, H, W, A*K) -> (B, H*W*A, K)
            logits.append(self.cls_logits(ct).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
            reg = getattr(self, f"scale{level}")(self.bbox_pred(bt))
            bbox_reg.append(reg.permute(0, 2, 3, 1).reshape(b, -1, 4))
            if self.iou_pred is not None:
                iou_out.append(
                    self.iou_pred(bt).permute(0, 2, 3, 1).reshape(b, -1))
        out = {
            "cls_logits": torch.cat(logits, dim=1),
            "box_regression": torch.cat(bbox_reg, dim=1),
        }
        if iou_out:
            out["iou_pred"] = torch.cat(iou_out, dim=1)
        return out


def paa_head_from_cfg(cfg, dtype=torch.float32):
    p = cfg.MODEL.PAA
    return PAAHead(
        num_classes=p.NUM_CLASSES - 1,
        num_anchors=len(p.ASPECT_RATIOS) * p.SCALES_PER_OCTAVE,
        in_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        num_convs=p.NUM_CONVS,
        num_levels=len(p.ANCHOR_STRIDES),
        prior_prob=p.PRIOR_PROB,
        use_dcn_in_tower=p.USE_DCN_IN_TOWER,
        use_iou_pred=p.USE_IOU_PRED,
        dtype=dtype,
    )

"""ATSS head (port of paa_tpu/modeling/atss_head.py, reference
paa_core/modeling/rpn/atss/atss.py:100-191): PAA's shared cls and bbox
towers (``ConvTower``: GroupNorm+ReLU through the K3 kernel on the card,
the last conv deformable with USE_DCN_IN_TOWER), ``cls_logits`` with the
focal-prior bias, a per-level ``Scale`` on ``bbox_pred`` (followed by a
ReLU, and a bias init of 4, in 'POINT' regression), and the centerness
branch on the bbox tower. The branch's logits come out under the
``iou_pred`` key: the post-processing fuses sqrt(cls * sigmoid(branch))
as PAA's. It is left out when USE_CENTERNESS_PRED and USE_IOU_PRED are
both False (atss/ret_R_50_FPN_1.5x.yaml).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, Scale
from .paa_head import _HEAD_STD, ConvTower


def flatten_level(x, b, k):
    """(B, A*K, H, W) -> (B, H*W*A, K): the y, x, anchor order of the
    anchor grid."""
    return x.permute(0, 2, 3, 1).reshape(b, -1, k)


class ATSSHead(nn.Module):
    def __init__(self, num_classes, num_anchors=1, in_channels=256,
                 num_convs=4, num_levels=5, use_dcn_in_tower=False,
                 prior_prob=0.01, regression_type="BOX", use_branch=True,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # WITHOUT background
        self.num_levels = num_levels
        self.point = regression_type == "POINT"
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
            dtype=dtype, normal_std=_HEAD_STD,
            bias_value=4.0 if self.point else 0.0)
        self.centerness = Conv(
            in_channels, num_anchors, 3, padding=1, bias=True, dtype=dtype,
            normal_std=_HEAD_STD) if use_branch else None
        for level in range(num_levels):
            self.add_module(f"scale{level}", Scale(1.0))

    def forward(self, features):
        if len(features) != self.num_levels:
            raise ValueError(
                f"{len(features)} feature levels, head built for "
                f"{self.num_levels}")
        logits, bbox_reg, ctr = [], [], []
        for level, feature in enumerate(features):
            ct = self.cls_tower(feature)
            bt = self.bbox_tower(feature)
            b = feature.shape[0]
            logits.append(flatten_level(self.cls_logits(ct), b,
                                        self.num_classes))
            reg = getattr(self, f"scale{level}")(self.bbox_pred(bt))
            if self.point:
                reg = F.relu(reg)
            bbox_reg.append(flatten_level(reg, b, 4))
            if self.centerness is not None:
                ctr.append(flatten_level(self.centerness(bt), b, 1)[..., 0])
        out = {
            "cls_logits": torch.cat(logits, dim=1),
            "box_regression": torch.cat(bbox_reg, dim=1),
        }
        if ctr:
            out["iou_pred"] = torch.cat(ctr, dim=1)
        return out


def atss_head_from_cfg(cfg, dtype=torch.float32):
    a = cfg.MODEL.ATSS
    num_anchors = len(a.ASPECT_RATIOS) * a.SCALES_PER_OCTAVE
    if a.REGRESSION_TYPE == "POINT" and num_anchors != 1:
        raise ValueError(
            f"ATSS 'POINT' regression takes one anchor per location, not "
            f"{num_anchors}")
    return ATSSHead(
        num_classes=a.NUM_CLASSES - 1,
        num_anchors=num_anchors,
        in_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        num_convs=a.NUM_CONVS,
        num_levels=len(a.ANCHOR_STRIDES),
        use_dcn_in_tower=a.USE_DCN_IN_TOWER,
        prior_prob=a.PRIOR_PROB,
        regression_type=a.REGRESSION_TYPE,
        use_branch=a.USE_CENTERNESS_PRED or a.USE_IOU_PRED,
        dtype=dtype,
    )

"""FCOS head and its point utilities (port of paa_tpu/modeling/fcos_head.py,
reference paa_core/modeling/rpn/fcos/fcos.py:13-117).

Anchor-free: per location, the distances l, t, r, b to the box sides.
PAA's shared cls and bbox towers (``ConvTower``: GroupNorm+ReLU through
the K3 kernel on the card), ``cls_logits`` with the focal-prior bias, the
centerness branch on the cls tower or, with CENTERNESS_ON_REG, on the
bbox tower (its logits under the ``iou_pred`` key), and a per-level
``Scale`` on ``bbox_pred`` followed by ``exp``, or by ``relu`` with
NORM_REG_TARGETS. Under NORM_REG_TARGETS the output stays in stride
units, as the JAX package keeps it (the training view): the
post-processing multiplies each level by its stride
(``DetectionModel.postprocess``) and the loss divides the targets by it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .atss_head import flatten_level
from .layers import Conv, Scale
from .paa_head import _HEAD_STD, ConvTower


def decode_ltrb(preds, locations4):
    """Boxes from per-location distances: ``locations4`` is the (x, y, x,
    y) tiling of the points (``anchors.LocationGenerator``), so the
    post-processing passes it where it passes anchors."""
    x, y = locations4[..., 0], locations4[..., 1]
    return torch.stack([x - preds[..., 0], y - preds[..., 1],
                        x + preds[..., 2], y + preds[..., 3]], dim=-1)


class FCOSHead(nn.Module):
    def __init__(self, num_classes, in_channels=256, num_convs=4,
                 num_levels=5, use_dcn_in_tower=False, prior_prob=0.01,
                 norm_reg_targets=False, centerness_on_reg=False,
                 dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # WITHOUT background
        self.num_levels = num_levels
        self.norm_reg_targets = norm_reg_targets
        self.centerness_on_reg = centerness_on_reg
        self.cls_tower = ConvTower(in_channels, num_convs, use_dcn_in_tower,
                                   dtype=dtype)
        self.bbox_tower = ConvTower(in_channels, num_convs, use_dcn_in_tower,
                                    dtype=dtype)
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = Conv(
            in_channels, num_classes, 3, padding=1, bias=True, dtype=dtype,
            normal_std=_HEAD_STD, bias_value=bias_value)
        self.bbox_pred = Conv(in_channels, 4, 3, padding=1, bias=True,
                              dtype=dtype, normal_std=_HEAD_STD)
        self.centerness = Conv(in_channels, 1, 3, padding=1, bias=True,
                               dtype=dtype, normal_std=_HEAD_STD)
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
            ctr_src = bt if self.centerness_on_reg else ct
            ctr.append(flatten_level(self.centerness(ctr_src), b, 1)[..., 0])
            reg = getattr(self, f"scale{level}")(self.bbox_pred(bt))
            reg = F.relu(reg) if self.norm_reg_targets else torch.exp(reg)
            bbox_reg.append(flatten_level(reg, b, 4))
        return {
            "cls_logits": torch.cat(logits, dim=1),
            "box_regression": torch.cat(bbox_reg, dim=1),
            "iou_pred": torch.cat(ctr, dim=1),  # centerness
        }


def fcos_head_from_cfg(cfg, dtype=torch.float32):
    f = cfg.MODEL.FCOS
    return FCOSHead(
        num_classes=f.NUM_CLASSES - 1,
        in_channels=cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS,
        num_convs=f.NUM_CONVS,
        num_levels=len(f.FPN_STRIDES),
        use_dcn_in_tower=f.USE_DCN_IN_TOWER,
        prior_prob=f.PRIOR_PROB,
        norm_reg_targets=f.NORM_REG_TARGETS,
        centerness_on_reg=f.CENTERNESS_ON_REG,
        dtype=dtype,
    )

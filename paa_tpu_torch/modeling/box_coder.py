"""'BOX' encode and decode for the PAA head (port of
paa_tpu/modeling/box_coder.py).

Faster-RCNN deltas with weights (10, 10, 5, 5) and the exp clamp of the
reference BoxCoder (paa_core/modeling/rpn/atss/atss.py:33-52, 68-97).
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
TO_REMOVE = 1.0


def encode_box(gt_boxes, anchors, weights=_WEIGHTS):
    """'BOX' regression targets of ``gt_boxes`` against ``anchors``, both
    (..., 4), broadcast over leading dims."""
    ex_w = anchors[..., 2] - anchors[..., 0] + TO_REMOVE
    ex_h = anchors[..., 3] - anchors[..., 1] + TO_REMOVE
    ex_cx = (anchors[..., 2] + anchors[..., 0]) / 2
    ex_cy = (anchors[..., 3] + anchors[..., 1]) / 2

    gt_w = gt_boxes[..., 2] - gt_boxes[..., 0] + TO_REMOVE
    gt_h = gt_boxes[..., 3] - gt_boxes[..., 1] + TO_REMOVE
    gt_cx = (gt_boxes[..., 2] + gt_boxes[..., 0]) / 2
    gt_cy = (gt_boxes[..., 3] + gt_boxes[..., 1]) / 2

    wx, wy, ww, wh = weights
    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_box(preds, anchors, weights=_WEIGHTS):
    """preds, anchors: (..., 4), broadcast over leading dims."""
    anchors = anchors.to(preds.dtype)
    w = anchors[..., 2] - anchors[..., 0] + TO_REMOVE
    h = anchors[..., 3] - anchors[..., 1] + TO_REMOVE
    cx = (anchors[..., 2] + anchors[..., 0]) / 2
    cy = (anchors[..., 3] + anchors[..., 1]) / 2

    wx, wy, ww, wh = weights
    dx = preds[..., 0] / wx
    dy = preds[..., 1] / wy
    dw = torch.clamp(preds[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(preds[..., 3] / wh, max=BBOX_XFORM_CLIP)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h

    return torch.stack(
        [
            pred_cx - 0.5 * (pred_w - 1),
            pred_cy - 0.5 * (pred_h - 1),
            pred_cx + 0.5 * (pred_w - 1),
            pred_cy + 0.5 * (pred_h - 1),
        ],
        dim=-1,
    )

"""'BOX' decode for the PAA head (port of paa_tpu/modeling/box_coder.py).

Faster-RCNN deltas with weights (10, 10, 5, 5) and the exp clamp of the
reference BoxCoder (paa_core/modeling/rpn/atss/atss.py:68-97). The
encoder belongs to training and is not ported yet.
"""

from __future__ import annotations

import math

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)
_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
TO_REMOVE = 1.0


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

"""Batched, fixed-shape box operations (port of paa_tpu/structures/boxes.py).

Boxes are plain ``(..., N, 4)`` xyxy tensors. All IoU and area math
follows the legacy Detectron "+1 pixel" convention of the reference
(paa_core/structures/boxlist_ops.py:110-112, csrc/cuda/ml_nms.cu:17-23):
``w = x2 - x1 + 1``.
"""

from __future__ import annotations

import torch

TO_REMOVE = 1.0  # legacy Detectron +1-pixel box-size convention


def box_area(boxes):
    """Area under the +1 convention. boxes: (..., 4) xyxy."""
    w = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    h = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return w * h


def box_iou(boxes1, boxes2):
    """Pairwise IoU with the +1 convention.

    boxes1: (..., N, 4), boxes2: (..., M, 4) -> (..., N, M).
    """
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union


def box_iou_aligned(boxes1, boxes2):
    """Elementwise IoU of aligned (..., 4) box tensors under the +1
    convention (reference PAALossComputation.compute_ious,
    paa_core/modeling/rpn/paa/loss.py:258-265)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1 + area2 - inter)


def clip_to_image(boxes, image_size):
    """Clip xyxy boxes to [0, size-1] like BoxList.clip_to_image.

    boxes: (..., N, 4); image_size: (..., 2) as (height, width),
    broadcast against the box batch dims.
    """
    h = image_size[..., 0:1]
    w = image_size[..., 1:2]
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.clamp(boxes[..., 0], zero, w - TO_REMOVE)
    y1 = torch.clamp(boxes[..., 1], zero, h - TO_REMOVE)
    x2 = torch.clamp(boxes[..., 2], zero, w - TO_REMOVE)
    y2 = torch.clamp(boxes[..., 3], zero, h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def xyxy_to_xywh(boxes):
    """xyxy -> xywh under the +1 convention (BoxList.convert)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack(
        [x1, y1, x2 - x1 + TO_REMOVE, y2 - y1 + TO_REMOVE], dim=-1)


def xywh_to_xyxy(boxes):
    x, y, w, h = boxes.unbind(-1)
    return torch.stack(
        [x, y, x + (w - TO_REMOVE).clamp(min=0.0),
         y + (h - TO_REMOVE).clamp(min=0.0)], dim=-1)

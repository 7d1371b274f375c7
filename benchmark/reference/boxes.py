"""Box arithmetic of the reference, with the legacy Detectron +1
convention: 'BOX' deltas with weights (10, 10, 5, 5) and the exp clamp
at log(1000 / 16), pairwise and aligned IoU, clipping, and the
single-scale anchors of the PAA configurations."""

from __future__ import annotations

import math

import numpy as np
import torch

WEIGHTS = (10.0, 10.0, 5.0, 5.0)
CLIP = math.log(1000.0 / 16)


def encode(gt, anchors):
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    ax = (anchors[..., 2] + anchors[..., 0]) / 2
    ay = (anchors[..., 3] + anchors[..., 1]) / 2
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gx = (gt[..., 2] + gt[..., 0]) / 2
    gy = (gt[..., 3] + gt[..., 1]) / 2
    wx, wy, ww, wh = WEIGHTS
    return torch.stack([wx * (gx - ax) / aw, wy * (gy - ay) / ah,
                        ww * torch.log(gw / aw), wh * torch.log(gh / ah)], -1)


def decode(d, anchors):
    anchors = anchors.to(d.dtype)
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = (anchors[..., 2] + anchors[..., 0]) / 2
    cy = (anchors[..., 3] + anchors[..., 1]) / 2
    wx, wy, ww, wh = WEIGHTS
    px = d[..., 0] / wx * w + cx
    py = d[..., 1] / wy * h + cy
    pw = torch.exp(torch.clamp(d[..., 2] / ww, max=CLIP)) * w
    ph = torch.exp(torch.clamp(d[..., 3] / wh, max=CLIP)) * h
    return torch.stack([px - 0.5 * (pw - 1), py - 0.5 * (ph - 1),
                        px + 0.5 * (pw - 1), py + 0.5 * (ph - 1)], -1)


def area(b):
    return (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)


def box_iou(a, b):
    """(..., N, 4) x (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter)


def aligned_iou(a, b):
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt + 1.0).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a) + area(b) - inter)


def clip(boxes, sizes):
    """Clip to [0, w - 1] x [0, h - 1]; sizes (B, 2) as (h, w)."""
    h, w = sizes[..., 0:1], sizes[..., 1:2]
    zero = boxes.new_zeros(())
    return torch.stack([torch.clamp(boxes[..., 0], zero, w - 1),
                        torch.clamp(boxes[..., 1], zero, h - 1),
                        torch.clamp(boxes[..., 2], zero, w - 1),
                        torch.clamp(boxes[..., 3], zero, h - 1)], -1)


def anchors(shapes, strides, sizes):
    """One square anchor of side ``sizes[l]`` per location of level l
    (aspect ratio 1, one scale per octave), centred at (stride - 1) / 2
    from each cell's corner, in (y, x) order: (N, 4) float32 and the
    per-level counts."""
    out, counts = [], []
    for (h, w), s, size in zip(shapes, strides, sizes):
        # legacy Detectron: the cell anchor [-0.5, -0.5, s - 0.5, s - 0.5]
        # rounded to a square of sqrt(area) = s, then scaled to ``size``
        base = np.array([1, 1, s, s], np.float64) - 0.5
        bw = base[2] - base[0] + 1
        cx = base[0] + 0.5 * (bw - 1)
        side = np.round(np.sqrt(bw * bw)) * (size / s)
        cell = np.array([cx - 0.5 * (side - 1), cx - 0.5 * (side - 1),
                         cx + 0.5 * (side - 1), cx + 0.5 * (side - 1)],
                        np.float32)
        xs = np.arange(0, w * s, s, dtype=np.float32)
        ys = np.arange(0, h * s, s, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        shift = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], 1)
        out.append((shift + cell[None]).astype(np.float32))
        counts.append(h * w)
    return torch.from_numpy(np.concatenate(out)), counts

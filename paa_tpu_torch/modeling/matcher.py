"""Batched IoU matcher (port of paa_tpu/modeling/matcher.py, reference
paa_core/modeling/matcher.py:5-113).

Per anchor, the argmax over the padded GT rows with low/high thresholds
(BELOW_LOW_THRESHOLD = -1, BETWEEN_THRESHOLDS = -2) and the
allow_low_quality_matches recovery: for each GT, every anchor that
reaches that GT's highest IoU (ties included) is restored to its own
best GT. Padded GT rows are masked to IoU -1, so they never win an
argmax nor trigger recovery; images without a valid GT are all
background. ``torch.argmax`` takes the first index on ties, as
``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

BELOW_LOW_THRESHOLD = -1
BETWEEN_THRESHOLDS = -2


def match_anchors(iou, gt_valid, high_threshold, low_threshold,
                  allow_low_quality_matches=True):
    """iou: (B, G, N); gt_valid: (B, G) bool. Returns (B, N) int32 matches
    in [0, G) or {-1, -2}."""
    iou = torch.where(gt_valid[:, :, None], iou,
                      torch.full((), -1.0, dtype=iou.dtype, device=iou.device))
    matched_vals, all_matches = iou.max(dim=1)
    all_matches = all_matches.to(torch.int32)
    below = torch.where(
        matched_vals >= low_threshold,
        torch.full((), BETWEEN_THRESHOLDS, dtype=torch.int32,
                   device=iou.device),
        torch.full((), BELOW_LOW_THRESHOLD, dtype=torch.int32,
                   device=iou.device),
    )
    matches = torch.where(matched_vals >= high_threshold, all_matches, below)

    if allow_low_quality_matches:
        highest_per_gt = iou.amax(dim=2, keepdim=True)
        is_best_for_gt = (iou == highest_per_gt) & gt_valid[:, :, None]
        matches = torch.where(is_best_for_gt.any(dim=1), all_matches, matches)

    any_gt = gt_valid.any(dim=1)[:, None]
    return torch.where(any_gt, matches, torch.full(
        (), BELOW_LOW_THRESHOLD, dtype=torch.int32, device=iou.device))

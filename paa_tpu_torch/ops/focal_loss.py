"""Sigmoid focal loss (port of paa_tpu/ops/focal_loss.py).

The reference's CUDA kernel (paa_core/csrc/cuda/SigmoidFocalLoss_cuda.cu)
and its pure-torch CPU fallback (paa_core/layers/sigmoid_focal_loss.py:
40-52) compute, per class c in 1..C:

    p = sigmoid(x)
    loss = -(t == c) * (1-p)^g * log(p) * a
           -((t != c) & (t >= 0)) * p^g * log(1-p) * (1-a)

with targets 1..C positive, 0 negative and < 0 ignored. The JAX package
has no Pallas kernel here, so the port keeps the plain elementwise
formula, written with log-sigmoids, which autograd differentiates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits, targets, gamma, alpha):
    """logits: (..., N, C) float; targets: (..., N) int. Returns the
    (..., N, C) elementwise losses."""
    num_classes = logits.shape[-1]
    class_range = torch.arange(1, num_classes + 1, dtype=targets.dtype,
                               device=targets.device)
    t = targets[..., None]
    p = torch.sigmoid(logits)
    log_p = F.logsigmoid(logits)
    log_1mp = F.logsigmoid(-logits)
    pos_term = ((1 - p) ** gamma) * log_p
    neg_term = (p ** gamma) * log_1mp
    is_pos = (t == class_range).to(logits.dtype)
    is_neg = ((t != class_range) & (t >= 0)).to(logits.dtype)
    return -is_pos * pos_term * alpha - is_neg * neg_term * (1 - alpha)

"""FPN with RetinaNet-style P6/P7 (port of paa_tpu/modeling/fpn.py), in
the "R-*-FPN-RETINANET" wiring every PAA config uses: the C2 lateral is
skipped, P6 comes from P5 (RETINANET.USE_C5=False) and P7 from relu(P6).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv


def _upsample_nearest(x, target_hw):
    """Nearest resize of NCHW ``x`` to (H, W): a 2x repeat in the exact
    2x case FPN uses on padded inputs, else half-pixel-centre nearest
    like jax.image.resize."""
    h, w = x.shape[2:]
    if tuple(target_hw) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")


class FPN(nn.Module):
    """Takes [C2, C3, C4, C5]; returns (P3, P4, P5, P6, P7)."""

    def __init__(self, in_channels_list, out_channels=256,
                 dtype=torch.float32):
        super().__init__()
        used = in_channels_list[1:]  # C2 skipped
        for i, cin in enumerate(used):
            self.add_module(f"fpn_inner{i + 2}", Conv(
                cin, out_channels, 1, bias=True, dtype=dtype))
            self.add_module(f"fpn_layer{i + 2}", Conv(
                out_channels, out_channels, 3, padding=1, bias=True,
                dtype=dtype))
        self.num_used = len(used)
        self.p6 = Conv(out_channels, out_channels, 3, stride=2, padding=1,
                       bias=True, dtype=dtype)
        self.p7 = Conv(out_channels, out_channels, 3, stride=2, padding=1,
                       bias=True, dtype=dtype)

    def forward(self, features):
        used = list(features)[1:]
        n = self.num_used
        laterals = [getattr(self, f"fpn_inner{i + 2}")(f)
                    for i, f in enumerate(used)]
        merged = [None] * n
        merged[-1] = laterals[-1]
        for i in range(n - 2, -1, -1):
            top = _upsample_nearest(merged[i + 1], laterals[i].shape[2:])
            merged[i] = laterals[i] + top
        results = [getattr(self, f"fpn_layer{i + 2}")(m)
                   for i, m in enumerate(merged)]
        p6 = self.p6(results[-1])
        p7 = self.p7(F.relu(p6))
        return (*results, p6, p7)


class ResNetFPNBackbone(nn.Module):
    """body + fpn (reference backbone.py:49-73)."""

    def __init__(self, resnet, in_channels_list, out_channels=256,
                 dtype=torch.float32):
        super().__init__()
        self.resnet = resnet
        self.fpn = FPN(in_channels_list, out_channels, dtype=dtype)

    def forward(self, x):
        return self.fpn(self.resnet(x))

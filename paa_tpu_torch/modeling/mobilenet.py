"""MobileNetV2 body (port of paa_tpu/modeling/mobilenet.py; reference
paa_core/modeling/backbone/mobilenet.py).

The standard inverted-residual MobileNetV2 at width 1.0: a 3x3/2 stem
conv to 32 channels, then 17 blocks (1x1 expand, depthwise 3x3 through
the grouped ``Conv``, 1x1 linear projection; the residual where the
stride is 1 and the channels match), ReLU6 after the stem and inside
each block. It returns the features after blocks 3, 6, 13 and 17: 24,
32, 96 and 320 channels at strides 4, 8, 16 and 32, which the
MNV2-FPN-RETINANET wiring feeds to FPN without C2
(modeling/detector.py).

Every norm is a FrozenBatchNorm, as in the JAX package (the reference
says "Should freeze bn"; its BatchNorm2d in eval mode computes the same).
The JAX package ignores MODEL.USE_SYNCBN in this body, and four of the
five MNV2 FCOS configs set it: the port does the same. Modules carry the
flax scopes: ``stem_conv``, ``stem_bn``, ``block{i}/{pw, pw_bn, dw,
dw_bn, pw_linear, pw_linear_bn}``.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Conv, FrozenBatchNorm

# t (expansion), c (channels), n (repeats), s (stride of the first)
SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
RETURN_INDICES = (3, 6, 13, 17)


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, in_channels, out_channels, stride=1, expand_ratio=6,
                 dtype=torch.float32):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand = expand_ratio != 1
        if self.expand:
            self.pw = Conv(in_channels, hidden, 1, dtype=dtype)
            self.pw_bn = FrozenBatchNorm(hidden)
        self.dw = Conv(hidden, hidden, 3, stride=stride, padding=1,
                       groups=hidden, dtype=dtype)
        self.dw_bn = FrozenBatchNorm(hidden)
        self.pw_linear = Conv(hidden, out_channels, 1, dtype=dtype)
        self.pw_linear_bn = FrozenBatchNorm(out_channels)

    def forward(self, x):
        out = x
        if self.expand:
            out = relu6(self.pw_bn(self.pw(out)))
        out = relu6(self.dw_bn(self.dw(out)))
        out = self.pw_linear_bn(self.pw_linear(out))
        return x + out if self.use_res else out


class MobileNetV2(nn.Module):
    """(B, 3, H, W) -> [C2, C3, C4, C5] of 24, 32, 96 and 320 channels
    (width 1.0, the only one the JAX package builds)."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        channels = 32
        self.stem_conv = Conv(3, channels, 3, stride=2, padding=1,
                              dtype=dtype)
        self.stem_bn = FrozenBatchNorm(channels)
        idx = 0
        for t, c, n, s in SETTINGS:
            for i in range(n):
                idx += 1
                self.add_module(f"block{idx}", InvertedResidual(
                    channels, c, stride=s if i == 0 else 1, expand_ratio=t,
                    dtype=dtype))
                channels = c
        self.num_blocks = idx

    @staticmethod
    def feature_channels():
        return tuple(SETTINGS[i][1] for i in (1, 2, 4, 6))

    def forward(self, x):
        x = relu6(self.stem_bn(self.stem_conv(x)))
        outputs = []
        for idx in range(1, self.num_blocks + 1):
            x = getattr(self, f"block{idx}")(x)
            if idx in RETURN_INDICES:
                outputs.append(x)
        return outputs

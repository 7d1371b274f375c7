"""ResNet backbone (port of paa_tpu/modeling/resnet.py), cut to what
the PAA and Faster R-CNN R-50 and R-101 FPN configs without DCN run:
FrozenBatchNorm, stride in the 1x1, no groups, no dilation and no DCN.
The space-to-depth stem is a TPU lowering and is not ported. Returns
C2..C5 in NCHW.

``freeze_at`` (MODEL.BACKBONE.FREEZE_CONV_BODY_AT) freezes the stem
(stage 0) and ``layer{i}_*`` for i < freeze_at, as the reference's
``_freeze_backbone`` does (resnet.py:134-143): their parameters do not
require grad, the counterpart of the JAX package's "frozen" label
(paa_tpu/solver/build.py:64-94) and ``stop_gradient`` in its train step.
FrozenBatchNorm's tensors are buffers and never train.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, FrozenBatchNorm, max_pool_3x3_s2

# (block counts per stage, return_features per stage)
STAGE_SPECS = {
    "R-50-FPN": ((3, 4, 6, 3), (True, True, True, True)),
    "R-50-FPN-RETINANET": ((3, 4, 6, 3), (True, True, True, True)),
    "R-101-FPN": ((3, 4, 23, 3), (True, True, True, True)),
    "R-101-FPN-RETINANET": ((3, 4, 23, 3), (True, True, True, True)),
}


class Stem(nn.Module):
    """7x7/2 conv + FrozenBN + relu + 3x3/2 maxpool (resnet.py:345-364)."""

    def __init__(self, out_channels=64, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(3, out_channels, 7, stride=2, padding=3,
                          dtype=dtype)
        self.bn1 = FrozenBatchNorm(out_channels)

    def forward(self, x):
        return max_pool_3x3_s2(F.relu(self.bn1(self.conv1(x))))


class Bottleneck(nn.Module):
    """1x1 (stride) -> 3x3 -> 1x1 with residual (resnet.py:238-341)."""

    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(in_channels, bottleneck_channels, 1, stride=stride,
                          dtype=dtype)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3,
                          padding=1, dtype=dtype)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_channels)
        if in_channels != out_channels:
            self.downsample_conv = Conv(in_channels, out_channels, 1,
                                        stride=stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Config-shaped ResNet body returning [C2, C3, C4, C5]. Blocks are
    named ``layer{stage}_{block}`` like the flax scopes."""

    def __init__(self, body="R-50-FPN-RETINANET", width_per_group=64,
                 stem_out_channels=64, res2_out_channels=256,
                 dtype=torch.float32, freeze_at=0):
        super().__init__()
        self.block_counts, self.return_features = STAGE_SPECS[body]
        self.stem = Stem(stem_out_channels, dtype=dtype)
        in_channels = stem_out_channels
        for i, count in enumerate(self.block_counts):
            factor = 2 ** i
            out_channels = res2_out_channels * factor
            for b in range(count):
                stride = (1 if i == 0 else 2) if b == 0 else 1
                self.add_module(f"layer{i + 1}_{b}", Bottleneck(
                    in_channels, width_per_group * factor, out_channels,
                    stride=stride, dtype=dtype,
                ))
                in_channels = out_channels
        frozen = [self.stem] if freeze_at >= 1 else []
        frozen += [getattr(self, f"layer{i + 1}_{b}")
                   for i in range(min(freeze_at - 1, len(self.block_counts)))
                   for b in range(self.block_counts[i])]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        x = self.stem(x)
        outputs = []
        for i, count in enumerate(self.block_counts):
            for b in range(count):
                x = getattr(self, f"layer{i + 1}_{b}")(x)
            if self.return_features[i]:
                outputs.append(x)
        return outputs


def resnet_from_cfg(cfg, dtype=torch.float32):
    r = cfg.MODEL.RESNETS
    unsupported = {
        "TRANS_FUNC": r.TRANS_FUNC != "BottleneckWithFixedBatchNorm",
        "NUM_GROUPS": r.NUM_GROUPS != 1,
        "STRIDE_IN_1X1": not r.STRIDE_IN_1X1,
        "RES5_DILATION": r.RES5_DILATION != 1,
        "STAGE_WITH_DCN": any(r.STAGE_WITH_DCN),
        "USE_SYNCBN": cfg.MODEL.USE_SYNCBN,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad or cfg.MODEL.BACKBONE.CONV_BODY not in STAGE_SPECS:
        raise NotImplementedError(
            "paa_tpu_torch ports the FrozenBN ResNet FPN bodies "
            f"{sorted(STAGE_SPECS)} only; unsupported: "
            f"{bad or cfg.MODEL.BACKBONE.CONV_BODY}"
        )
    return ResNet(
        body=cfg.MODEL.BACKBONE.CONV_BODY,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        dtype=dtype,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
    )

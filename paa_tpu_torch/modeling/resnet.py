"""ResNet / ResNeXt backbone (port of paa_tpu/modeling/resnet.py) with
FrozenBatchNorm or GroupNorm: the FPN bodies R-50, R-101 and R-152,
ResNeXt grouped 3x3 convs (NUM_GROUPS x WIDTH_PER_GROUP), the stride in
the 1x1 or in the 3x3 (STRIDE_IN_1X1), a dilated res5 (RES5_DILATION)
and deformable 3x3 convs per stage (STAGE_WITH_DCN, v1 or modulated v2,
DEFORMABLE_GROUPS; ops/dcn.py). ``norm`` "gn" (TRANS_FUNC
BottleneckWithGN; StemWithGN follows it, as in the JAX package) puts a
``GroupNorm32`` in every norm's place under the same name (``bn1``,
``downsample_bn``, ...): K3 with the ReLU fused where one follows (the
stem's bn1, a block's bn1 and bn2), K3 alone before the residual add
(bn3, downsample_bn). MODEL.USE_SYNCBN (``norm`` "sync_bn", whatever
TRANS_FUNC says, as in the JAX package) puts a trainable
``SyncBatchNorm`` there instead: batch statistics over the global batch
in training mode, its running statistics in eval mode. The
space-to-depth stem is a TPU lowering and is not ported; the C5 bodies
are not ported yet. Returns
C2..C5 in NCHW, and for the C4 bodies (R-50-C4, R-101-C4: three stages,
the two-stage models' res5 is their box head) C4 alone.

``freeze_at`` (MODEL.BACKBONE.FREEZE_CONV_BODY_AT) freezes the stem
(stage 0) and ``layer{i}_*`` for i < freeze_at, as the reference's
``_freeze_backbone`` does (resnet.py:134-143): their parameters do not
require grad, the counterpart of the JAX package's "frozen" label
(paa_tpu/solver/build.py:64-94) and ``stop_gradient`` in its train step.
FrozenBatchNorm's tensors are buffers and never train; GroupNorm's and
SyncBatchNorm's affines are parameters and train outside the frozen
stages.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dcn  # ops/dcn.py imports .layers: bind the module
from .layers import (
    Conv, FrozenBatchNorm, GroupNorm32, SyncBatchNorm, max_pool_3x3_s2)

# (block counts per stage, return_features per stage)
STAGE_SPECS = {
    "R-50-C4": ((3, 4, 6), (False, False, True)),
    "R-101-C4": ((3, 4, 23), (False, False, True)),
    "R-50-FPN": ((3, 4, 6, 3), (True, True, True, True)),
    "R-50-FPN-RETINANET": ((3, 4, 6, 3), (True, True, True, True)),
    "R-101-FPN": ((3, 4, 23, 3), (True, True, True, True)),
    "R-101-FPN-RETINANET": ((3, 4, 23, 3), (True, True, True, True)),
    "R-152-FPN": ((3, 8, 36, 3), (True, True, True, True)),
    "R-152-FPN-RETINANET": ((3, 8, 36, 3), (True, True, True, True)),
}


def make_norm(norm, features, relu):
    """The norm of a ResNet body: FrozenBatchNorm ("frozen_bn") or
    SyncBatchNorm ("sync_bn"), whose ReLU the caller applies, or
    GroupNorm32 ("gn") with the ReLU fused when ``relu``."""
    if norm == "frozen_bn":
        return FrozenBatchNorm(features)
    if norm == "sync_bn":
        return SyncBatchNorm(features)
    if norm == "gn":
        return GroupNorm32(features, relu=relu)
    raise ValueError(norm)


def norm_relu(norm, x):
    """norm(x) followed by a ReLU: F.relu after a batch norm, none after
    a GroupNorm32 that fused it."""
    x = norm(x)
    return x if isinstance(norm, GroupNorm32) else F.relu(x)


class Stem(nn.Module):
    """7x7/2 conv + norm + relu + 3x3/2 maxpool (resnet.py:345-364)."""

    def __init__(self, out_channels=64, dtype=torch.float32,
                 norm="frozen_bn"):
        super().__init__()
        self.conv1 = Conv(3, out_channels, 7, stride=2, padding=3,
                          dtype=dtype)
        self.bn1 = make_norm(norm, out_channels, relu=True)

    def forward(self, x):
        return max_pool_3x3_s2(norm_relu(self.bn1, self.conv1(x)))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (groups, stride or dilation, optionally deformable) ->
    1x1 with residual (resnet.py:238-341). With a dilation above 1 the
    block does not stride (resnet.py:111-114)."""

    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, num_groups=1, stride_in_1x1=True, dilation=1,
                 with_dcn=False, with_modulated_dcn=False,
                 deformable_groups=1, dtype=torch.float32,
                 norm="frozen_bn"):
        super().__init__()
        stride = 1 if dilation > 1 else stride
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv(in_channels, bottleneck_channels, 1,
                          stride=stride_1x1, dtype=dtype)
        self.bn1 = make_norm(norm, bottleneck_channels, relu=True)
        if with_dcn:
            self.conv2 = dcn.DeformConv(
                bottleneck_channels, bottleneck_channels, 3,
                stride=stride_3x3, padding=dilation, dilation=dilation,
                groups=num_groups, deformable_groups=deformable_groups,
                modulated=with_modulated_dcn, dtype=dtype)
        else:
            self.conv2 = Conv(bottleneck_channels, bottleneck_channels, 3,
                              stride=stride_3x3, padding=dilation,
                              dtype=dtype, groups=num_groups,
                              dilation=dilation)
        self.bn2 = make_norm(norm, bottleneck_channels, relu=True)
        self.conv3 = Conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.bn3 = make_norm(norm, out_channels, relu=False)
        if in_channels != out_channels:
            self.downsample_conv = Conv(in_channels, out_channels, 1,
                                        stride=stride, dtype=dtype)
            self.downsample_bn = make_norm(norm, out_channels, relu=False)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = norm_relu(self.bn1, self.conv1(x))
        out = norm_relu(self.bn2, self.conv2(out))
        out = self.bn3(self.conv3(out))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Config-shaped ResNet body returning [C2, C3, C4, C5]. Blocks are
    named ``layer{stage}_{block}`` like the flax scopes; the bottleneck
    of stage i is num_groups * width_per_group * 2**i wide."""

    def __init__(self, body="R-50-FPN-RETINANET", num_groups=1,
                 width_per_group=64, stem_out_channels=64,
                 res2_out_channels=256, stride_in_1x1=True,
                 stage_with_dcn=(False, False, False, False),
                 with_modulated_dcn=False, deformable_groups=1,
                 res5_dilation=1, dtype=torch.float32, freeze_at=0,
                 norm="frozen_bn"):
        super().__init__()
        self.block_counts, self.return_features = STAGE_SPECS[body]
        self.stem = Stem(stem_out_channels, dtype=dtype, norm=norm)
        in_channels = stem_out_channels
        for i, count in enumerate(self.block_counts):
            factor = 2 ** i
            out_channels = res2_out_channels * factor
            for b in range(count):
                stride = (1 if i == 0 else 2) if b == 0 else 1
                self.add_module(f"layer{i + 1}_{b}", Bottleneck(
                    in_channels, num_groups * width_per_group * factor,
                    out_channels, stride=stride, num_groups=num_groups,
                    stride_in_1x1=stride_in_1x1,
                    dilation=res5_dilation if i == 3 else 1,
                    with_dcn=i < len(stage_with_dcn) and stage_with_dcn[i],
                    with_modulated_dcn=with_modulated_dcn,
                    deformable_groups=deformable_groups, dtype=dtype,
                    norm=norm,
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


# TRANS_FUNC -> the body's norm (the JAX package's resnet_from_cfg; the
# stem follows it whatever STEM_FUNC says)
NORMS = {"BottleneckWithFixedBatchNorm": "frozen_bn",
         "BottleneckWithGN": "gn"}


def resnet_from_cfg(cfg, dtype=torch.float32):
    r = cfg.MODEL.RESNETS
    if r.TRANS_FUNC not in NORMS or \
            cfg.MODEL.BACKBONE.CONV_BODY not in STAGE_SPECS:
        raise NotImplementedError(
            "paa_tpu_torch ports the FrozenBN, GN and SyncBN ResNet FPN and "
            f"C4 bodies {sorted(STAGE_SPECS)} of TRANS_FUNC {sorted(NORMS)} "
            f"only, not {cfg.MODEL.BACKBONE.CONV_BODY} with {r.TRANS_FUNC}")
    # the reference converts the whole model to SyncBatchNorm
    # (tools/train_net.py:35-38); the JAX package its ResNet bodies
    norm = "sync_bn" if cfg.MODEL.USE_SYNCBN else NORMS[r.TRANS_FUNC]
    return ResNet(
        body=cfg.MODEL.BACKBONE.CONV_BODY,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        stride_in_1x1=r.STRIDE_IN_1X1,
        stage_with_dcn=tuple(r.STAGE_WITH_DCN),
        with_modulated_dcn=r.WITH_MODULATED_DCN,
        deformable_groups=r.DEFORMABLE_GROUPS,
        res5_dilation=r.RES5_DILATION,
        dtype=dtype,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
        norm=norm,
    )

"""FBNet / ChamNet mobile bodies and heads (port of
paa_tpu/modeling/fbnet.py; reference paa_core/modeling/backbone/fbnet*.py).

An architecture is a table of stages, each a list of ``(op, t, c, n,
s)`` groups (op ``ir_k{1,3,5,7}``: an inverted-residual block with that
depthwise kernel; expansion t, channels c, n repeats, stride s of the
first repeat, a negative s a nearest x|s| upsample). The table's roles
pick stages for the trunk ("backbone": one feature map, stride 16 for
every shipped arch), the RPN head ("rpn"), the box head ("bbox") and
the mask head ("mask"). Widths scale by SCALE_FACTOR and round to
WIDTH_DIVISOR (``divisible_width``, the reference's py2 rounding).

``bn`` norms are FrozenBatchNorm; ``gn`` norms are GroupNorm32 (K3 on
the card, its ReLU fused where one follows and alone where none does;
no shipped config sets it). The depthwise conv of a block has neither
norm nor ReLU: the JAX package keeps MODEL.FBNET.DW_CONV_SKIP_BN and
DW_CONV_SKIP_RELU at their defaults (True) and never reads the config.
The depthwise convs go through the grouped ``Conv`` (cuDNN on the
card). Modules carry the flax scopes (``first``, ``stages/block{i}/{pw,
dw, pwl}/{conv, bn}``, ``rpn_stages``, ``bbox_stages``,
``mask_stages``, ...). The tables are the port's own copy.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import roi_align
from .layers import Conv, ConvTranspose, FrozenBatchNorm, GroupNorm32, Linear

_HEAD_STD = 0.01  # the RPN convs' and cls_score's normal init

# Per stage: (op, expansion t, channels c, repeats n, stride s); the roles
# index the stages (fbnet_modeldef.py:11-218)
FBNET_ARCHS = {
    "default": dict(
        first=(32, 2),
        stages=[
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 24, 2, 2)],
            [("ir_k3", 6, 32, 3, 2)],
            [("ir_k3", 6, 64, 4, 2), ("ir_k3", 6, 96, 3, 1)],
            [("ir_k3", 4, 160, 1, 2), ("ir_k3", 6, 160, 2, 1),
             ("ir_k3", 6, 240, 1, 1)],
            [("ir_k3", 6, 96, 3, 1)],
            [("ir_k3", 4, 160, 1, 1), ("ir_k3", 6, 160, 3, 1),
             ("ir_k3", 3, 80, 1, -2)],
        ],
        backbone=(0, 1, 2, 3), rpn=(5,), bbox=(4,), mask=(6,),
    ),
    "xirb16d_dsmask": dict(
        first=(16, 2),
        stages=[
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 32, 2, 2)],
            [("ir_k3", 6, 48, 3, 2)],
            [("ir_k3", 6, 96, 4, 2), ("ir_k3", 6, 128, 3, 1)],
            [("ir_k3", 4, 128, 1, 2), ("ir_k3", 6, 128, 2, 1),
             ("ir_k3", 6, 160, 1, 1)],
            [("ir_k3", 4, 128, 1, 2), ("ir_k3", 6, 128, 2, 1),
             ("ir_k3", 6, 128, 1, -2), ("ir_k3", 3, 64, 1, -2)],
            [("ir_k3", 6, 128, 3, 1)],
        ],
        backbone=(0, 1, 2, 3), rpn=(6,), bbox=(4,), mask=(5,),
    ),
    "mobilenet_v2": dict(
        first=(32, 2),
        stages=[
            [("ir_k3", 1, 16, 1, 1)],
            [("ir_k3", 6, 24, 2, 2)],
            [("ir_k3", 6, 32, 3, 2)],
            [("ir_k3", 6, 64, 4, 2), ("ir_k3", 6, 96, 3, 1)],
            [("ir_k3", 6, 160, 3, 1), ("ir_k3", 6, 320, 1, 1)],
        ],
        backbone=(0, 1, 2, 3), bbox=(4,),
    ),
    "cham_v1a": dict(
        first=(32, 2),
        stages=[
            [("ir_k3", 1, 24, 1, 1)],
            [("ir_k7", 4, 48, 2, 2)],
            [("ir_k3", 7, 64, 5, 2)],
            [("ir_k5", 12, 56, 7, 2), ("ir_k3", 8, 88, 5, 1)],
            [("ir_k3", 7, 152, 4, 2), ("ir_k3", 10, 104, 1, 1)],
            [("ir_k3", 8, 88, 3, 1)],
        ],
        backbone=(0, 1, 2, 3), rpn=(5,), bbox=(4,),
    ),
    "cham_v2": dict(
        first=(32, 2),
        stages=[
            [("ir_k3", 1, 24, 1, 1)],
            [("ir_k5", 8, 32, 4, 2)],
            [("ir_k7", 5, 48, 6, 2)],
            [("ir_k5", 9, 56, 3, 2), ("ir_k3", 6, 56, 6, 1)],
            [("ir_k3", 2, 160, 6, 2), ("ir_k3", 6, 112, 1, 1)],
            [("ir_k3", 6, 56, 1, 1)],
        ],
        backbone=(0, 1, 2, 3), rpn=(5,), bbox=(4,),
    ),
}

OP_KERNEL = {"ir_k1": 1, "ir_k3": 3, "ir_k5": 5, "ir_k7": 7}


def divisible_width(width, divisor):
    """The reference's rounding of a width to a divisor: a width
    already divisible passes; otherwise py2's round-half-up of width /
    divisor, times divisor, where a rounding to 0 gives divisor *
    divisor (the reference's ``or min_val``)."""
    w = int(width)
    if divisor <= 0 or w % divisor == 0:
        return w
    r = math.floor(w / divisor + 0.5) or divisor
    return r * divisor


def expand_stage(stage):
    """(op, t, c, n, s) groups -> one (op, t, c, s) per block, the stride
    on the first repeat only."""
    return [(op, t, c, s if i == 0 else 1)
            for op, t, c, n, s in stage for i in range(n)]


def expanded_blocks(arch, role):
    """The blocks of a role ("backbone", "rpn", "bbox" or "mask")."""
    return [b for si in arch[role] for b in expand_stage(arch["stages"][si])]


def fbnet_out_channels(arch_name, role, width_ratio=1.0, width_divisor=1):
    """The channels after a role's blocks."""
    c = expanded_blocks(FBNET_ARCHS[arch_name], role)[-1][2]
    return divisible_width(int(c * width_ratio), width_divisor)


def fbnet_trunk_stride(arch_name):
    """The trunk's output stride: the first conv's times each stride,
    divided by each upsample."""
    arch = FBNET_ARCHS[arch_name]
    s = arch["first"][1]
    for *_, bs in expanded_blocks(arch, "backbone"):
        s = s * bs if bs > 0 else s // -bs
    return s


class ConvNormRelu(nn.Module):
    """A bias-free conv (kaiming-uniform), then its norm ("bn":
    FrozenBatchNorm; "gn": GroupNorm32 through K3) and a ReLU."""

    def __init__(self, in_channels, out_channels, kernel=3, stride=1,
                 groups=1, use_relu=True, use_norm=True, bn_type="bn",
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel, stride=stride,
                         padding=kernel // 2, groups=groups, dtype=dtype)
        self.use_relu = use_relu
        if use_norm and bn_type == "gn":
            self.gn = GroupNorm32(out_channels, relu=use_relu)
        elif use_norm:
            self.bn = FrozenBatchNorm(out_channels)

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, "gn"):
            return self.gn(x)  # its ReLU fused, if any
        if hasattr(self, "bn"):
            x = self.bn(x)
        return F.relu(x) if self.use_relu else x


class SEModule(nn.Module):
    """Squeeze-excitation with a /4 reduction:
    x * sigmoid(fc2(relu(fc1(mean over H, W))))."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        mid = max(channels // 4, 1)
        self.fc1 = Conv(channels, mid, 1, bias=True, dtype=dtype)
        self.fc2 = Conv(mid, channels, 1, bias=True, dtype=dtype)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(F.relu(self.fc1(s))))


class IRFBlock(nn.Module):
    """The inverted-residual block (the reference's IRFBlock): 1x1 expand
    to divisible_width(in * t) with its norm and ReLU; a negative stride
    s upsamples x|s| (nearest) before a stride-1 depthwise kxk conv,
    which has no norm or ReLU; 1x1 linear projection with its norm; the
    residual when the stride is 1 and the channels match; ``se`` (no
    shipped arch sets it) a squeeze-excitation after."""

    def __init__(self, in_channels, out_channels, expansion, stride,
                 kernel=3, width_divisor=1, bn_type="bn", se=False,
                 dtype=torch.float32):
        super().__init__()
        mid = divisible_width(int(in_channels * expansion), width_divisor)
        self.use_res = stride == 1 and in_channels == out_channels
        self.upsample = -stride if stride < 0 else 1
        self.pw = ConvNormRelu(in_channels, mid, 1, bn_type=bn_type,
                               dtype=dtype)
        if kernel > 1:
            self.dw = ConvNormRelu(mid, mid, kernel, stride=max(stride, 1),
                                   groups=mid, use_norm=False,
                                   use_relu=False, dtype=dtype)
        self.pwl = ConvNormRelu(mid, out_channels, 1, use_relu=False,
                                bn_type=bn_type, dtype=dtype)
        self.se = SEModule(out_channels, dtype=dtype) if se else None

    def forward(self, x):
        y = self.pw(x)
        if self.upsample > 1:
            f = self.upsample
            y = y.repeat_interleave(f, dim=2).repeat_interleave(f, dim=3)
        if hasattr(self, "dw"):
            y = self.dw(y)
        y = self.pwl(y)
        if self.use_res:
            y = y + x
        return self.se(y) if self.se is not None else y


class FBNetStages(nn.Module):
    """A run of expanded blocks ``block{i}``, each
    out_channels divisible_width(c * width_ratio)."""

    def __init__(self, in_channels, blocks, width_ratio=1.0, width_divisor=1,
                 bn_type="bn", dtype=torch.float32):
        super().__init__()
        self.num_blocks = len(blocks)
        for i, (op, t, c, s) in enumerate(blocks):
            out = divisible_width(int(c * width_ratio), width_divisor)
            self.add_module(f"block{i}", IRFBlock(
                in_channels, out, t, s, kernel=OP_KERNEL[op],
                width_divisor=width_divisor, bn_type=bn_type, dtype=dtype))
            in_channels = out
        self.out_channels = in_channels

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def _stages(arch, role, in_channels, width_ratio, width_divisor, bn_type,
            dtype):
    return FBNetStages(in_channels, expanded_blocks(FBNET_ARCHS[arch], role),
                       width_ratio, width_divisor, bn_type, dtype)


class FBNetTrunk(nn.Module):
    """The first conv (3x3, its stride) and the backbone stages: (B, 3, H,
    W) -> [one map at ``fbnet_trunk_stride``]."""

    def __init__(self, arch="default", width_ratio=1.0, width_divisor=1,
                 bn_type="bn", dtype=torch.float32):
        super().__init__()
        first_c, first_s = FBNET_ARCHS[arch]["first"]
        first = divisible_width(int(first_c * width_ratio), width_divisor)
        self.first = ConvNormRelu(3, first, 3, stride=first_s,
                                  bn_type=bn_type, dtype=dtype)
        self.stages = _stages(arch, "backbone", first, width_ratio,
                              width_divisor, bn_type, dtype)
        self.out_channels = self.stages.out_channels

    def forward(self, x):
        return [self.stages(self.first(x))]


class FBNetRPNHead(nn.Module):
    """The arch's "rpn" stages on each map, then 1x1 objectness and box
    convs (normal(0.01)); the RPN head's outputs in RPNHead's layout."""

    def __init__(self, arch, in_channels, num_anchors=15, width_ratio=1.0,
                 width_divisor=1, bn_type="bn", dtype=torch.float32):
        super().__init__()
        self.rpn_stages = _stages(arch, "rpn", in_channels, width_ratio,
                                  width_divisor, bn_type, dtype)
        c = self.rpn_stages.out_channels
        self.cls_logits = Conv(c, num_anchors, 1, bias=True, dtype=dtype,
                               normal_std=_HEAD_STD)
        self.bbox_pred = Conv(c, num_anchors * 4, 1, bias=True, dtype=dtype,
                              normal_std=_HEAD_STD)

    def forward(self, features):
        logits, reg = [], []
        for f in features:
            t = self.rpn_stages(f)
            b = f.shape[0]
            logits.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(
                b, -1))
            reg.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(
                b, -1, 4))
        return {"objectness": torch.cat(logits, dim=1),
                "box_regression": torch.cat(reg, dim=1)}


def _pool(features, rois, roi_batch_idx, resolution, scale):
    """ROIAlign of the trunk's one map (sampling ratio 2, as the JAX
    package's FBNet heads take it whatever the config), NCHW."""
    return roi_align(features[0], rois, roi_batch_idx,
                     (resolution, resolution), scale,
                     2).permute(0, 3, 1, 2).contiguous()


class FBNetROIBoxHead(nn.Module):
    """ROIAlign (POOLER_RESOLUTION, 1 / stride), the arch's "bbox" stages,
    a float32 mean over H, W, and the float32 cls_score (normal(0.01))
    and class-specific bbox_pred (normal(0.001)); Res5ROIBoxHead's
    outputs."""

    def __init__(self, arch, in_channels, num_classes=81, resolution=6,
                 scale=1.0 / 16, width_ratio=1.0, width_divisor=1,
                 bn_type="bn", dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # INCLUDING background
        self.pool = (resolution, scale)
        self.bbox_stages = _stages(arch, "bbox", in_channels, width_ratio,
                                   width_divisor, bn_type, dtype)
        c = self.bbox_stages.out_channels
        self.cls_score = Linear(c, num_classes, normal_std=_HEAD_STD)
        self.bbox_pred = Linear(c, num_classes * 4, normal_std=0.001)

    def forward(self, features, proposals, proposal_batch_idx):
        x = self.bbox_stages(_pool(features, proposals, proposal_batch_idx,
                                   *self.pool))
        pooled = x.to(torch.float32).mean(dim=(2, 3))
        r = pooled.shape[0]
        return (self.cls_score(pooled),
                self.bbox_pred(pooled).reshape(r, self.num_classes, 4))


class FBNetMaskHead(nn.Module):
    """ROIAlign (ROI_MASK_HEAD.POOLER_RESOLUTION, 1 / stride), the arch's
    "mask" stages (whose negative strides upsample: 6 -> 12 for
    "default", 6 -> 3 -> 6 -> 12 for xirb16d_dsmask), with
    ``use_deconv`` (PREDICTOR not MaskRCNNConv1x1Predictor) the float32
    2x2 deconv and a ReLU, then the float32 1x1 mask_fcn_logits
    (normal(0.001)): (R, C - 1, M, M) float32 logits."""

    def __init__(self, arch, in_channels, num_classes=80, resolution=14,
                 scale=1.0 / 16, width_ratio=1.0, width_divisor=1,
                 bn_type="bn", use_deconv=True, dtype=torch.float32):
        super().__init__()
        self.pool = (resolution, scale)
        self.mask_stages = _stages(arch, "mask", in_channels, width_ratio,
                                   width_divisor, bn_type, dtype)
        c = self.mask_stages.out_channels
        self.conv5_mask = ConvTranspose(c, c) if use_deconv else None
        self.mask_fcn_logits = Conv(c, num_classes, 1, bias=True,
                                    normal_std=0.001)

    def forward(self, features, rois, roi_batch_idx):
        x = self.mask_stages(_pool(features, rois, roi_batch_idx,
                                   *self.pool))
        if self.conv5_mask is not None:
            x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x)

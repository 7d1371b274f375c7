"""The plain reference of the PAA detectors the benchmark runs: a
FrozenBN ResNet / ResNeXt body (optionally with modulated deformable 3x3
convs), the RetinaNet-style FPN (P3-P7, P6 from P5 or C5), and the PAA
head (two towers of [3x3 conv, GroupNorm(32) + ReLU], cls_logits,
per-level Scale on bbox_pred, iou_pred).

Plain PyTorch in float32. Module and parameter names follow the
measured program's, so one state dict made by the benchmark loads into
both sides. Nothing here imports the program.

``quant`` (default: none) is applied to the input and the weight of
every convolution and contraction. The correctness control puts an fp8
rounding there (``fp8_round``): the reference computed one precision
below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def fp8_round(t):
    """``t`` rounded to float8 e4m3 with one scale per tensor (its
    largest magnitude at the top of the format), returned in float32."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _identity(t):
    return t


class Conv(nn.Module):
    """Conv2d in float32 (weight (O, C/groups, k, k), optional bias)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, bias=False,
                 groups=1, dilation=1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.groups, self.dilation = groups, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.quant = _identity

    def forward(self, x):
        return F.conv2d(self.quant(x.float()), self.quant(self.weight),
                        self.bias, self.stride, self.padding, self.dilation,
                        self.groups)


class FrozenBatchNorm(nn.Module):
    """y = x * weight / sqrt(var) + (bias - mean * scale), no epsilon."""

    def __init__(self, n):
        super().__init__()
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), fill))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


class GroupNorm32(nn.Module):
    """GroupNorm over 32 groups (eps 1e-5), then ReLU."""

    def __init__(self, n):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        b, c, h, w = x.shape
        xf = x.reshape(b, 32, -1)
        mean = xf.mean(dim=2, keepdim=True)
        var = (xf - mean).square().mean(dim=2, keepdim=True)
        xn = ((xf - mean) * torch.rsqrt(var + 1e-5)).reshape(b, c, h, w)
        out = xn * self.weight[:, None, None] + self.bias[:, None, None]
        # max(out, 0): its gradient at exactly 0 is half the upstream one
        return torch.maximum(out, out.new_zeros(()))


def deform_conv2d(x, offsets, mask, weight, stride, padding, dilation,
                  groups, quant=_identity):
    """Modulated deformable conv (one deformable group), written out:
    each output position samples the input bilinearly at its K shifted
    taps (zero outside the image; a sample whose point lies outside
    (-1, H) x (-1, W) is zero), weighted by the mask, then the (K, C)
    columns meet the weight per conv group. Processed one image at a
    time."""
    b, c, h, w = x.shape
    o, cg, kh, kw = weight.shape
    k = kh * kw
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev = x.device
    taps = torch.arange(k, device=dev)
    ky = (taps // kw).float() * dilation
    kx = (taps % kw).float() * dilation
    base_y = torch.arange(ho, device=dev).float() * stride - padding
    base_x = torch.arange(wo, device=dev).float() * stride - padding
    wmat = quant(weight).reshape(groups, o // groups, cg * k)
    outs = []
    for i in range(b):
        off = offsets[i].float().reshape(k, 2, ho, wo)
        ys = base_y[None, :, None] + ky[:, None, None] + off[:, 0]
        xs = base_x[None, None, :] + kx[:, None, None] + off[:, 1]
        inside = ((ys > -1) & (ys < h) & (xs > -1) & (xs < w)).float()
        y0, x0 = torch.floor(ys), torch.floor(xs)
        ly, lx = ys - y0, xs - x0
        img = quant(x[i].float()).reshape(c, h * w)
        col = x.new_zeros((c, k, ho, wo), dtype=torch.float32)
        for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                           (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
            yy, xx = y0 + dy, x0 + dx
            ok = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            vals = img[:, idx.reshape(-1)].reshape(c, k, ho, wo)
            col = col + vals * (wt * ok * inside)[None]
        if mask is not None:
            col = col * mask[i].float().reshape(1, k, ho, wo)
        # (C, K, P) -> per group (C/g * K, P), channel-major as the weight
        col = col.reshape(groups, cg * k, ho * wo)
        outs.append(torch.bmm(wmat, col).reshape(o, ho, wo))
    return torch.stack(outs)


class DeformConv(nn.Module):
    """Offset conv (float32, with bias: 2K offsets as (dy, dx) per tap,
    then K mask logits through a sigmoid) + deformable sampling +
    weight; optional bias."""

    def __init__(self, cin, cout, k=3, stride=1, padding=1, dilation=1,
                 groups=1, bias=False):
        super().__init__()
        self.offset = Conv(cin, 3 * k * k, k, stride, padding, bias=True,
                           dilation=dilation)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups = groups
        self.quant = _identity

    def forward(self, x):
        om = self.offset(x)
        n = 2 * self.weight.shape[2] * self.weight.shape[3]
        out = deform_conv2d(x, om[:, :n], torch.sigmoid(om[:, n:]),
                            self.weight, self.stride, self.padding,
                            self.dilation, self.groups, self.quant)
        if self.bias is not None:
            out = out + self.bias[:, None, None]
        return out


class Stem(nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv1 = Conv(3, cout, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride, groups, stride_in_1x1, dcn):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv(cin, mid, 1, stride=s1)
        self.bn1 = FrozenBatchNorm(mid)
        if dcn:
            self.conv2 = DeformConv(mid, mid, 3, stride=s3, padding=1,
                                    groups=groups)
        else:
            self.conv2 = Conv(mid, mid, 3, stride=s3, padding=1,
                              groups=groups)
        self.bn2 = FrozenBatchNorm(mid)
        self.conv3 = Conv(mid, cout, 1)
        self.bn3 = FrozenBatchNorm(cout)
        if cin != cout:
            self.downsample_conv = Conv(cin, cout, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(cout)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet(nn.Module):
    """Blocks ``layer{stage}_{block}``; returns C2..C5."""

    def __init__(self, body):
        super().__init__()
        self.blocks = list(body["blocks"])
        self.stem = Stem(body["stem_out"])
        cin = body["stem_out"]
        for i, count in enumerate(self.blocks):
            cout = body["res2_out"] * 2 ** i
            mid = body["groups"] * body["width_per_group"] * 2 ** i
            for j in range(count):
                stride = (1 if i == 0 else 2) if j == 0 else 1
                self.add_module(f"layer{i + 1}_{j}", Bottleneck(
                    cin, mid, cout, stride, body["groups"],
                    body["stride_in_1x1"], body["stage_with_dcn"][i]))
                cin = cout
        frozen = [self.stem] if body["freeze_at"] >= 1 else []
        frozen += [getattr(self, f"layer{i + 1}_{j}")
                   for i in range(min(body["freeze_at"] - 1, 4))
                   for j in range(self.blocks[i])]
        for m in frozen:
            m.requires_grad_(False)

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i, count in enumerate(self.blocks):
            for j in range(count):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """Laterals and outputs of C3..C5 (``fpn_inner2..4``,
    ``fpn_layer2..4``), P6 (3x3/2 from P5, or from C5) and P7 (3x3/2 of
    relu(P6))."""

    def __init__(self, in_channels, out, p6_from_c5):
        super().__init__()
        for k, cin in zip((2, 3, 4), in_channels[1:]):
            self.add_module(f"fpn_inner{k}", Conv(cin, out, 1, bias=True))
            self.add_module(f"fpn_layer{k}", Conv(out, out, 3, padding=1,
                                                  bias=True))
        self.p6_from_c5 = p6_from_c5
        self.p6 = Conv(in_channels[-1] if p6_from_c5 else out, out, 3,
                       stride=2, padding=1, bias=True)
        self.p7 = Conv(out, out, 3, stride=2, padding=1, bias=True)

    def forward(self, feats):
        c3, c4, c5 = feats[1:]
        lat = [self.fpn_inner2(c3), self.fpn_inner3(c4), self.fpn_inner4(c5)]
        merged = [None, None, lat[2]]
        for i in (1, 0):
            top = merged[i + 1]
            if tuple(lat[i].shape[2:]) == (2 * top.shape[2], 2 * top.shape[3]):
                top = top.repeat_interleave(2, 2).repeat_interleave(2, 3)
            else:
                top = F.interpolate(top, size=lat[i].shape[2:],
                                    mode="nearest-exact")
            merged[i] = lat[i] + top
        outs = [self.fpn_layer2(merged[0]), self.fpn_layer3(merged[1]),
                self.fpn_layer4(merged[2])]
        p6 = self.p6(c5 if self.p6_from_c5 else outs[-1])
        return [*outs, p6, self.p7(F.relu(p6))]


class Backbone(nn.Module):
    def __init__(self, body, fpn):
        super().__init__()
        self.resnet = ResNet(body)
        chans = [body["res2_out"] * 2 ** i for i in range(4)]
        self.fpn = FPN(chans, fpn["out_channels"], fpn["p6_from_c5"])

    def forward(self, x):
        return self.fpn(self.resnet(x))


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        return x * self.scale


class Tower(nn.Module):
    def __init__(self, ch, n, dcn_last):
        super().__init__()
        self.n = n
        for i in range(n):
            if dcn_last and i == n - 1:
                conv = DeformConv(ch, ch, 3, padding=1, bias=True)
            else:
                conv = Conv(ch, ch, 3, padding=1, bias=True)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"gn{i}", GroupNorm32(ch))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"gn{i}")(getattr(self, f"conv{i}")(x))
        return x


class PAAHead(nn.Module):
    """Outputs per level, flattened in (y, x) order and concatenated:
    cls_logits (B, N, C), box_regression (B, N, 4), iou_pred (B, N)."""

    def __init__(self, head, ch, levels):
        super().__init__()
        self.num_classes = head["num_classes"]
        self.cls_tower = Tower(ch, head["num_convs"], head["dcn_in_tower"])
        self.bbox_tower = Tower(ch, head["num_convs"], head["dcn_in_tower"])
        self.cls_logits = Conv(ch, self.num_classes, 3, padding=1, bias=True)
        self.bbox_pred = Conv(ch, 4, 3, padding=1, bias=True)
        self.iou_pred = Conv(ch, 1, 3, padding=1, bias=True)
        for i in range(levels):
            self.add_module(f"scale{i}", Scale())

    def forward(self, feats):
        cls, reg, iou = [], [], []
        for i, f in enumerate(feats):
            ct, bt = self.cls_tower(f), self.bbox_tower(f)
            b = f.shape[0]
            cls.append(self.cls_logits(ct).permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes))
            r = getattr(self, f"scale{i}")(self.bbox_pred(bt))
            reg.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
            iou.append(self.iou_pred(bt).permute(0, 2, 3, 1).reshape(b, -1))
        return {"cls_logits": torch.cat(cls, 1),
                "box_regression": torch.cat(reg, 1),
                "iou_pred": torch.cat(iou, 1)}


class Detector(nn.Module):
    """backbone -> head, named as the program's ``DenseDetector``."""

    def __init__(self, ref):
        super().__init__()
        self.backbone = Backbone(ref["body"], ref["fpn"])
        self.head = PAAHead(ref["head"], ref["fpn"]["out_channels"],
                            len(ref["anchors"]["strides"]))

    def forward(self, x):
        return self.head(self.backbone(x))


def build(ref, precision="float32"):
    """The reference detector of a configuration's ``reference`` section,
    with its parameters uninitialised (the benchmark loads them).
    ``precision`` "fp8" rounds every conv's input and weight to fp8."""
    model = Detector(ref)
    set_precision(model, precision)
    return model


def set_precision(model, precision):
    quant = {"float32": _identity, "fp8": fp8_round}[precision]
    for m in model.modules():
        if isinstance(m, (Conv, DeformConv)):
            m.quant = quant
    return model


def normalize(images, sizes, mean, std):
    """(B, H, W, 3) uint8 -> (B, 3, H, W) float32, (x - mean) / std,
    the padding beyond each image's (h, w) zero."""
    x = images.float() - torch.tensor(mean, device=images.device)
    x = x / torch.tensor(std, device=images.device)
    h, w = images.shape[1:3]
    ys = torch.arange(h, device=images.device)[None, :, None]
    xs = torch.arange(w, device=images.device)[None, None, :]
    inside = (ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])
    x = torch.where(inside[..., None], x, 0.0)
    return x.permute(0, 3, 1, 2).contiguous()


def feature_shapes(hw, strides):
    return [(math.ceil(hw[0] / s), math.ceil(hw[1] / s)) for s in strides]

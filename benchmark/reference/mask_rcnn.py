"""The plain reference of Mask R-CNN R-50-FPN at inference (He et al.,
"Mask R-CNN", ICCV 2017; maskrcnn-benchmark's
configs/e2e_mask_rcnn_R_50_FPN_1x.yaml):

- the body: ``model.py``'s FrozenBN ResNet, C2..C5;
- the FPN in its P2-P6 wiring: 1x1 laterals ``fpn_inner1..4`` and 3x3
  outputs ``fpn_layer1..4`` of C2..C5, the top-down sum through a 2x
  nearest upsample, P6 the 1x1 stride-2 max pool of P5
  (LastLevelMaxPool);
- the RPN head: a 3x3 conv + ReLU, then per location A objectness logits
  and 4A deltas (1x1 convs), flattened in (y, x, anchor) order;
- the anchors: one size per level (32..512 at strides 4..64), ratios
  0.5, 1 and 2, in (y, x, ratio) order;
- ``select_proposals``: per level the top PRE_NMS_TOP_N by objectness,
  decoded with weights (1, 1, 1, 1), clipped, greedy NMS at NMS_THRESH
  keeping POST_NMS_TOP_N; then per image the top FPN_POST_NMS_TOP_N of
  every level's picks by objectness;
- ROIAlign as the legacy kernel computes it (aligned=False; ROIAlign_cuda.cu):
  the roi scaled, its extent max(end - start, 1), ``sampling_ratio``
  samples per bin along each axis, a sample outside [-1, H] x [-1, W]
  zero, else clamped into the map and interpolated bilinearly, the
  bin's samples averaged; the FPN pooler (poolers.py) sends each roi to
  level floor(4 + log2(sqrt(area) / 224 + 1e-6)), clamped to P2-P5;
- the box head (FPN2MLPFeatureExtractor, FPNPredictor): 7x7 pools, fc6
  and fc7 of MLP_HEAD_DIM with ReLUs, ``cls_score`` over the classes
  with background and ``bbox_pred``, 4 deltas a class;
- the box post-processing (box_head/inference.py): softmax, decode with
  weights (10, 10, 5, 5), clip, candidates above SCORE_THRESH, greedy
  NMS at ROI_HEADS.NMS within each class, DETECTIONS_PER_IMG kept;
- the mask head (MaskRCNNFPNFeatureExtractor, MaskRCNNC4Predictor): 14x14
  pools, 4 x (3x3 conv + ReLU), a 2x2 stride-2 transposed conv + ReLU, a
  1x1 conv, 28x28 logits; each detection's mask the sigmoid of its
  class's channel.

Plain PyTorch in float32 (``dtype`` of the post-processing: the
correctness control computes it in bfloat16). Module and parameter
names follow the measured program's, so one state dict made by the
benchmark loads into both sides; nothing here imports the program.
Each stage runs alone on what it is given (``select_proposals`` on RPN
outputs, the heads at given rois), so the check can hold each stage of
the program to it on the program's own inputs.

Departures from the published description:

1. fc6 reads each pooled roi flattened in (7, 7, C) order, the
   published in (C, 7, 7): the measured program's layout of fc6's
   weight, so that one state dict serves both.
2. The mask predictor has one channel per foreground class (80); the
   published 81 hold a background channel 0 that inference never reads.
3. The anchors' base window is [1, 1, s, s] - 0.5, as in the PAA code
   base the program ports (kkhoot/PAA); maskrcnn-benchmark's is
   [1, 1, s, s] - 1, half a pixel to the upper left.
4. Proposals are ranked by objectness logit, the published by its
   sigmoid: the same order, save where the sigmoid rounds two logits to
   one float32 probability. Ties go to the lower index, here and in
   every NMS.
5. The box post-processing runs one class-aware greedy NMS over every
   class's candidates and keeps its first DETECTIONS_PER_IMG picks, in
   descending score; the published runs NMS class by class and keeps
   the best DETECTIONS_PER_IMG by score, listed class by class. The
   sets agree, save ties at the last kept score.
6. Masks stay 28x28 in the box's frame (the published pastes them
   into the image).

``quant`` (default: none) is applied to the input and the weight of
every convolution and fully connected layer; the correctness control
puts ``model.fp8_round`` there.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .boxes import clip
from .model import Conv, ResNet, fp8_round
from .postprocess import greedy_nms

LEVEL_EPS = 1e-6
CANONICAL_SCALE, CANONICAL_LEVEL = 224, 4
# the largest float32 corner tensor (R, Sy, Sx, C) of one block of rois
ALIGN_BLOCK_BYTES = 1 << 28


def _identity(t):
    return t


class Linear(nn.Module):
    """A fully connected layer in float32 (weight (out, in), bias)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.quant = _identity

    def forward(self, x):
        return F.linear(self.quant(x.float()), self.quant(self.weight),
                        self.bias)


class ConvTranspose(nn.Module):
    """A 2x2 stride-2 transposed conv in float32 (weight (in, out, 2, 2),
    bias)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.empty(cout))
        self.quant = _identity

    def forward(self, x):
        return F.conv_transpose2d(self.quant(x.float()),
                                  self.quant(self.weight), self.bias,
                                  stride=2)


class FPN(nn.Module):
    """C2..C5 -> P2..P6 (P6 the 1x1 stride-2 max pool of P5)."""

    def __init__(self, in_channels, out):
        super().__init__()
        self.levels = len(in_channels)
        for k, cin in enumerate(in_channels, 1):
            self.add_module(f"fpn_inner{k}", Conv(cin, out, 1, bias=True))
            self.add_module(f"fpn_layer{k}", Conv(out, out, 3, padding=1,
                                                  bias=True))

    def forward(self, feats):
        top = getattr(self, f"fpn_inner{self.levels}")(feats[-1])
        outs = [getattr(self, f"fpn_layer{self.levels}")(top)]
        for k in range(self.levels - 1, 0, -1):
            lateral = getattr(self, f"fpn_inner{k}")(feats[k - 1])
            top = lateral + F.interpolate(top, scale_factor=2,
                                          mode="nearest")
            outs.insert(0, getattr(self, f"fpn_layer{k}")(top))
        return [*outs, F.max_pool2d(outs[-1], 1, 2)]


class Backbone(nn.Module):
    def __init__(self, body, out_channels):
        super().__init__()
        self.resnet = ResNet(body)
        self.fpn = FPN([body["res2_out"] * 2 ** i for i in range(4)],
                       out_channels)

    def forward(self, x):
        return self.fpn(self.resnet(x))


class RPNHead(nn.Module):
    """Per level: objectness (B, H*W*A) and deltas (B, H*W*A, 4), then
    the levels concatenated."""

    def __init__(self, ch, num_anchors):
        super().__init__()
        self.conv = Conv(ch, ch, 3, padding=1, bias=True)
        self.cls_logits = Conv(ch, num_anchors, 1, bias=True)
        self.bbox_pred = Conv(ch, 4 * num_anchors, 1, bias=True)

    def forward(self, feats):
        obj, reg = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            obj.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1))
            reg.append(self.bbox_pred(t).permute(0, 2, 3, 1).reshape(
                b, -1, 4))
        return {"objectness": torch.cat(obj, 1),
                "box_regression": torch.cat(reg, 1)}


def _bilinear_axis(pos, size):
    """Per sample coordinate: the lower and upper pixel, the weight of
    the upper one and whether the sample lies inside [-1, size]."""
    inside = (pos >= -1.0) & (pos <= size)
    pos = pos.clamp(min=0.0)
    lo = torch.floor(pos)
    edge = lo >= size - 1
    lo = torch.where(edge, float(size - 1), lo)
    hi = torch.where(edge, lo, lo + 1)
    frac = torch.where(edge, lo, pos) - lo
    return lo.long(), hi.long(), frac, inside


def roi_align(feature, rois, batch_idx, size, scale, sampling_ratio):
    """Legacy ROIAlign of ``rois`` (R > 0, 4) on ``feature`` (B, C, H,
    W), roi r on image ``batch_idx[r]``: (R, size, size, C) float32, in
    blocks of rois."""
    _, c, h, w = feature.shape
    s = size * sampling_ratio
    block = max(1, ALIGN_BLOCK_BYTES // (s * s * c * 4))
    feature = feature.float()
    grid = torch.arange(s, device=rois.device)
    bins = (grid // sampling_ratio).float()
    sub = (grid % sampling_ratio).float() + 0.5
    outs = []
    for i in range(0, rois.shape[0], block):
        r = rois[i:i + block].float() * scale
        b = batch_idx[i:i + block].long()
        start = r[:, :2]
        extent = torch.clamp(r[:, 2:] - start, min=1.0)
        bin_size = extent / size
        # the legacy kernel's order of operations, so its rounding
        pos = (start[:, None, :] + bins[None, :, None] * bin_size[:, None]
               + sub[None, :, None] * bin_size[:, None] / sampling_ratio)
        x0, x1, lx, in_x = _bilinear_axis(pos[..., 0], w)
        y0, y1, ly, in_y = _bilinear_axis(pos[..., 1], h)
        bb = b[:, None, None]

        def at(yy, xx):  # (r, Sy, Sx, C)
            return feature[bb, :, yy[:, :, None], xx[:, None, :]]

        hy, hx = 1 - ly, 1 - lx
        val = (at(y0, x0) * (hy[:, :, None] * hx[:, None, :])[..., None]
               + at(y0, x1) * (hy[:, :, None] * lx[:, None, :])[..., None]
               + at(y1, x0) * (ly[:, :, None] * hx[:, None, :])[..., None]
               + at(y1, x1) * (ly[:, :, None] * lx[:, None, :])[..., None])
        val = val * (in_y[:, :, None] & in_x[:, None, :])[..., None]
        outs.append(val.reshape(-1, size, sampling_ratio, size,
                                sampling_ratio, c).mean(dim=(2, 4)))
    return torch.cat(outs)


def roi_levels(rois, k_min, k_max):
    """The FPN pooler's level of each roi, counted from ``k_min``."""
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    lvl = torch.floor(CANONICAL_LEVEL + torch.log2(
        torch.sqrt(w * h) / CANONICAL_SCALE + LEVEL_EPS))
    return lvl.clamp(k_min, k_max).long() - k_min


def multilevel_roi_align(features, rois, batch_idx, size, scales,
                         sampling_ratio):
    """Each roi pooled from its own level of ``features`` (one map per
    scale): (R, size, size, C) float32."""
    rois = rois.float()
    k_min = round(-math.log2(scales[0]))
    levels = roi_levels(rois, k_min, k_min + len(scales) - 1)
    out = rois.new_zeros((rois.shape[0], size, size,
                          features[0].shape[1]))
    for lvl, (f, scale) in enumerate(zip(features, scales)):
        idx = torch.nonzero(levels == lvl)[:, 0]
        if idx.numel():
            out[idx] = roi_align(f, rois[idx], batch_idx[idx], size, scale,
                                 sampling_ratio)
    return out


class BoxHead(nn.Module):
    """Pooler, fc6 + ReLU, fc7 + ReLU, cls_score and bbox_pred."""

    def __init__(self, ch, bh):
        super().__init__()
        self.res, self.scales = bh["resolution"], bh["scales"]
        self.sampling_ratio = bh["sampling_ratio"]
        self.num_classes = bh["num_classes"]
        mlp = bh["mlp_dim"]
        self.fc6 = Linear(ch * self.res * self.res, mlp)
        self.fc7 = Linear(mlp, mlp)
        self.cls_score = Linear(mlp, self.num_classes)
        self.bbox_pred = Linear(mlp, 4 * self.num_classes)

    def predict(self, pooled):
        """(R, res, res, C) pools -> cls logits (R, classes), deltas (R,
        classes, 4)."""
        r = pooled.shape[0]
        x = F.relu(self.fc6(pooled.reshape(r, -1)))
        x = F.relu(self.fc7(x))
        return (self.cls_score(x),
                self.bbox_pred(x).reshape(r, self.num_classes, 4))

    def forward(self, features, rois, batch_idx):
        return self.predict(multilevel_roi_align(
            features[:len(self.scales)], rois, batch_idx, self.res,
            self.scales, self.sampling_ratio))


class MaskHead(nn.Module):
    """Pooler, mask_fcn1..n (3x3 + ReLU), conv5_mask (2x2 transposed, +
    ReLU), mask_fcn_logits (1x1): (R, classes - 1, 2 res, 2 res)."""

    def __init__(self, ch, mh, num_classes):
        super().__init__()
        self.res, self.scales = mh["resolution"], mh["scales"]
        self.sampling_ratio = mh["sampling_ratio"]
        self.layers = len(mh["conv_layers"])
        cin = ch
        for i, cout in enumerate(mh["conv_layers"], 1):
            self.add_module(f"mask_fcn{i}", Conv(cin, cout, 3, padding=1,
                                                 bias=True))
            cin = cout
        self.conv5_mask = ConvTranspose(cin, cin)
        self.mask_fcn_logits = Conv(cin, num_classes - 1, 1, bias=True)

    def predict(self, pooled):
        x = pooled.permute(0, 3, 1, 2)
        for i in range(1, self.layers + 1):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))

    def forward(self, features, rois, batch_idx):
        return self.predict(multilevel_roi_align(
            features[:len(self.scales)], rois, batch_idx, self.res,
            self.scales, self.sampling_ratio))


class MaskRCNN(nn.Module):
    """backbone, rpn_head, box_head, mask_head: named as the program's
    two-stage module."""

    def __init__(self, ref):
        super().__init__()
        ch = ref["fpn"]["out_channels"]
        self.backbone = Backbone(ref["body"], ch)
        self.rpn_head = RPNHead(ch, len(ref["rpn"]["aspect_ratios"]))
        self.box_head = BoxHead(ch, ref["box_head"])
        self.mask_head = MaskHead(ch, ref["mask_head"],
                                  ref["box_head"]["num_classes"])


def build(ref, precision="float32"):
    """The reference of a configuration's ``reference`` section, its
    parameters uninitialised (the benchmark loads them); ``precision``
    "fp8" rounds every conv's and fc layer's input and weight to fp8."""
    model = MaskRCNN(ref)
    quant = {"float32": _identity, "fp8": fp8_round}[precision]
    for m in model.modules():
        if isinstance(m, (Conv, Linear, ConvTranspose)):
            m.quant = quant
    return model


def anchors(rpn, hw):
    """The anchors of a padded (H, W) input, (N, 4) float32 in (level, y,
    x, ratio) order, and the per-level counts."""
    out, counts = [], []
    for stride, size in zip(rpn["anchor_strides"], rpn["anchor_sizes"]):
        base = np.array([1, 1, stride, stride], np.float64) - 0.5
        w = base[2] - base[0] + 1
        ctr = base[0] + 0.5 * (w - 1)
        cells = []
        for ratio in rpn["aspect_ratios"]:
            ws = np.round(np.sqrt(w * w / ratio))
            hs = np.round(ws * ratio)
            # then scaled by size / stride about the same centre
            ws, hs = ws * size / stride, hs * size / stride
            cells.append([ctr - 0.5 * (ws - 1), ctr - 0.5 * (hs - 1),
                          ctr + 0.5 * (ws - 1), ctr + 0.5 * (hs - 1)])
        cells = np.asarray(cells, np.float32)
        fh, fw = math.ceil(hw[0] / stride), math.ceil(hw[1] / stride)
        xs = np.arange(0, fw * stride, stride, dtype=np.float32)
        ys = np.arange(0, fh * stride, stride, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        shift = np.stack([gx.ravel(), gy.ravel(), gx.ravel(), gy.ravel()], 1)
        out.append((shift[:, None] + cells[None]).reshape(-1, 4))
        counts.append(fh * fw * len(cells))
    return torch.from_numpy(np.concatenate(out).astype(np.float32)), counts


def decode(d, boxes, weights):
    """Deltas (..., 4) against reference boxes (..., 4), +1 convention,
    the size deltas clamped at log(1000 / 16)."""
    boxes = boxes.to(d.dtype)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = (boxes[..., 2] + boxes[..., 0]) / 2
    cy = (boxes[..., 3] + boxes[..., 1]) / 2
    wx, wy, ww, wh = weights
    clamp = math.log(1000.0 / 16)
    px = d[..., 0] / wx * w + cx
    py = d[..., 1] / wy * h + cy
    pw = torch.exp(torch.clamp(d[..., 2] / ww, max=clamp)) * w
    ph = torch.exp(torch.clamp(d[..., 3] / wh, max=clamp)) * h
    return torch.stack([px - 0.5 * (pw - 1), py - 0.5 * (ph - 1),
                        px + 0.5 * (pw - 1), py + 0.5 * (ph - 1)], -1)


def _sort_desc(x):
    return torch.sort(x, dim=1, descending=True, stable=True)


def select_proposals(rpn_out, sizes, anchors, counts, rp,
                     dtype=torch.float32):
    """Proposals of a batch from RPN outputs: boxes (B, K, 4), objectness
    (B, K) and valid (B, K), K = min(FPN_POST_NMS_TOP_N, every level's
    picks); an invalid slot scores -inf. Computed in ``dtype``."""
    obj = rpn_out["objectness"].to(dtype)
    reg = rpn_out["box_regression"].to(dtype)
    bsz = obj.shape[0]
    sizes = sizes.to(dtype)
    picked = ([], [], [])
    start = 0
    for count in counts:
        sl = slice(start, start + count)
        start += count
        k = min(rp["pre_nms_top_n"], count)
        score, idx = (t[:, :k] for t in _sort_desc(obj[:, sl]))
        boxes = clip(decode(reg[:, sl].gather(1, idx[..., None].expand(
            bsz, k, 4)), anchors[sl][idx], (1.0, 1.0, 1.0, 1.0)), sizes)
        w = boxes[..., 2] - boxes[..., 0] + 1.0
        h = boxes[..., 3] - boxes[..., 1] + 1.0
        valid = (w >= rp["min_size"]) & (h >= rp["min_size"])
        keep, kscore, kvalid = greedy_nms(
            boxes, score, torch.zeros_like(idx), valid, rp["nms_thresh"],
            min(rp["post_nms_top_n"], k))
        keep = keep.long()
        for out, t in zip(picked, (
                boxes.gather(1, keep[..., None].expand(*keep.shape, 4)),
                kscore, kvalid)):
            out.append(t)
    boxes, scores, valid = (torch.cat(p, 1) for p in picked)
    k = min(rp["fpn_post_nms_top_n"], scores.shape[1])
    top, idx = (t[:, :k] for t in _sort_desc(
        torch.where(valid, scores, -torch.inf)))
    return (boxes.gather(1, idx[..., None].expand(bsz, k, 4)), top,
            torch.isfinite(top))


def box_candidates(cls_logits, deltas, rois, roi_valid, sizes, bh,
                   dtype=torch.float32):
    """The box head's NMS input of a batch, in (roi, class) order, the
    background left out: boxes (B, R*(C-1), 4), scores, labels (int32)
    and valid (above the score threshold, of a valid roi). cls_logits
    (B, R, C), deltas (B, R, C, 4), rois (B, R, 4), roi_valid (B, R)."""
    b, r, c = cls_logits.shape
    probs = torch.softmax(cls_logits.to(dtype), dim=-1)
    boxes = decode(deltas.to(dtype), rois[:, :, None, :].expand(b, r, c, 4),
                   bh["reg_weights"])
    boxes = clip(boxes.reshape(b, -1, 4), sizes.to(dtype)).reshape(
        b, r, c, 4)
    scores = probs[:, :, 1:].reshape(b, -1)
    labels = torch.arange(1, c, dtype=torch.int32,
                          device=scores.device).repeat(b, r)
    valid = (scores > bh["score_thresh"]) & roi_valid.repeat_interleave(
        c - 1, dim=1)
    return boxes[:, :, 1:].reshape(b, -1, 4), scores, labels, valid


def box_postprocess(cls_logits, deltas, rois, roi_valid, sizes, bh,
                    dtype=torch.float32):
    """Detections of a batch (B, DETECTIONS_PER_IMG): boxes (float32; an
    invalid slot's is candidate 0's), scores and labels (0 where
    invalid), valid."""
    boxes, scores, labels, valid = box_candidates(
        cls_logits, deltas, rois, roi_valid, sizes, bh, dtype)
    keep, kscores, kvalid = greedy_nms(boxes, scores, labels, valid,
                                       bh["nms_thresh"],
                                       bh["detections_per_img"])
    keep = keep.long()
    return {"boxes": boxes.gather(1, keep[..., None].expand(
                *keep.shape, 4)).float(),
            "scores": torch.where(kvalid, kscores, 0.0).float(),
            "labels": torch.where(kvalid, labels.gather(1, keep), 0),
            "valid": kvalid}


def mask_probs(logits, labels, dtype=torch.float32):
    """Each roi's sigmoid of its class's channel (channel 0 where the
    label is 0), float32: logits (R, C - 1, M, M), labels (R,)."""
    channel = (labels.long() - 1).clamp(min=0)
    sel = logits[torch.arange(logits.shape[0], device=logits.device),
                 channel]
    return torch.sigmoid(sel.to(dtype)).float()


def detect(model, x, sizes, anchors, counts, ref, dtype=torch.float32):
    """The whole inference of normalized images ``x`` (B, 3, H, W):
    (stages, detections). stages: "rpn" (the RPN's outputs),
    "proposals" (B*K, 4), "box_cls" and "box_deltas" (B*K, ...),
    "det_rois" (B*D, 4) and "mask_logits" (B*D, C - 1, M, M);
    detections: boxes, scores, labels, valid and masks (B, D, M, M).
    The post-processing computes in ``dtype``."""
    feats = model.backbone(x)
    rpn_out = model.rpn_head(feats)
    props, _, p_valid = select_proposals(rpn_out, sizes, anchors, counts,
                                         ref["rpn"], dtype)
    props = props.float()
    bsz, k = props.shape[:2]
    idx = torch.arange(bsz, device=x.device).repeat_interleave(k)
    cls, deltas = model.box_head(feats, props.reshape(-1, 4), idx)
    c = cls.shape[-1]
    det = box_postprocess(cls.reshape(bsz, k, c),
                          deltas.reshape(bsz, k, c, 4), props, p_valid,
                          sizes, ref["box_head"], dtype)
    d = det["boxes"].shape[1]
    det_rois = det["boxes"].reshape(-1, 4)
    logits = model.mask_head(
        feats, det_rois, torch.arange(bsz, device=x.device
                                      ).repeat_interleave(d))
    det["masks"] = mask_probs(logits, det["labels"].reshape(-1),
                              dtype).reshape(bsz, d, *logits.shape[-2:])
    stages = {"rpn": rpn_out, "proposals": props.reshape(-1, 4),
              "box_cls": cls, "box_deltas": deltas, "det_rois": det_rois,
              "mask_logits": logits}
    return stages, det

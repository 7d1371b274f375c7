"""The Faster R-CNN box head (port of
paa_tpu/modeling/roi_box_head.py; reference
paa_core/modeling/roi_heads/box_head/).

- ``FPN2MLPBoxHead``: multilevel ROIAlign 7x7 (POOLER_SCALES 1/4..1/32,
  sampling ratio 2) -> flatten in (7, 7, C) order -> FC + ReLU -> FC +
  ReLU, then the FPNPredictor: ``cls_score`` (C classes with background)
  and class-specific ``bbox_pred`` (C * 4). Float32 throughout, as the
  JAX package's ``nn.Dense`` layers without a dtype compute. With
  ``use_gn`` (ROI_BOX_HEAD.USE_GN, make_layers.py make_fc) fc6 and fc7
  drop their bias and a GroupNorm ``fc6_gn``/``fc7_gn`` over (R, C, 1,
  1) takes the ReLU's place (K3's fused form on the card).
- ``FPNXconvBoxHead`` (FPNXconv1fcFeatureExtractor): the same pooler,
  NUM_STACKED_CONVS 3x3 convs of CONV_HEAD_DIM (``xconv{i}``,
  normal(0.01), DILATION, a bias only without GN) in the compute dtype,
  each followed by GN + ReLU (``xconv{i}_gn``, K3 fused) or a ReLU, then
  float32, the flatten in (7, 7, C) order, fc6 + ReLU (no GN) and the
  FPNPredictor.
- ``roi_box_postprocess`` (one image) and ``roi_box_postprocess_batched``
  (the eval path): softmax, per-class decode with BBOX_REG_WEIGHTS
  (10, 10, 5, 5), clip, the SCORE_THRESH threshold, class-aware NMS at
  ROI_HEADS.NMS capped at DETECTIONS_PER_IMG. With R rois and C classes
  the NMS sees R * (C - 1) candidates per image (80,000 at R=1000,
  C=81), more than K1 holds: ``nms_batched`` takes K2 there, and ``nms``
  always does.

- ``subsample_proposals`` and ``roi_box_loss`` (box_head/loss.py): the
  GTs appended to the proposals, the matcher at ROI_HEADS FG/BG (no
  low-quality matches), BATCH_SIZE_PER_IMAGE rois per image drawn by
  the RPN's ``balanced_sample`` at POSITIVE_FRACTION and compacted
  positives first, softmax cross-entropy over the sampled rois and
  smooth-L1 (beta 1) on the matched class's deltas.

- ``Res5ROIBoxHead`` (the C4 models: ResNet50Conv5ROIFeatureExtractor +
  FastRCNNPredictor): ROIAlign 14x14 at 1/16 on the single C4 map, the
  res5 stage (3 bottlenecks to 2,048 channels, stride 2 in the first,
  FrozenBN) in the compute dtype, the spatial mean in float32, then
  float32 ``cls_score`` and ``bbox_pred``; with ``return_features`` also
  the (R, 2048, 7, 7) res5 features, which the C4 Mask R-CNN's mask
  predictor shares.

"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nms import nms, nms_batched
from ..ops.roi_align import multilevel_roi_align, roi_align
from ..structures.boxes import box_iou, clip_to_image
from .box_coder import decode_box, encode_box
from .layers import Conv, GroupNorm32, Linear, gn_or_relu
from .resnet import Bottleneck
from .retinanet_head import smooth_l1
from .rpn import balanced_sample, top_k_stable

_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class _FPNBoxHead(nn.Module):
    """The FPN box heads' pooler, fc layers and FPNPredictor (made last,
    by ``add_predictor``, so that it is initialised after the fcs)."""

    def __init__(self, num_classes, resolution, scales, sampling_ratio):
        super().__init__()
        self.num_classes = num_classes  # INCLUDING background
        self.resolution = resolution
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio

    def add_predictor(self, mlp_dim):
        self.cls_score = Linear(mlp_dim, self.num_classes, normal_std=0.01)
        self.bbox_pred = Linear(mlp_dim, self.num_classes * 4,
                                normal_std=0.001)

    def pool(self, features, proposals, proposal_batch_idx):
        """(R, 7, 7, C): the flatten order of the JAX package's fc6."""
        return multilevel_roi_align(
            features, proposals, proposal_batch_idx,
            (self.resolution, self.resolution), self.scales,
            self.sampling_ratio)

    def fc(self, name, x):
        """make_fc: the Linear ``name``, then GN + ReLU (``{name}_gn``,
        fused) or a ReLU."""
        return gn_or_relu(getattr(self, f"{name}_gn", None),
                          getattr(self, name)(x))

    def predict(self, x):
        r = x.shape[0]
        return (self.cls_score(x),
                self.bbox_pred(x).reshape(r, self.num_classes, 4))


class FPN2MLPBoxHead(_FPNBoxHead):
    """Pooler + 2 FC (with ``use_gn``: no bias, then GN) + (cls,
    class-specific box deltas)."""

    def __init__(self, num_classes, in_channels=256, mlp_dim=1024,
                 resolution=7, scales=(0.25, 0.125, 0.0625, 0.03125),
                 sampling_ratio=2, use_gn=False):
        super().__init__(num_classes, resolution, scales, sampling_ratio)
        self.fc6 = Linear(in_channels * resolution * resolution, mlp_dim,
                          bias=not use_gn)
        if use_gn:
            self.fc6_gn = GroupNorm32(mlp_dim)
        self.fc7 = Linear(mlp_dim, mlp_dim, bias=not use_gn)
        if use_gn:
            self.fc7_gn = GroupNorm32(mlp_dim)
        self.add_predictor(mlp_dim)

    def forward(self, features, proposals, proposal_batch_idx):
        """features: the first len(scales) FPN maps (P2..P5), NCHW;
        proposals: (R, 4); proposal_batch_idx: (R,). Returns cls_logits
        (R, C) and box_deltas (R, C, 4), float32."""
        x = self.pool(features, proposals, proposal_batch_idx)
        x = self.fc("fc6", x.reshape(x.shape[0], -1))
        return self.predict(self.fc("fc7", x))


class FPNXconvBoxHead(_FPNBoxHead):
    """Pooler + ``num_stacked_convs`` 3x3 convs (normal(0.01), dilation;
    with ``use_gn`` no bias, then GN) + ReLU, then float32, fc6 + ReLU
    and the FPNPredictor (roi_box_feature_extractors.py:86-145)."""

    def __init__(self, num_classes, in_channels=256, mlp_dim=1024,
                 conv_head_dim=256, num_stacked_convs=4, dilation=1,
                 resolution=7, scales=(0.25, 0.125, 0.0625, 0.03125),
                 sampling_ratio=2, use_gn=False, dtype=torch.float32):
        super().__init__(num_classes, resolution, scales, sampling_ratio)
        self.num_stacked_convs = num_stacked_convs
        channels = in_channels
        for i in range(1, num_stacked_convs + 1):
            self.add_module(f"xconv{i}", Conv(
                channels, conv_head_dim, 3, padding=dilation,
                dilation=dilation, bias=not use_gn, dtype=dtype,
                normal_std=0.01))
            if use_gn:
                self.add_module(f"xconv{i}_gn", GroupNorm32(conv_head_dim))
            channels = conv_head_dim
        self.fc6 = Linear(channels * resolution * resolution, mlp_dim)
        self.add_predictor(mlp_dim)

    def forward(self, features, proposals, proposal_batch_idx):
        """As ``FPN2MLPBoxHead.forward``."""
        # NCHW-contiguous, as K3 takes the GN's input
        x = self.pool(features, proposals, proposal_batch_idx)
        x = x.permute(0, 3, 1, 2).contiguous()
        for i in range(1, self.num_stacked_convs + 1):
            x = self.fc(f"xconv{i}", x)
        # the JAX package's f32 cast, then its (7, 7, C) flatten
        x = x.to(torch.float32).permute(0, 2, 3, 1)
        return self.predict(self.fc("fc6", x.reshape(x.shape[0], -1)))


class Res5ROIBoxHead(nn.Module):
    """The C4 box head: pooler, res5, mean pool, cls + class-specific box
    deltas. The bottlenecks are num_groups * width_per_group * 8 wide
    and always end at 2,048 channels, as the JAX package builds them
    (paa_tpu/modeling/roi_box_head.py:364), with the stride in the 1x1."""

    def __init__(self, num_classes, in_channels=1024, resolution=14,
                 scale=1.0 / 16, sampling_ratio=2, num_groups=1,
                 width_per_group=64, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes  # INCLUDING background
        self.resolution = resolution
        self.scale = scale
        self.sampling_ratio = sampling_ratio
        width = num_groups * width_per_group * 8
        for b in range(3):
            self.add_module(f"layer4_{b}", Bottleneck(
                in_channels if b == 0 else 2048, width, 2048,
                stride=2 if b == 0 else 1, num_groups=num_groups,
                dtype=dtype))
        self.cls_score = Linear(2048, num_classes, normal_std=0.01)
        self.bbox_pred = Linear(2048, num_classes * 4, normal_std=0.001)

    def forward(self, features, proposals, proposal_batch_idx,
                return_features=False):
        """features: [C4] (B, C, H, W); proposals (R, 4); their batch
        index (R,). Returns cls_logits (R, C) and box_deltas (R, C, 4),
        float32, and with ``return_features`` the res5 features (R, 2048,
        res / 2, res / 2) in the compute dtype."""
        x = roi_align(features[0], proposals, proposal_batch_idx,
                      (self.resolution, self.resolution), self.scale,
                      self.sampling_ratio).permute(0, 3, 1, 2)
        for b in range(3):
            x = getattr(self, f"layer4_{b}")(x)
        pooled = x.to(torch.float32).mean(dim=(2, 3))
        r = pooled.shape[0]
        out = (self.cls_score(pooled),
               self.bbox_pred(pooled).reshape(r, self.num_classes, 4))
        return out + (x,) if return_features else out


@dataclass(frozen=True)
class ROIBoxConfig:
    num_classes: int = 81
    fg_iou_threshold: float = 0.5
    bg_iou_threshold: float = 0.5
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    detections_per_img: int = 100

    @staticmethod
    def from_cfg(cfg):
        r = cfg.MODEL.ROI_HEADS
        return ROIBoxConfig(
            num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
            fg_iou_threshold=r.FG_IOU_THRESHOLD,
            bg_iou_threshold=r.BG_IOU_THRESHOLD,
            batch_size_per_image=r.BATCH_SIZE_PER_IMAGE,
            positive_fraction=r.POSITIVE_FRACTION,
            score_thresh=r.SCORE_THRESH,
            nms_thresh=r.NMS,
            detections_per_img=r.DETECTIONS_PER_IMG,
        )


def sampling_width(num_proposals, max_gt, bc):
    """The candidates per image ``subsample_proposals`` draws from: the
    proposals and the GT slots, at least batch_size_per_image."""
    return max(num_proposals + max_gt, bc.batch_size_per_image)


def subsample_proposals(proposals, proposal_valid, gt_boxes, gt_labels,
                        bc, draws):
    """Per image: the GTs appended to the proposals, matched, and a
    fixed batch_size_per_image rois drawn (box_head/loss.py
    subsample), compacted positives first, then negatives, then unused
    slots, each in index order.

    proposals (B, K, 4), proposal_valid (B, K), gt_boxes (B, G, 4),
    gt_labels (B, G) with 0 for padding; draws: (u_pos, u_neg), each
    (B, P) with P = ``sampling_width(K, G, bc)``. Returns rois (B, S, 4),
    roi_labels (B, S) int32 (-1 on unused slots), reg_targets (B, S, 4)
    with BBOX_REG_WEIGHTS, roi_valid (B, S), roi_gt_idx (B, S) int64 and
    the matched GT boxes (B, S, 4)."""
    bsz, k = proposal_valid.shape
    gt_boxes = gt_boxes.to(torch.float32)
    gt_valid = gt_labels > 0
    proposals = torch.cat([proposals.to(torch.float32), gt_boxes], dim=1)
    valid = torch.cat([proposal_valid, gt_valid], dim=1)
    deficit = sampling_width(k, gt_boxes.shape[1], bc) - proposals.shape[1]
    if deficit > 0:  # the fixed-size draw needs batch_size_per_image slots
        proposals = F.pad(proposals, (0, 0, 0, deficit))
        valid = F.pad(valid, (0, deficit), value=False)

    iou = box_iou(gt_boxes, proposals)  # (B, G, P)
    iou = torch.where(gt_valid[:, :, None], iou, -1.0)
    matched_vals = iou.amax(dim=1)
    matched_idx = iou.argmax(dim=1)  # the first GT on ties
    labels = torch.where(
        matched_vals >= bc.fg_iou_threshold,
        gt_labels.gather(1, matched_idx).to(torch.int32),
        torch.where(matched_vals >= bc.bg_iou_threshold, -1, 0
                    ).to(torch.int32))
    labels = torch.where(valid, labels, -1)  # padding is ignored

    pos_sel, neg_sel = balanced_sample(
        labels, *draws, bc.batch_size_per_image, bc.positive_fraction)
    sel = pos_sel | neg_sel
    s = bc.batch_size_per_image
    _, idx = top_k_stable(sel.to(torch.float32) + pos_sel.to(torch.float32),
                          s)
    roi_valid = sel.gather(1, idx)
    rois = proposals.gather(1, idx[..., None].expand(bsz, s, 4))
    roi_labels = torch.where(roi_valid, labels.gather(1, idx), -1)
    roi_gt_idx = matched_idx.gather(1, idx)
    matched_boxes = gt_boxes.gather(
        1, roi_gt_idx[..., None].expand(bsz, s, 4))
    reg_targets = encode_box(matched_boxes, rois, weights=_REG_WEIGHTS)
    return (rois, roi_labels, reg_targets, roi_valid, roi_gt_idx,
            matched_boxes)


def roi_box_loss(cls_logits, box_deltas, roi_labels, reg_targets,
                 roi_valid):
    """FastRCNNLossComputation (box_head/loss.py): softmax cross-entropy
    averaged over the sampled rois; smooth-L1 (beta 1) on the matched
    class's deltas of the positives, summed and divided by the sampled
    count. cls_logits (R, C), box_deltas (R, C, 4), roi_labels (R,),
    reg_targets (R, 4), roi_valid (R,)."""
    validf = (roi_valid & (roi_labels >= 0)).to(torch.float32)
    n = validf.sum().clamp(min=1.0)
    labels = roi_labels.clamp(min=0).long()
    logp = torch.log_softmax(cls_logits.to(torch.float32), dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    loss_cls = (ce * validf).sum() / n
    posf = ((roi_labels > 0) & roi_valid).to(torch.float32)
    cls_deltas = box_deltas.to(torch.float32).gather(
        1, labels[:, None, None].expand(-1, 1, 4))[:, 0]
    reg = smooth_l1(cls_deltas, reg_targets, beta=1.0)
    loss_reg = (reg * posf[:, None]).sum() / n
    return {"loss_classifier": loss_cls, "loss_box_reg": loss_reg}


def box_head_candidates(cls_logits, box_deltas, rois, roi_valid,
                        image_sizes, bc):
    """Batched NMS input: cls_logits (B, R, C), box_deltas (B, R, C, 4),
    rois (B, R, 4), roi_valid (B, R), image_sizes (B, 2) -> boxes
    (B, R*(C-1), 4), scores, labels (int32) and valid, background column
    dropped, in (roi, class) order."""
    bsz, r, c = cls_logits.shape
    probs = torch.softmax(cls_logits.to(torch.float32), dim=-1)
    boxes = decode_box(
        box_deltas.to(torch.float32),
        rois[:, :, None, :].expand(bsz, r, c, 4),
        weights=_REG_WEIGHTS,
    )  # (B, R, C, 4)
    boxes = clip_to_image(boxes.reshape(bsz, -1, 4),
                          image_sizes.to(torch.float32)).reshape(bsz, r, c, 4)
    scores = probs[:, :, 1:].reshape(bsz, -1)
    flat_boxes = boxes[:, :, 1:, :].reshape(bsz, -1, 4)
    labels = torch.arange(1, c, dtype=torch.int32, device=scores.device
                          ).repeat(bsz, r)
    valid = (scores > bc.score_thresh) & roi_valid.repeat_interleave(
        c - 1, dim=1)
    return flat_boxes, scores, labels, valid


def _detections(flat_boxes, labels, kidx, kscores, kvalid):
    """Gather the kept candidates. Boxes of invalid slots are those of
    candidate ``kidx`` (0) as in the JAX package; scores and labels of
    invalid slots are 0."""
    k = kidx.long()
    return {
        "boxes": flat_boxes.gather(1, k[..., None].expand(*k.shape, 4)),
        "scores": torch.where(kvalid, kscores, 0.0),
        "labels": torch.where(kvalid, labels.gather(1, k), 0),
        "valid": kvalid,
    }


def roi_box_postprocess(cls_logits, box_deltas, rois, roi_valid,
                        image_size, bc):
    """PostProcessor for one image (box_head/inference.py): cls_logits
    (R, C), box_deltas (R, C, 4), rois (R, 4), roi_valid (R,),
    image_size (2,) -> (detections_per_img, ...) dict. NMS is ``nms``:
    K2 on the card."""
    cand = box_head_candidates(cls_logits[None], box_deltas[None],
                               rois[None], roi_valid[None],
                               image_size[None], bc)
    flat_boxes, scores, labels, valid = (t[0] for t in cand)
    kidx, kscores, kvalid = nms(flat_boxes, scores, labels, valid,
                                bc.nms_thresh, bc.detections_per_img,
                                class_aware=True)
    det = _detections(flat_boxes[None], labels[None], kidx[None],
                      kscores[None], kvalid[None])
    return {k: v[0] for k, v in det.items()}


def roi_box_postprocess_batched(cls_logits, box_deltas, rois, roi_valid,
                                image_sizes, bc):
    """Whole-batch PostProcessor, the same per image as
    ``roi_box_postprocess``, with one ``nms_batched`` call (K2 on the
    card at the head's 80,000 candidates per image).

    cls_logits (B, R, C); box_deltas (B, R, C, 4); rois (B, R, 4);
    roi_valid (B, R); image_sizes (B, 2)."""
    flat_boxes, scores, labels, valid = box_head_candidates(
        cls_logits, box_deltas, rois, roi_valid, image_sizes, bc)
    kidx, kscores, kvalid = nms_batched(
        flat_boxes, scores, labels, valid, bc.nms_thresh,
        bc.detections_per_img, class_aware=True,
    )
    return _detections(flat_boxes, labels, kidx, kscores, kvalid)

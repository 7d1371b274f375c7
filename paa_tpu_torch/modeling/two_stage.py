"""Faster R-CNN, Mask R-CNN, Keypoint R-CNN and the RPN-only model (port
of paa_tpu/modeling/two_stage.py).

Three bodies: ResNet FPN and C4 (FrozenBN, GN or SyncBN;
modeling/resnet.py) and FBNet (modeling/fbnet.py):

- FPN (``R-*-FPN``): the backbone's P2..P6 (P6 by LastLevelMaxPool;
  FPN.USE_GN / USE_RELU as set), the classic RPN over 5 levels (anchor
  sizes 32..512 at strides 4..64, 3 ratios), the box head pooling from
  P2..P5 (ROI_BOX_HEAD.FEATURE_EXTRACTOR FPN2MLPFeatureExtractor, with
  USE_GN its fc GN, or FPNXconv1fcFeatureExtractor, its stacked convs
  with or without GN) and, with MODEL.MASK_ON, the mask head
  (modeling/roi_mask_head.py: GN, dilated, the deconv or the 1x1
  predictor), with MODEL.KEYPOINT_ON the keypoint head
  (modeling/roi_keypoint_head.py);
- C4 (``R-50-C4``, ``R-101-C4``; ``_build_single_level_rcnn``): the
  body's stride-16 C4 map alone, a one-level RPN with all 5 sizes x 3
  ratios at stride 16 (its shared conv 1,024 wide, as the JAX package
  builds it), the res5 box head (``Res5ROIBoxHead``) and, with
  MASK_ON, the C4 mask predictor on the box head's res5 features
  (``share_mask_extractor``), or with SHARE_BOX_FEATURE_EXTRACTOR off
  an unshared ``MaskHead`` pooling the stride-16 map;
- FBNet (``FBNet``, the same single-level path): the arch's trunk
  (modeling/fbnet.py) to one stride-16 map, a one-level RPN with all 5
  sizes x 3 ratios whose head is the arch's "rpn" stages, the "bbox"
  stages on 6 x 6 pools as the box head and, with MASK_ON, the "mask"
  stages as an unshared mask head (M = 12 with the 1x1 predictor).

The RPN-only model (MODEL.RPN_ONLY, ``build_rpn_only``): the same
bodies and RPN without ROI heads; it serves the RPN's proposals
(``select_proposals``: boxes, objectness, ``labels`` = valid) and trains
on ``rpn_loss`` alone; ``inference`` scores its proposals by
box-proposal average recall.

On the card a request launches K1 once (the RPN's NMS, all levels in
one launch) and the box head's NMS over R * (C - 1) candidates per
image once: K2 at 81 classes, K1 where the candidates fit it (Keypoint
R-CNN's 2 classes); Mask R-CNN then runs its mask head on the kept
boxes and returns each one's mask probabilities of its class (28x28;
14x14 on C4), Keypoint R-CNN its keypoint head's (K, 56, 56) heatmap
logits.

Training (``FasterRCNN.forward``, the module's forward): the RPN loss,
proposals from the detached RPN outputs (K1 at PRE_NMS_TOP_N_TRAIN
candidates per level and image, POST_NMS_TOP_N_TRAIN picks; above K1's
capacity, as C4's 12,000 candidates, K2), the sampled rois and the box
loss, the mask loss over the positive rois and the keypoint loss (the
head runs on every sampled roi; the loss keeps the positives'). The C4
Mask R-CNN computes res5 once per step for the box and the mask branch
(the JAX package runs the box head a second time for the mask: the same
function of the same weights, so the same gradient). The RPN's and the
roi sampler's uniforms come from ``draws``: by default a
``torch.Generator`` seeded from TPU.SEED, the step and the rank
(``seeded_draws``), so that a resumed run repeats the stream, as the
JAX package's ``fold_in(PRNGKey(TPU.SEED), step)`` does. Losses are
divided by this process's counts (no cross-rank normalizer, as in the
JAX package); under DDP the gradients are averaged.

Not ported: the C4 and FBNet keypoint variants (the JAX package builds
Keypoint R-CNN on FPN only). Building one raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn
from torch.profiler import record_function

from ..engine.train_step import SPAN_FORWARD, make_train_step
from ..solver import make_lr_schedule
from ..utils import comm
from .anchors import AnchorGenerator
from .detector import DetectionModel, build_backbone
from .fbnet import (
    FBNetMaskHead, FBNetROIBoxHead, FBNetRPNHead, FBNetTrunk,
    fbnet_trunk_stride)
from .resnet import resnet_from_cfg
from .roi_box_head import (
    FPN2MLPBoxHead,
    FPNXconvBoxHead,
    Res5ROIBoxHead,
    ROIBoxConfig,
    roi_box_loss,
    roi_box_postprocess_batched,
    sampling_width,
    subsample_proposals,
)
from .roi_keypoint_head import KeypointHead, keypoint_loss
from .roi_mask_head import (
    MaskHead, MaskRCNNC4Predictor, crop_gt_masks_for_rois, mask_loss)
from .rpn import RPNConfig, RPNHead, rpn_loss, select_proposals

RPN_STRIDES = (4, 8, 16, 32, 64)
FPN_POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)

# the spans of a two-stage train step (beside engine/train_step.py's)
# and, those marked, of inference (``TwoStageModel.detect``); the
# benchmark's serve.proposals_ms, serve.box_head_ms,
# serve.box_postprocess_ms, serve.mask_head_ms and
# serve.two_stage_idle_ms read the inference ones
SPAN_RPN_HEAD = "two_stage/rpn_head"  # inference
SPAN_RPN_LOSS = "two_stage/rpn_loss"
SPAN_PROPOSALS = "two_stage/proposals"  # and inference
SPAN_ROI_SAMPLING = "two_stage/roi_sampling"
SPAN_BOX_HEAD = "two_stage/box_head"  # and inference
SPAN_BOX_POSTPROCESS = "two_stage/box_postprocess"  # inference
SPAN_BOX_LOSS = "two_stage/box_loss"
SPAN_MASK_HEAD = "two_stage/mask_head"  # and inference
SPAN_MASK_TARGETS = "two_stage/mask_targets"
SPAN_MASK_LOSS = "two_stage/mask_loss"
SPAN_KEYPOINT_HEAD = "two_stage/keypoint_head"
SPAN_KEYPOINT_LOSS = "two_stage/keypoint_loss"
# the keypoint head at inference
SPAN_KEYPOINT_EVAL = "keypoint head"


@dataclass
class LossContext:
    """What a two-stage loss needs besides the batch: the anchors of the
    bucket and their per-level counts, the training RPN and box
    configs, ``draws(name, shape) -> (u_pos, u_neg)`` (the sampler's
    uniforms, "rpn" over (B, anchors) then "roi" over (B, candidates))
    and whether to return the sampled masks beside the losses."""

    anchors: torch.Tensor
    level_counts: tuple
    rpn: RPNConfig
    box: ROIBoxConfig
    draws: Callable
    return_aux: bool = False


def seeded_draws(seed, step, device, rank=0):
    """``draws`` from a ``torch.Generator`` on ``device`` seeded from
    (seed, step, rank): each call takes two uniform tensors of
    ``shape`` in [0, 1) from it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed * 1_000_003 + step) * 1_009 + rank) % (1 << 62))

    def draw(name, shape):
        return tuple(torch.rand(shape, generator=gen, device=device)
                     for _ in range(2))

    return draw


class SingleLevelBackbone(nn.Module):
    """A C4 body as a one-level feature list, [C4] (the JAX package's
    _SingleLevelBackbone: its ``body`` scope)."""

    def __init__(self, body):
        super().__init__()
        self.body = body

    def forward(self, x):
        return self.body(x)[-1:]


class FasterRCNN(nn.Module):
    """backbone + RPN head + box head (+ mask head, + keypoint head).
    ``forward`` is the training loss; inference goes through
    ``TwoStageModel.detect``. With ``share_mask_extractor`` (the C4 Mask
    R-CNN) the mask head is the predictor alone, on the box head's res5
    features."""

    def __init__(self, backbone, rpn_head, box_head, mask_head=None,
                 keypoint_head=None, share_mask_extractor=False):
        super().__init__()
        self.backbone = backbone
        self.rpn_head = rpn_head
        self.box_head = box_head
        self.mask_head = mask_head
        self.keypoint_head = keypoint_head
        self.share_mask_extractor = share_mask_extractor

    def backbone_rpn(self, images):
        features = self.backbone(images)
        return features, self.rpn_head(features)

    def box(self, features, rois, roi_batch_idx):
        # the FPN pooler uses the first 4 pyramid levels (P2..P5)
        return self.box_head(list(features)[:4], rois, roi_batch_idx)

    def mask(self, features, rois, roi_batch_idx):
        if self.share_mask_extractor:
            return self.mask_head(self.box_head(
                list(features)[:4], rois, roi_batch_idx,
                return_features=True)[2])
        return self.mask_head(list(features)[:4], rois, roi_batch_idx)

    def keypoint(self, features, rois, roi_batch_idx):
        return self.keypoint_head(list(features)[:4], rois, roi_batch_idx)

    def forward(self, images, batch, ctx: LossContext):
        """The two-stage training losses of normalized NCHW ``images``
        (faster_rcnn_train_step_fns of the JAX package).

        batch: 'gt_boxes' (B, G, 4), 'gt_labels' (B, G), 'image_sizes'
        (B, 2), with a mask head 'gt_masks' (B, G, M, M) (the GTs'
        box-normalized bitmasks) and with a keypoint head 'gt_keypoints'
        (B, G, K, 3). Returns loss_objectness, loss_rpn_box_reg, num_pos
        (the RPN's sampled positives), loss_classifier, loss_box_reg,
        loss_mask and loss_kp; with ``ctx.return_aux`` also the sampled
        anchors ("rpn_pos", "rpn_neg") and rois ("rois", "roi_labels",
        "roi_valid", "roi_gt_idx", with masks "mask_targets")."""
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
        image_sizes = batch["image_sizes"]
        bsz = images.shape[0]
        for key, head in (("gt_masks", self.mask_head),
                          ("gt_keypoints", self.keypoint_head)):
            if head is not None and key not in batch:
                raise KeyError(
                    f"this train step needs the batch's {key!r} (the "
                    f"loader gives it with MODEL.MASK_ON / KEYPOINT_ON)")
        with record_function(SPAN_FORWARD):
            features, rpn_out = self.backbone_rpn(images)
        with record_function(SPAN_RPN_LOSS):
            losses = rpn_loss(
                rpn_out, gt_boxes, gt_labels, ctx.anchors, ctx.rpn,
                ctx.draws("rpn", (bsz, ctx.anchors.shape[0])),
                image_sizes=image_sizes, return_aux=ctx.return_aux)
        with record_function(SPAN_PROPOSALS):
            # proposals carry no gradient: the NMS never sees the graph
            proposals, _, p_valid = select_proposals(
                {k: v.detach() for k, v in rpn_out.items()}, image_sizes,
                ctx.anchors, ctx.level_counts, ctx.rpn)
        with record_function(SPAN_ROI_SAMPLING):
            width = sampling_width(proposals.shape[1], gt_boxes.shape[1],
                                   ctx.box)
            (rois, roi_labels, reg_targets, roi_valid, roi_gt_idx,
             roi_gt_boxes) = subsample_proposals(
                proposals, p_valid, gt_boxes, gt_labels, ctx.box,
                ctx.draws("roi", (bsz, width)))
            s = rois.shape[1]
            flat_rois = rois.reshape(-1, 4)
            batch_idx = torch.arange(bsz, device=rois.device
                                     ).repeat_interleave(s)
            flat_labels = roi_labels.reshape(-1)
            flat_valid = roi_valid.reshape(-1)
            flat_gt_idx = roi_gt_idx.reshape(-1)
        with record_function(SPAN_BOX_HEAD):
            if self.share_mask_extractor:
                cls_logits, box_deltas, res5 = self.box_head(
                    list(features), flat_rois, batch_idx,
                    return_features=True)
            else:
                cls_logits, box_deltas = self.box(features, flat_rois,
                                                  batch_idx)
        with record_function(SPAN_BOX_LOSS):
            losses.update(roi_box_loss(
                cls_logits, box_deltas, flat_labels,
                reg_targets.reshape(-1, 4), flat_valid))
        if ctx.return_aux:
            losses.update(rois=rois, roi_labels=roi_labels,
                          roi_valid=roi_valid, roi_gt_idx=roi_gt_idx)
        if self.mask_head is not None:
            with record_function(SPAN_MASK_HEAD):
                mask_logits = (self.mask_head(res5)
                               if self.share_mask_extractor else
                               self.mask(features, flat_rois, batch_idx))
            with record_function(SPAN_MASK_TARGETS):
                roi_masks = batch["gt_masks"][batch_idx, flat_gt_idx]
                targets = crop_gt_masks_for_rois(
                    roi_masks.to(torch.float32),
                    roi_gt_boxes.reshape(-1, 4), flat_rois,
                    out_size=mask_logits.shape[-1])
            with record_function(SPAN_MASK_LOSS):
                losses.update(mask_loss(mask_logits, flat_labels, targets,
                                        flat_valid))
            if ctx.return_aux:
                losses["mask_targets"] = targets.reshape(
                    bsz, s, *targets.shape[1:])
        if self.keypoint_head is not None:
            with record_function(SPAN_KEYPOINT_HEAD):
                kp_logits = self.keypoint(features, flat_rois, batch_idx)
            with record_function(SPAN_KEYPOINT_LOSS):
                losses.update(keypoint_loss(
                    kp_logits, flat_rois,
                    batch["gt_keypoints"][batch_idx, flat_gt_idx],
                    (flat_labels > 0) & flat_valid))
        return losses


@dataclass
class TwoStageModel(DetectionModel):
    """A built Faster / Mask R-CNN: ``DetectionModel``'s anchors, shapes
    and ``make_eval_fn``, with the two-stage detection body and train
    step."""

    head_type: str = "two_stage"

    @property
    def train_batch_keys(self):
        keys = ("images", "gt_boxes", "gt_labels", "image_sizes")
        if self.cfg.MODEL.MASK_ON:
            keys = keys + ("gt_masks",)
        if self.cfg.MODEL.KEYPOINT_ON:
            keys = keys + ("gt_keypoints",)
        return keys

    def postprocess_config(self):
        return ROIBoxConfig.from_cfg(self.cfg)

    def make_bucket_train_step(self, hw, draws=None, return_aux=False):
        """train_step(state, batch) -> metrics for padded inputs of shape
        ``hw`` (engine/train_step.py): the module's forward is the loss.
        ``draws(step) -> draws(name, shape)`` gives each step's sampler
        uniforms; the default is ``seeded_draws`` from TPU.SEED, the step
        and the rank. ``return_aux`` adds the sampled masks
        (``FasterRCNN.forward``) to the metrics."""
        anchors, counts = self.anchors_for(hw)
        rc = RPNConfig.from_cfg(self.cfg, is_train=True)
        bc = ROIBoxConfig.from_cfg(self.cfg)
        if draws is None:
            seed, rank = self.cfg.TPU.SEED, comm.get_rank()

            def draws(step):
                return seeded_draws(seed, step, self.device, rank)

        def forward_loss(module, images, batch, step):
            return module(images, batch, LossContext(
                anchors, counts, rc, bc, draws(step), return_aux))

        return make_train_step(
            forward_loss, make_lr_schedule(self.cfg), self.device,
            normalize=(self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD))

    def detect(self, images, image_sizes):
        """Detections of normalized NCHW ``images`` (B, 3, H, W):
        {"boxes", "scores", "labels", "valid"}, each (B,
        ROI_HEADS.DETECTIONS_PER_IMG, ...); for Mask R-CNN "masks" (B,
        DETECTIONS_PER_IMG, M, M) float32 (M 28, on C4 14): the sigmoid
        of each kept box's class channel (channel 0 for an invalid
        slot); for Keypoint R-CNN "kp_heatmaps" (B, DETECTIONS_PER_IMG,
        K, 56, 56) float32 logits of each kept box."""
        anchors, counts = self.anchors_for(images.shape[2:])
        features = self.module.backbone(images)
        with record_function(SPAN_RPN_HEAD):
            rpn_out = self.module.rpn_head(features)
        with record_function(SPAN_PROPOSALS):
            proposals, _, p_valid = select_proposals(
                rpn_out, image_sizes, anchors, counts,
                RPNConfig.from_cfg(self.cfg, is_train=False))
            bsz, k = proposals.shape[:2]
            batch_idx = torch.arange(bsz, device=proposals.device
                                     ).repeat_interleave(k)
        with record_function(SPAN_BOX_HEAD):
            cls_logits, box_deltas = self.module.box(
                features, proposals.reshape(-1, 4), batch_idx)
        with record_function(SPAN_BOX_POSTPROCESS):
            c = cls_logits.shape[-1]
            det = roi_box_postprocess_batched(
                cls_logits.reshape(bsz, k, c),
                box_deltas.reshape(bsz, k, c, 4),
                proposals, p_valid, image_sizes, self.postprocess_config(),
            )
            d = det["boxes"].shape[1]
            det_rois = det["boxes"].reshape(-1, 4)
            det_idx = torch.arange(bsz, device=proposals.device
                                   ).repeat_interleave(d)
        if self.module.mask_head is not None:
            with record_function(SPAN_MASK_HEAD):
                logits = self.module.mask(features, det_rois, det_idx)
                channel = (det["labels"].reshape(-1) - 1).clamp(min=0)
                sel = logits[torch.arange(bsz * d, device=channel.device),
                             channel.long()]
                det["masks"] = torch.sigmoid(sel.to(torch.float32)).reshape(
                    bsz, d, *sel.shape[-2:])
        if self.module.keypoint_head is not None:
            with record_function(SPAN_KEYPOINT_EVAL):
                heat = self.module.keypoint(features, det_rois, det_idx)
                det["kp_heatmaps"] = heat.to(torch.float32).reshape(
                    bsz, d, *heat.shape[1:])
        return det


def _box_head(cfg, channels, dtype):
    """The FPN box head of ``cfg``: FPNXconv1fcFeatureExtractor or
    FPN2MLPFeatureExtractor, with their GN (ROI_BOX_HEAD.USE_GN), and
    the FPNPredictor."""
    bh = cfg.MODEL.ROI_BOX_HEAD
    common = dict(num_classes=bh.NUM_CLASSES, in_channels=channels,
                  mlp_dim=bh.MLP_HEAD_DIM, resolution=bh.POOLER_RESOLUTION,
                  sampling_ratio=max(bh.POOLER_SAMPLING_RATIO, 1),
                  use_gn=bh.USE_GN)
    if bh.FEATURE_EXTRACTOR == "FPNXconv1fcFeatureExtractor":
        return FPNXconvBoxHead(
            conv_head_dim=bh.CONV_HEAD_DIM,
            num_stacked_convs=bh.NUM_STACKED_CONVS, dilation=bh.DILATION,
            dtype=dtype, **common)
    return FPN2MLPBoxHead(**common)


def _mask_head(cfg, channels, dtype):
    """The FPN mask head of ``cfg`` (MaskRCNNFPNFeatureExtractor with its
    GN and dilation, and MaskRCNNC4Predictor or with PREDICTOR
    MaskRCNNConv1x1Predictor the 1x1 predictor)."""
    mh = cfg.MODEL.ROI_MASK_HEAD
    scales = tuple(mh.POOLER_SCALES)
    if len(scales) != 4:  # a C4-style default: the FPN levels
        scales = FPN_POOLER_SCALES
    return MaskHead(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1,
        in_channels=channels, conv_layers=tuple(mh.CONV_LAYERS),
        resolution=mh.POOLER_RESOLUTION, scales=scales,
        sampling_ratio=max(mh.POOLER_SAMPLING_RATIO, 1), dtype=dtype,
        use_gn=mh.USE_GN, dilation=mh.DILATION,
        use_deconv=mh.PREDICTOR != "MaskRCNNConv1x1Predictor")


def _keypoint_head(cfg, channels, dtype):
    """The FPN keypoint head of ``cfg`` (KeypointRCNNFeatureExtractor +
    KeypointRCNNPredictor)."""
    kh = cfg.MODEL.ROI_KEYPOINT_HEAD
    scales = tuple(kh.POOLER_SCALES)
    if len(scales) != 4:  # a C4-style default: the FPN levels
        scales = FPN_POOLER_SCALES
    return KeypointHead(
        num_keypoints=kh.NUM_CLASSES, in_channels=channels,
        conv_layers=tuple(kh.CONV_LAYERS), resolution=kh.POOLER_RESOLUTION,
        scales=scales, sampling_ratio=max(kh.POOLER_SAMPLING_RATIO, 1),
        dtype=dtype)


def build_faster_rcnn(cfg, device, dtype=torch.float32):
    """The two-stage model of ``cfg`` on ``device``: Faster R-CNN on an
    R-*-FPN body with the box head of ROI_BOX_HEAD (``_box_head``), the
    mask head when MODEL.MASK_ON, the keypoint head when
    MODEL.KEYPOINT_ON, or on an R-*-C4 body the res5 head model
    (``_build_single_level_rcnn``); parameters not yet initialised
    (``build_detection_model`` seeds them)."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body.endswith("-C4") or body == "FBNet":
        return _build_single_level_rcnn(cfg, device, dtype)
    if not body.endswith("-FPN"):
        raise NotImplementedError(
            f"paa_tpu_torch ports the two-stage models on an R-*-FPN, "
            f"R-*-C4 or FBNet body, not {body}")
    channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    module = FasterRCNN(
        build_backbone(cfg, dtype=dtype),
        RPNHead(num_anchors=len(cfg.MODEL.RPN.ASPECT_RATIOS),
                in_channels=channels, dtype=dtype),
        _box_head(cfg, channels, dtype),
        _mask_head(cfg, channels, dtype) if cfg.MODEL.MASK_ON else None,
        (_keypoint_head(cfg, channels, dtype) if cfg.MODEL.KEYPOINT_ON
         else None),
    )
    return TwoStageModel(
        cfg=cfg,
        module=module,
        anchor_generator=AnchorGenerator(
            cfg.MODEL.RPN.ANCHOR_SIZES, cfg.MODEL.RPN.ASPECT_RATIOS,
            RPN_STRIDES),
        strides=RPN_STRIDES,
        device=device,
    )


def _build_single_level_rcnn(cfg, device, dtype):
    """The C4 or FBNet Faster / Mask R-CNN of ``cfg`` (the JAX package's
    _build_single_level_rcnn): one RPN level at RPN.ANCHOR_STRIDE[0]
    with every ANCHOR_SIZES x ASPECT_RATIOS anchor (reference
    make_anchor_generator for a non-FPN RPN) on the body's one map, and
    ``_c4_heads`` or ``_fbnet_heads``."""
    if cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError(
            "paa_tpu_torch ports the C4 and FBNet Faster and Mask R-CNN; "
            "the JAX package builds Keypoint R-CNN on FPN only")
    stride = cfg.MODEL.RPN.ANCHOR_STRIDE[0]
    heads = (_fbnet_heads if cfg.MODEL.BACKBONE.CONV_BODY == "FBNet"
             else _c4_heads)
    return TwoStageModel(
        cfg=cfg,
        module=FasterRCNN(*heads(cfg, stride, dtype)),
        anchor_generator=_c4_anchor_generator(cfg),
        strides=(stride,),
        device=device,
    )


def _c4_heads(cfg, stride, dtype):
    """FasterRCNN's modules on an R-*-C4 body: the body to C4, the RPN
    head (``_c4_rpn_head``), the res5 box head pooling at 1 / stride
    (POOLER_RESOLUTION, at least 14) and, with MASK_ON, the C4 mask
    predictor on the box head's res5 features
    (SHARE_BOX_FEATURE_EXTRACTOR) or else an unshared ``MaskHead`` at
    its defaults (4 x 256 convs on 14 x 14 pools of the stride-16 map,
    the deconv predictor), as the JAX package builds it whatever
    ROI_MASK_HEAD's other settings."""
    r, bh = cfg.MODEL.RESNETS, cfg.MODEL.ROI_BOX_HEAD
    c4 = r.RES2_OUT_CHANNELS * 4
    mask_head = None
    share = cfg.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR
    if cfg.MODEL.MASK_ON and share:
        mask_head = MaskRCNNC4Predictor(
            bh.NUM_CLASSES - 1, in_channels=2048,
            dim_reduced=cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS[-1], dtype=dtype)
    elif cfg.MODEL.MASK_ON:
        mask_head = MaskHead(bh.NUM_CLASSES - 1, in_channels=c4,
                             scales=(1.0 / stride,), dtype=dtype)
    return (
        SingleLevelBackbone(resnet_from_cfg(cfg, dtype=dtype)),
        _c4_rpn_head(cfg, c4, dtype),
        Res5ROIBoxHead(
            bh.NUM_CLASSES, in_channels=c4,
            resolution=max(bh.POOLER_RESOLUTION, 14), scale=1.0 / stride,
            num_groups=r.NUM_GROUPS, width_per_group=r.WIDTH_PER_GROUP,
            dtype=dtype),
        mask_head, None, cfg.MODEL.MASK_ON and share,
    )


def _fbnet_heads(cfg, stride, dtype):
    """FasterRCNN's modules on an FBNet body (MODEL.FBNET: ARCH,
    SCALE_FACTOR, WIDTH_DIVISOR, BN_TYPE): the trunk, whose stride must
    be RPN.ANCHOR_STRIDE[0]; the RPN head on the "rpn" stages; the box
    head on ROI_BOX_HEAD.POOLER_RESOLUTION pools; with MASK_ON the
    unshared mask head on ROI_MASK_HEAD.POOLER_RESOLUTION pools, its
    deconv unless PREDICTOR is MaskRCNNConv1x1Predictor. Both heads pool
    with sampling ratio 2, as the JAX package's."""
    f = cfg.MODEL.FBNET
    if fbnet_trunk_stride(f.ARCH) != stride:
        raise ValueError(f"FBNet trunk stride {fbnet_trunk_stride(f.ARCH)}"
                         f" != RPN.ANCHOR_STRIDE {stride}")
    widths = dict(width_ratio=f.SCALE_FACTOR, width_divisor=f.WIDTH_DIVISOR,
                  bn_type=f.BN_TYPE, dtype=dtype)
    trunk = FBNetTrunk(f.ARCH, **widths)
    c = trunk.out_channels
    rpn = cfg.MODEL.RPN
    mask_head = None
    if cfg.MODEL.MASK_ON:
        mh = cfg.MODEL.ROI_MASK_HEAD
        mask_head = FBNetMaskHead(
            f.ARCH, c, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1,
            resolution=mh.POOLER_RESOLUTION, scale=1.0 / stride,
            use_deconv=mh.PREDICTOR != "MaskRCNNConv1x1Predictor", **widths)
    return (
        SingleLevelBackbone(trunk),
        FBNetRPNHead(f.ARCH, c, len(rpn.ANCHOR_SIZES)
                     * len(rpn.ASPECT_RATIOS), **widths),
        FBNetROIBoxHead(f.ARCH, c, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES,
                        resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
                        scale=1.0 / stride, **widths),
        mask_head,
    )


def _c4_rpn_head(cfg, in_channels, dtype):
    """The one-level RPN head of a C4 body: every ANCHOR_SIZES x
    ASPECT_RATIOS anchor per location, its shared conv 1,024 wide."""
    num_anchors = len(cfg.MODEL.RPN.ANCHOR_SIZES) * len(
        cfg.MODEL.RPN.ASPECT_RATIOS)
    return RPNHead(num_anchors=num_anchors, in_channels=in_channels,
                   dtype=dtype, out_channels=1024)


def _c4_anchor_generator(cfg):
    """All ANCHOR_SIZES x ASPECT_RATIOS on one level at
    RPN.ANCHOR_STRIDE[0]."""
    return AnchorGenerator((tuple(cfg.MODEL.RPN.ANCHOR_SIZES),),
                           cfg.MODEL.RPN.ASPECT_RATIOS,
                           (cfg.MODEL.RPN.ANCHOR_STRIDE[0],))


class RPNOnly(nn.Module):
    """backbone + RPN head: (B, 3, H, W) -> the RPN's outputs."""

    def __init__(self, backbone, rpn_head):
        super().__init__()
        self.backbone = backbone
        self.rpn_head = rpn_head

    def forward(self, images):
        return self.rpn_head(self.backbone(images))


@dataclass
class RPNOnlyModel(DetectionModel):
    """The RPN-only proposal model (the reference's rpn_*.yaml configs:
    GeneralizedRCNN with RPN_ONLY and no ROI heads). Its detections are
    the proposals: FPN_POST_NMS_TOP_N_TEST (at most) per image in pick
    order; ``inference`` scores them by box-proposal average recall
    (evaluation/coco_eval.py ``evaluate_box_proposals``), not COCO AP."""

    head_type: str = "rpn"

    def postprocess_config(self):
        return RPNConfig.from_cfg(self.cfg, is_train=False)

    def make_bucket_train_step(self, hw, draws=None, return_aux=False):
        """train_step(state, batch) -> metrics for padded inputs of shape
        ``hw``: ``rpn_loss`` of the module's outputs, its sampler's
        uniforms from ``draws(step)("rpn", shape)`` (default
        ``seeded_draws``, as ``TwoStageModel``); ``return_aux`` adds the
        sampled anchors "rpn_pos" and "rpn_neg"."""
        anchors, _ = self.anchors_for(hw)
        rc = RPNConfig.from_cfg(self.cfg, is_train=True)
        if draws is None:
            seed, rank = self.cfg.TPU.SEED, comm.get_rank()

            def draws(step):
                return seeded_draws(seed, step, self.device, rank)

        def forward_loss(module, images, batch, step):
            with record_function(SPAN_FORWARD):
                outputs = module(images)
            with record_function(SPAN_RPN_LOSS):
                return rpn_loss(
                    outputs, batch["gt_boxes"], batch["gt_labels"], anchors,
                    rc, draws(step)("rpn", (images.shape[0],
                                            anchors.shape[0])),
                    image_sizes=batch["image_sizes"], return_aux=return_aux)

        return make_train_step(
            forward_loss, make_lr_schedule(self.cfg), self.device,
            normalize=(self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD))

    def detect(self, images, image_sizes):
        """The proposals of normalized NCHW ``images``: {"boxes" (B, K,
        4), "scores" (B, K) objectness logits, "labels" (B, K) int32, 1
        where valid, "valid" (B, K)}, invalid slots zero, K =
        min(FPN_POST_NMS_TOP_N_TEST, the levels' kept slots)."""
        anchors, counts = self.anchors_for(images.shape[2:])
        boxes, scores, valid = select_proposals(
            self.module(images), image_sizes, anchors, counts,
            self.postprocess_config())
        return {"boxes": torch.where(valid[..., None], boxes, 0.0),
                "scores": torch.where(valid, scores, 0.0),
                "labels": valid.to(torch.int32), "valid": valid}


def build_rpn_only(cfg, device, dtype=torch.float32):
    """The RPN-only model of ``cfg`` (the JAX package's build_rpn_only):
    on an R-*-FPN body the backbone of ``build_backbone`` (P2..P6, P6
    pooled) and the RPN over its 5 levels; on an R-*-C4 body the C4 map
    alone, one RPN level at ANCHOR_STRIDE[0] with every size x ratio
    anchor and the shared conv 1,024 wide (as ``_build_single_level_rcnn``
    builds it)."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body.endswith("-FPN"):
        channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
        backbone = build_backbone(cfg, dtype=dtype)
        rpn_head = RPNHead(num_anchors=len(cfg.MODEL.RPN.ASPECT_RATIOS),
                           in_channels=channels, dtype=dtype)
        anchors = AnchorGenerator(cfg.MODEL.RPN.ANCHOR_SIZES,
                                  cfg.MODEL.RPN.ASPECT_RATIOS, RPN_STRIDES)
        strides = RPN_STRIDES
    elif body.endswith("-C4"):
        backbone = SingleLevelBackbone(resnet_from_cfg(cfg, dtype=dtype))
        rpn_head = _c4_rpn_head(cfg, cfg.MODEL.RESNETS.RES2_OUT_CHANNELS * 4,
                                dtype)
        anchors = _c4_anchor_generator(cfg)
        strides = (cfg.MODEL.RPN.ANCHOR_STRIDE[0],)
    else:
        raise NotImplementedError(
            f"paa_tpu_torch ports the RPN-only model on an R-*-FPN or "
            f"R-*-C4 body, not {body}")
    return RPNOnlyModel(cfg=cfg, module=RPNOnly(backbone, rpn_head),
                        anchor_generator=anchors, strides=strides,
                        device=device)

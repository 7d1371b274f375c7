"""Faster R-CNN and Mask R-CNN on an FPN body (port of
paa_tpu/modeling/two_stage.py, the FPN2MLP box head and the FPN mask
head).

R-50/101-FPN backbone (P2..P6, P6 by LastLevelMaxPool), the classic RPN
over 5 levels (anchor sizes 32..512 at strides 4..64, 3 ratios),
static-shape proposal selection, the FPN2MLP box head pooling from
P2..P5 and, with MODEL.MASK_ON, the mask head (modeling/roi_mask_head.py).
On the card a request launches K1 once (the RPN's NMS, all levels in
one launch) and K2 once (the box head's NMS over R * (C - 1) candidates
per image); Mask R-CNN then runs its mask head on the kept boxes and
returns each one's 28x28 mask probabilities of its class.

Training (``FasterRCNN.forward``, the module's forward): the RPN loss,
proposals from the detached RPN outputs (K1 at PRE_NMS_TOP_N_TRAIN
candidates per level and image, POST_NMS_TOP_N_TRAIN picks), the
sampled rois and the box loss, and the mask loss over the positive
rois. The RPN's and the roi sampler's uniforms come from ``draws``: by
default a ``torch.Generator`` seeded from TPU.SEED, the step and the
rank (``seeded_draws``), so that a resumed run repeats the stream, as
the JAX package's ``fold_in(PRNGKey(TPU.SEED), step)`` does. Losses are
divided by this process's counts (no cross-rank normalizer, as in the
JAX package); under DDP the gradients are averaged.

Not ported yet (ROADMAP item 10, in this order): Keypoint R-CNN, the C4
bodies and their mask predictor, the Xconv and GN heads and FPN GN, and
the RPN-only model; building any of them raises.
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
from .roi_box_head import (
    FPN2MLPBoxHead,
    ROIBoxConfig,
    roi_box_loss,
    roi_box_postprocess_batched,
    sampling_width,
    subsample_proposals,
)
from .roi_mask_head import MaskHead, crop_gt_masks_for_rois, mask_loss
from .rpn import RPNConfig, RPNHead, rpn_loss, select_proposals

RPN_STRIDES = (4, 8, 16, 32, 64)
FPN_POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)

# the spans of a two-stage train step (beside engine/train_step.py's)
SPAN_RPN_LOSS = "two_stage/rpn_loss"
SPAN_PROPOSALS = "two_stage/proposals"
SPAN_ROI_SAMPLING = "two_stage/roi_sampling"
SPAN_BOX_HEAD = "two_stage/box_head"
SPAN_BOX_LOSS = "two_stage/box_loss"
SPAN_MASK_HEAD = "two_stage/mask_head"
SPAN_MASK_TARGETS = "two_stage/mask_targets"
SPAN_MASK_LOSS = "two_stage/mask_loss"
# the mask head at inference
SPAN_MASK_EVAL = "mask head"


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


class FasterRCNN(nn.Module):
    """backbone + RPN head + box head (+ mask head). ``forward`` is the
    training loss; inference goes through ``TwoStageModel.detect``."""

    def __init__(self, backbone, rpn_head, box_head, mask_head=None):
        super().__init__()
        self.backbone = backbone
        self.rpn_head = rpn_head
        self.box_head = box_head
        self.mask_head = mask_head

    def backbone_rpn(self, images):
        features = self.backbone(images)
        return features, self.rpn_head(features)

    def box(self, features, rois, roi_batch_idx):
        # the pooler uses the first 4 pyramid levels (P2..P5)
        return self.box_head(list(features)[:4], rois, roi_batch_idx)

    def mask(self, features, rois, roi_batch_idx):
        return self.mask_head(list(features)[:4], rois, roi_batch_idx)

    def forward(self, images, batch, ctx: LossContext):
        """The Faster / Mask R-CNN training losses of normalized NCHW
        ``images`` (faster_rcnn_train_step_fns of the JAX package).

        batch: 'gt_boxes' (B, G, 4), 'gt_labels' (B, G), 'image_sizes'
        (B, 2), and with a mask head 'gt_masks' (B, G, M, M) (the GTs'
        box-normalized bitmasks). Returns loss_objectness,
        loss_rpn_box_reg, num_pos (the RPN's sampled positives),
        loss_classifier, loss_box_reg and loss_mask; with
        ``ctx.return_aux`` also the sampled anchors ("rpn_pos",
        "rpn_neg") and rois ("rois", "roi_labels", "roi_valid",
        "roi_gt_idx", with masks "mask_targets")."""
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
        image_sizes = batch["image_sizes"]
        bsz = images.shape[0]
        with record_function(SPAN_FORWARD):
            features, rpn_out = self.backbone_rpn(images)
        with record_function(SPAN_RPN_LOSS):
            losses = rpn_loss(
                rpn_out, gt_boxes, gt_labels, ctx.anchors, ctx.rpn,
                ctx.draws("rpn", (bsz, ctx.anchors.shape[0])),
                image_sizes=image_sizes, return_aux=ctx.return_aux)
        with record_function(SPAN_PROPOSALS):
            # proposals carry no gradient: K1 never sees the graph
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
        with record_function(SPAN_BOX_HEAD):
            cls_logits, box_deltas = self.box(features, flat_rois,
                                              batch_idx)
        with record_function(SPAN_BOX_LOSS):
            losses.update(roi_box_loss(
                cls_logits, box_deltas, flat_labels,
                reg_targets.reshape(-1, 4), flat_valid))
        if ctx.return_aux:
            losses.update(rois=rois, roi_labels=roi_labels,
                          roi_valid=roi_valid, roi_gt_idx=roi_gt_idx)
        if self.mask_head is None:
            return losses
        if "gt_masks" not in batch:
            raise KeyError("a Mask R-CNN train step needs the batch's "
                           "'gt_masks' (the loader's with MODEL.MASK_ON)")
        with record_function(SPAN_MASK_HEAD):
            mask_logits = self.mask(features, flat_rois, batch_idx)
        with record_function(SPAN_MASK_TARGETS):
            roi_masks = batch["gt_masks"][batch_idx,
                                          roi_gt_idx.reshape(-1)]
            targets = crop_gt_masks_for_rois(
                roi_masks.to(torch.float32), roi_gt_boxes.reshape(-1, 4),
                flat_rois, out_size=mask_logits.shape[-1])
        with record_function(SPAN_MASK_LOSS):
            losses.update(mask_loss(mask_logits, flat_labels, targets,
                                    flat_valid))
        if ctx.return_aux:
            losses["mask_targets"] = targets.reshape(
                bsz, s, *targets.shape[1:])
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
        return keys + (("gt_masks",) if self.cfg.MODEL.MASK_ON else ())

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
        ROI_HEADS.DETECTIONS_PER_IMG, ...), and for Mask R-CNN "masks"
        (B, DETECTIONS_PER_IMG, 28, 28) float32: the sigmoid of each
        kept box's class channel (channel 0 for an invalid slot)."""
        anchors, counts = self.anchors_for(images.shape[2:])
        features, rpn_out = self.module.backbone_rpn(images)
        proposals, _, p_valid = select_proposals(
            rpn_out, image_sizes, anchors, counts,
            RPNConfig.from_cfg(self.cfg, is_train=False))
        bsz, k = proposals.shape[:2]
        batch_idx = torch.arange(bsz, device=proposals.device
                                 ).repeat_interleave(k)
        cls_logits, box_deltas = self.module.box(
            features, proposals.reshape(-1, 4), batch_idx)
        c = cls_logits.shape[-1]
        det = roi_box_postprocess_batched(
            cls_logits.reshape(bsz, k, c),
            box_deltas.reshape(bsz, k, c, 4),
            proposals, p_valid, image_sizes, self.postprocess_config(),
        )
        if self.module.mask_head is not None:
            with record_function(SPAN_MASK_EVAL):
                d = det["boxes"].shape[1]
                logits = self.module.mask(
                    features, det["boxes"].reshape(-1, 4),
                    torch.arange(bsz, device=proposals.device
                                 ).repeat_interleave(d))
                channel = (det["labels"].reshape(-1) - 1).clamp(min=0)
                sel = logits[torch.arange(bsz * d, device=channel.device),
                             channel.long()]
                det["masks"] = torch.sigmoid(sel.to(torch.float32)).reshape(
                    bsz, d, *sel.shape[-2:])
        return det


def _mask_head(cfg, channels, dtype):
    """The FPN mask head of ``cfg`` (MaskRCNNFPNFeatureExtractor +
    MaskRCNNC4Predictor), or raise on the variants not ported."""
    mh = cfg.MODEL.ROI_MASK_HEAD
    unsupported = {
        "ROI_MASK_HEAD.USE_GN": mh.USE_GN,
        "ROI_MASK_HEAD.DILATION": mh.DILATION != 1,
        "ROI_MASK_HEAD.PREDICTOR": mh.PREDICTOR != "MaskRCNNC4Predictor",
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"paa_tpu_torch ports the FPN mask head with the deconv "
            f"predictor, no GN and no dilation; unsupported: {bad} "
            f"(the GN heads are ROADMAP item 10)")
    scales = tuple(mh.POOLER_SCALES)
    if len(scales) != 4:  # a C4-style default: the FPN levels
        scales = FPN_POOLER_SCALES
    return MaskHead(
        num_classes=cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES - 1,
        in_channels=channels, conv_layers=tuple(mh.CONV_LAYERS),
        resolution=mh.POOLER_RESOLUTION, scales=scales,
        sampling_ratio=max(mh.POOLER_SAMPLING_RATIO, 1), dtype=dtype)


def build_faster_rcnn(cfg, device, dtype=torch.float32):
    """The FPN2MLP Faster R-CNN of ``cfg`` on ``device`` (with the mask
    head when MODEL.MASK_ON), parameters not yet initialised
    (``build_detection_model`` seeds them)."""
    bh = cfg.MODEL.ROI_BOX_HEAD
    unsupported = {
        "KEYPOINT_ON": cfg.MODEL.KEYPOINT_ON,
        "CONV_BODY": not cfg.MODEL.BACKBONE.CONV_BODY.endswith("-FPN"),
        "FEATURE_EXTRACTOR": bh.FEATURE_EXTRACTOR != "FPN2MLPFeatureExtractor",
        "ROI_BOX_HEAD.USE_GN": bh.USE_GN,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"paa_tpu_torch ports the FPN2MLP Faster R-CNN and Mask R-CNN "
            f"on an R-*-FPN body only; unsupported: {bad} "
            f"({cfg.MODEL.BACKBONE.CONV_BODY}, {bh.FEATURE_EXTRACTOR}); "
            f"Keypoint R-CNN, the C4 bodies and the Xconv/GN heads are "
            f"ROADMAP item 10"
        )
    channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    module = FasterRCNN(
        build_backbone(cfg, dtype=dtype),
        RPNHead(num_anchors=len(cfg.MODEL.RPN.ASPECT_RATIOS),
                in_channels=channels, dtype=dtype),
        FPN2MLPBoxHead(
            num_classes=bh.NUM_CLASSES, in_channels=channels,
            mlp_dim=bh.MLP_HEAD_DIM, resolution=bh.POOLER_RESOLUTION,
            sampling_ratio=max(bh.POOLER_SAMPLING_RATIO, 1),
        ),
        _mask_head(cfg, channels, dtype) if cfg.MODEL.MASK_ON else None,
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

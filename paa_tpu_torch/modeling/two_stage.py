"""Faster R-CNN at inference (port of paa_tpu/modeling/two_stage.py, the
FPN2MLP branch).

R-50/101-FPN backbone (P2..P6, P6 by LastLevelMaxPool), the classic RPN
over 5 levels (anchor sizes 32..512 at strides 4..64, 3 ratios),
static-shape proposal selection and the FPN2MLP box head pooling from
P2..P5. On the card a request launches K1 once (the RPN's NMS, all
levels in one launch) and K2 once (the box head's NMS over R * (C - 1)
candidates per image).

Not ported yet: training (``rpn_loss``, ``subsample_proposals``,
``roi_box_loss``), the mask and keypoint heads, the Xconv and GN box
heads, C4/FBNet bodies and the RPN-only model; building any of them
raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .anchors import AnchorGenerator
from .detector import DetectionModel, build_backbone
from .roi_box_head import (
    FPN2MLPBoxHead,
    ROIBoxConfig,
    roi_box_postprocess_batched,
)
from .rpn import RPNConfig, RPNHead, select_proposals

RPN_STRIDES = (4, 8, 16, 32, 64)


class FasterRCNN(nn.Module):
    """backbone + RPN head + box head."""

    def __init__(self, backbone, rpn_head, box_head):
        super().__init__()
        self.backbone = backbone
        self.rpn_head = rpn_head
        self.box_head = box_head

    def backbone_rpn(self, images):
        features = self.backbone(images)
        return features, self.rpn_head(features)

    def box(self, features, rois, roi_batch_idx):
        # the pooler uses the first 4 pyramid levels (P2..P5)
        return self.box_head(list(features)[:4], rois, roi_batch_idx)


@dataclass
class TwoStageModel(DetectionModel):
    """A built Faster R-CNN: ``DetectionModel``'s anchors, shapes and
    ``make_eval_fn``, with the two-stage detection body."""

    def postprocess_config(self):
        return ROIBoxConfig.from_cfg(self.cfg)

    def loss_fn(self):
        raise NotImplementedError(
            "paa_tpu_torch does not train Faster R-CNN yet (ROADMAP item 7)")

    def detect(self, images, image_sizes):
        """Detections of normalized NCHW ``images`` (B, 3, H, W):
        {"boxes", "scores", "labels", "valid"}, each (B,
        ROI_HEADS.DETECTIONS_PER_IMG, ...)."""
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
        return roi_box_postprocess_batched(
            cls_logits.reshape(bsz, k, c),
            box_deltas.reshape(bsz, k, c, 4),
            proposals, p_valid, image_sizes, self.postprocess_config(),
        )


def build_faster_rcnn(cfg, device, dtype=torch.float32):
    """The FPN2MLP Faster R-CNN of ``cfg`` on ``device``, parameters not
    yet initialised (``build_detection_model`` seeds them)."""
    bh = cfg.MODEL.ROI_BOX_HEAD
    unsupported = {
        "MASK_ON": cfg.MODEL.MASK_ON,
        "KEYPOINT_ON": cfg.MODEL.KEYPOINT_ON,
        "CONV_BODY": not cfg.MODEL.BACKBONE.CONV_BODY.endswith("-FPN"),
        "FEATURE_EXTRACTOR": bh.FEATURE_EXTRACTOR != "FPN2MLPFeatureExtractor",
        "ROI_BOX_HEAD.USE_GN": bh.USE_GN,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"paa_tpu_torch ports the FPN2MLP Faster R-CNN on an R-*-FPN "
            f"body only; unsupported: {bad} "
            f"({cfg.MODEL.BACKBONE.CONV_BODY}, {bh.FEATURE_EXTRACTOR})"
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

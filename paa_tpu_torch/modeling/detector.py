"""Model assembly (port of paa_tpu/modeling/detector.py): the dense
detectors (PAA, ATSS, FCOS, RetinaNet), and Faster, Mask and Keypoint
R-CNN and the RPN-only model through two_stage.py.

A ``DetectionModel`` bundles the ``DenseDetector`` module (backbone +
dense head) on its device with the anchor generator (FCOS: its points,
tiled as anchors) and the static-shape helpers. The head's type picks
its loss (``loss_fn``) and its post-processing settings
(``postprocess_config``); the post-processing itself is the shared
``paa_postprocess`` (FCOS decodes l/t/r/b through ``decode_ltrb``), and
the train step is built per bucket shape (``make_bucket_train_step``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:
with no device given and no card present they raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Tuple

import torch
from torch import nn

from ..ops.image_norm import maybe_device_normalize
from ..solver import make_lr_schedule
from .anchors import (
    AnchorGenerator,
    LocationGenerator,
    make_anchor_generator_atss,
    make_anchor_generator_paa,
    make_anchor_generator_retinanet,
)
from .atss_head import atss_head_from_cfg
from .atss_loss import ATSSLossConfig, atss_loss
from .fcos_head import decode_ltrb, fcos_head_from_cfg
from .fcos_loss import FCOSLossConfig, fcos_loss
from .fpn import ResNetFPNBackbone
from .layers import reset_parameters
from .mobilenet import MobileNetV2
from .paa_head import paa_head_from_cfg
from .paa_inference import PostProcessConfig, paa_postprocess
from .paa_loss import PAALossConfig, paa_loss
from .resnet import resnet_from_cfg
from .retinanet_head import (
    RetinaNetLossConfig,
    retinanet_head_from_cfg,
    retinanet_loss,
)

# head type: (cfg node, head builder, anchor generator builder, (loss,
# loss config)); the JAX package's dispatch (detector.py:57-139, 299-335)
DENSE_HEADS = {
    "paa": ("PAA", paa_head_from_cfg, make_anchor_generator_paa,
            (paa_loss, PAALossConfig)),
    "atss": ("ATSS", atss_head_from_cfg, make_anchor_generator_atss,
             (atss_loss, ATSSLossConfig)),
    "fcos": ("FCOS", fcos_head_from_cfg,
             lambda cfg: LocationGenerator(cfg.MODEL.FCOS.FPN_STRIDES),
             (fcos_loss, FCOSLossConfig)),
    "retinanet": ("RETINANET", retinanet_head_from_cfg,
                  make_anchor_generator_retinanet,
                  (retinanet_loss, RetinaNetLossConfig)),
}


def dense_head_type(cfg):
    """"paa", "atss", "fcos" or "retinanet" from the MODEL.*_ON flags (in
    that order of precedence, as the JAX package reads them), else
    None."""
    for head_type, (node, *_) in DENSE_HEADS.items():
        if cfg.MODEL[f"{node}_ON"]:
            return head_type
    return None


def resolve_device(device=None):
    """``device`` as a torch.device; None means the card, and raises
    when there is none (the port never runs on the CPU unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paa_tpu_torch runs on a CUDA device; none is available. "
            "Pass device='cpu' to run the plain PyTorch versions."
        )
    return torch.device("cuda")


class DenseDetector(nn.Module):
    """backbone -> dense head: (B, 3, H, W) -> head output dict."""

    def __init__(self, backbone, head):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, images):
        return self.head(self.backbone(images))


@dataclass
class DetectionModel:
    """A built detection model: module + anchors + static-shape helpers."""

    cfg: Any
    module: nn.Module
    anchor_generator: AnchorGenerator
    strides: Tuple[int, ...]
    device: torch.device
    head_type: str = "paa"
    _anchors: dict = field(default_factory=dict, repr=False)

    def feature_shapes(self, image_hw):
        """Per-level (H, W) for a padded input (H, W), a multiple of 32
        (DATALOADER.SIZE_DIVISIBILITY): ceil(dim / stride) per level."""
        h, w = image_hw
        return [(int(math.ceil(h / s)), int(math.ceil(w / s)))
                for s in self.strides]

    def anchors_for(self, image_hw):
        """Concatenated (N, 4) float32 anchors on the model's device, and
        the per-level counts, for a padded input shape."""
        key = tuple(image_hw)
        if key not in self._anchors:
            anchors, counts = self.anchor_generator(
                self.feature_shapes(image_hw))
            self._anchors[key] = (
                torch.as_tensor(anchors, device=self.device), counts)
        return self._anchors[key]

    def postprocess_config(self):
        """The head's PostProcessConfig: PAA's from its node; the other
        heads' from theirs, with no score voting."""
        if self.head_type == "paa":
            return PostProcessConfig.from_cfg(self.cfg)
        c = self.cfg.MODEL[DENSE_HEADS[self.head_type][0]]
        return PostProcessConfig(
            pre_nms_thresh=c.INFERENCE_TH,
            pre_nms_top_n=c.PRE_NMS_TOP_N,
            nms_thresh=c.NMS_TH,
            detections_per_img=self.cfg.TEST.DETECTIONS_PER_IMG,
            num_classes=c.NUM_CLASSES - 1,
            score_voting=False,
        )

    def postprocess(self, outputs, image_sizes, anchors, level_counts):
        """The head's detections (``paa_postprocess``); FCOS decodes its
        l/t/r/b distances about the points, times each level's stride
        under NORM_REG_TARGETS."""
        pp = self.postprocess_config()
        if self.head_type != "fcos":
            return paa_postprocess(outputs, image_sizes, anchors,
                                   level_counts, pp)
        f = self.cfg.MODEL.FCOS
        reg_scales = (tuple(float(s) for s in f.FPN_STRIDES)
                      if f.NORM_REG_TARGETS else None)
        return paa_postprocess(outputs, image_sizes, anchors, level_counts,
                               pp, decode_fn=decode_ltrb,
                               reg_scales=reg_scales)

    def loss_fn(self):
        """(loss_callable, loss_config) of the head."""
        loss, config = DENSE_HEADS[self.head_type][3]
        return loss, config.from_cfg(self.cfg)

    # the batch keys a train step reads; image_sizes serves the uint8
    # device normalize
    train_batch_keys = ("images", "gt_boxes", "gt_labels", "image_sizes")

    def make_bucket_train_step(self, hw):
        """train_step(state, batch) -> metrics for padded inputs of shape
        ``hw`` (engine/train_step.py), with the config's learning-rate
        schedule and on-device uint8 normalize; data-parallel over the
        ranks of a process group (utils/comm.py)."""
        # engine imports us
        from ..engine.train_step import dense_forward_loss, make_train_step

        loss_call, loss_cfg = self.loss_fn()
        anchors, counts = self.anchors_for(hw)
        return make_train_step(
            dense_forward_loss(anchors, counts, loss_cfg, loss_call),
            make_lr_schedule(self.cfg), self.device,
            normalize=(self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD))

    def detect(self, images, image_sizes):
        """Detections of normalized NCHW ``images`` on the device."""
        anchors, counts = self.anchors_for(images.shape[2:])
        return self.postprocess(self.module(images), image_sizes, anchors,
                                counts)

    def make_eval_fn(self, state=None):
        """eval_fn(images, image_sizes) -> {"boxes", "scores", "labels",
        "valid"}, each (B, DETECTIONS_PER_IMG, ...), on the model's device.

        images: (B, H, W, 3) uint8 raw pixels (normalized on the device,
        padding re-zeroed) or float32 already normalized; image_sizes:
        (B, 2) (h, w) of the un-padded content. ``state``, if given, is a
        state_dict loaded into the module first. Each call puts the module
        in eval mode (a SyncBatchNorm normalizes by its running
        statistics), whatever a train step did in between."""
        if state is not None:
            self.module.load_state_dict(state)
        mean, std = self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD

        @torch.inference_mode()
        def eval_fn(images, image_sizes):
            self.module.eval()
            images = torch.as_tensor(images).to(self.device)
            image_sizes = torch.as_tensor(image_sizes).to(self.device)
            x = maybe_device_normalize(images, image_sizes, mean, std)
            return self.detect(x.permute(0, 3, 1, 2).contiguous(),
                               image_sizes)

        return eval_fn


def _torch_dtype(name):
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"TPU.COMPUTE_DTYPE {name!r}: one of {list(dtypes)}")
    return dtypes[name]


def build_backbone(cfg, dtype=torch.float32):
    """Body + FPN in the wiring the body names: *-FPN-RETINANET (P3-P7,
    P6 from C5 with RETINANET.USE_C5, else from P5) or *-FPN (P2-P6, P6
    pooled); FPN.USE_GN and FPN.USE_RELU as set. MNV2-FPN-RETINANET is
    the MobileNetV2 body (modeling/mobilenet.py) in the first wiring,
    its C3-C5 of (32, 96, 320) channels into FPN and P6 from P5, without
    the FPN's GN or ReLU, as the JAX package builds it."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    out_channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    if body == "MNV2-FPN-RETINANET":
        return ResNetFPNBackbone(
            MobileNetV2(dtype=dtype), list(MobileNetV2.feature_channels()),
            out_channels=out_channels, dtype=dtype, retina=True,
            p6_from_c5=False)
    retina = body.endswith("FPN-RETINANET")
    if not (retina or body.endswith("FPN")):
        raise NotImplementedError(
            f"paa_tpu_torch ports the *-FPN-RETINANET wiring and the *-FPN "
            f"wiring (pooled P6), not {body}")
    r = cfg.MODEL.RESNETS
    in_channels_list = [r.RES2_OUT_CHANNELS * 2 ** i for i in range(4)]
    return ResNetFPNBackbone(
        resnet_from_cfg(cfg, dtype=dtype),
        in_channels_list,
        out_channels=out_channels,
        dtype=dtype,
        retina=retina,
        p6_from_c5=retina and cfg.MODEL.RETINANET.USE_C5,
        use_gn=cfg.MODEL.FPN.USE_GN,
        use_relu=cfg.MODEL.FPN.USE_RELU,
    )


def build_detection_model(cfg, device=None, seed=0):
    """Build the model of ``cfg`` on ``device`` (default: the card),
    computing in ``TPU.COMPUTE_DTYPE``, with weights initialised from
    ``seed`` as the JAX package initialises them (kaiming-uniform
    backbone and box-head FCs, normal(0.01) heads and cls_score,
    normal(0.001) bbox_pred, focal-prior cls biases, identity FrozenBN
    and GroupNorm).

    PAA_ON, ATSS_ON, FCOS_ON or RETINANET_ON builds that dense detector
    (the first set, in that order); with none of them and RPN_ONLY off it
    is the Faster R-CNN of two_stage.py (Mask R-CNN with MASK_ON,
    Keypoint R-CNN with KEYPOINT_ON), with RPN_ONLY the RPN-only proposal
    model of two_stage.py, as in the JAX package."""
    device = resolve_device(device)
    dtype = _torch_dtype(cfg.TPU.COMPUTE_DTYPE)
    head_type = dense_head_type(cfg)
    if head_type is not None:
        node, head_from_cfg, anchor_generator, _ = DENSE_HEADS[head_type]
        strides = (cfg.MODEL.FCOS.FPN_STRIDES if head_type == "fcos"
                   else cfg.MODEL[node].ANCHOR_STRIDES)
        model = DetectionModel(
            cfg=cfg,
            module=DenseDetector(build_backbone(cfg, dtype=dtype),
                                 head_from_cfg(cfg, dtype=dtype)),
            anchor_generator=anchor_generator(cfg),
            strides=tuple(strides),
            device=device,
            head_type=head_type,
        )
    else:
        # two_stage imports this module
        from .two_stage import build_faster_rcnn, build_rpn_only

        build = build_rpn_only if cfg.MODEL.RPN_ONLY else build_faster_rcnn
        model = build(cfg, device, dtype=dtype)
    reset_parameters(model.module, torch.Generator().manual_seed(seed))
    model.module.to(device)
    return model

"""Model assembly (port of paa_tpu/modeling/detector.py): PAA, and
Faster R-CNN through two_stage.py.

A ``DetectionModel`` bundles the ``DenseDetector`` module (backbone +
PAA head) on its device with the anchor generator and the static-shape
helpers; post-processing is a plain function (paa_inference.py), and the
train step is built per bucket shape (``make_bucket_train_step``, PAA
only).

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
from .anchors import AnchorGenerator, make_anchor_generator_paa
from .fpn import ResNetFPNBackbone
from .layers import reset_parameters
from .paa_head import paa_head_from_cfg
from .paa_inference import PostProcessConfig, paa_postprocess
from .paa_loss import PAALossConfig, paa_loss
from .resnet import resnet_from_cfg


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
        return PostProcessConfig.from_cfg(self.cfg)

    def loss_fn(self):
        """(loss_callable, loss_config) of the head: PAA's; other heads
        do not train in the port and raise."""
        if not self.cfg.MODEL.PAA_ON:
            raise NotImplementedError("paa_tpu_torch trains PAA models only")
        return paa_loss, PAALossConfig.from_cfg(self.cfg)

    # the batch keys a train step reads; image_sizes serves the uint8
    # device normalize
    train_batch_keys = ("images", "gt_boxes", "gt_labels", "image_sizes")

    def make_bucket_train_step(self, hw, num_shards=1):
        """train_step(state, batch) -> metrics for padded inputs of shape
        ``hw`` (engine/train_step.py), with the config's learning-rate
        schedule and on-device uint8 normalize."""
        from ..engine.train_step import make_train_step  # engine imports us

        loss_call, loss_cfg = self.loss_fn()
        anchors, counts = self.anchors_for(hw)
        return make_train_step(
            anchors, counts, loss_cfg, make_lr_schedule(self.cfg),
            num_shards=num_shards, loss_call=loss_call,
            normalize=(self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD))

    def detect(self, images, image_sizes):
        """PAA detections of normalized NCHW ``images`` on the device."""
        anchors, counts = self.anchors_for(images.shape[2:])
        return paa_postprocess(self.module(images), image_sizes, anchors,
                               counts, self.postprocess_config())

    def make_eval_fn(self, state=None):
        """eval_fn(images, image_sizes) -> {"boxes", "scores", "labels",
        "valid"}, each (B, DETECTIONS_PER_IMG, ...), on the model's device.

        images: (B, H, W, 3) uint8 raw pixels (normalized on the device,
        padding re-zeroed) or float32 already normalized; image_sizes:
        (B, 2) (h, w) of the un-padded content. ``state``, if given, is a
        state_dict loaded into the module first."""
        if state is not None:
            self.module.load_state_dict(state)
        self.module.eval()
        mean, std = self.cfg.INPUT.PIXEL_MEAN, self.cfg.INPUT.PIXEL_STD

        @torch.inference_mode()
        def eval_fn(images, image_sizes):
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
    """ResNet + FPN in the wiring the body names: *-FPN-RETINANET (P3-P7,
    P6 from P5) or *-FPN (P2-P6, P6 pooled); no FPN GN or ReLU."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    retina = body.endswith("FPN-RETINANET")
    if not (retina or body.endswith("FPN")) or cfg.MODEL.FPN.USE_GN or \
            cfg.MODEL.FPN.USE_RELU or (retina and cfg.MODEL.RETINANET.USE_C5):
        raise NotImplementedError(
            f"paa_tpu_torch ports the *-FPN-RETINANET wiring (P6 from P5) "
            f"and the *-FPN wiring (pooled P6), without FPN GN or ReLU, "
            f"not {body} with FPN.USE_GN={cfg.MODEL.FPN.USE_GN}, "
            f"FPN.USE_RELU={cfg.MODEL.FPN.USE_RELU}, RETINANET.USE_C5="
            f"{cfg.MODEL.RETINANET.USE_C5}"
        )
    r = cfg.MODEL.RESNETS
    in_channels_list = [r.RES2_OUT_CHANNELS * 2 ** i for i in range(4)]
    return ResNetFPNBackbone(
        resnet_from_cfg(cfg, dtype=dtype),
        in_channels_list,
        out_channels=r.BACKBONE_OUT_CHANNELS,
        dtype=dtype,
        retina=retina,
    )


def build_detection_model(cfg, device=None, seed=0):
    """Build the model of ``cfg`` on ``device`` (default: the card),
    computing in ``TPU.COMPUTE_DTYPE``, with weights initialised from
    ``seed`` as the JAX package initialises them (kaiming-uniform
    backbone and box-head FCs, normal(0.01) heads and cls_score,
    normal(0.001) bbox_pred, focal-prior PAA cls bias, identity FrozenBN
    and GroupNorm).

    PAA_ON builds the PAA detector; with no dense head and RPN_ONLY off
    it is the Faster R-CNN of two_stage.py, as in the JAX package. Other
    heads raise."""
    m = cfg.MODEL
    device = resolve_device(device)
    dtype = _torch_dtype(cfg.TPU.COMPUTE_DTYPE)
    if m.PAA_ON:
        model = DetectionModel(
            cfg=cfg,
            module=DenseDetector(build_backbone(cfg, dtype=dtype),
                                 paa_head_from_cfg(cfg, dtype=dtype)),
            anchor_generator=make_anchor_generator_paa(cfg),
            strides=tuple(cfg.MODEL.PAA.ANCHOR_STRIDES),
            device=device,
        )
    elif not (m.ATSS_ON or m.FCOS_ON or m.RETINANET_ON or m.RPN_ONLY):
        from .two_stage import build_faster_rcnn  # two_stage imports this

        model = build_faster_rcnn(cfg, device, dtype=dtype)
    else:
        raise NotImplementedError(
            "paa_tpu_torch builds PAA and Faster R-CNN models only")
    reset_parameters(model.module, torch.Generator().manual_seed(seed))
    model.module.to(device)
    return model

"""The Mask R-CNN mask head (port of paa_tpu/modeling/roi_mask_head.py;
reference paa_core/modeling/roi_heads/mask_head/).

- ``MaskHead``: MaskRCNNFPNFeatureExtractor (multilevel ROIAlign 14x14,
  sampling ratio 2, then 4 x [conv3x3 256 + ReLU], kaiming-uniform a=1,
  in the compute dtype) and MaskRCNNC4Predictor (a 2x2 stride-2
  transposed conv + ReLU in float32, then a 1x1 conv, normal(0.001), to
  C - 1 class channels): (R, C - 1, 28, 28) logits, NCHW. The JAX
  package emits the same C - 1 foreground channels, NHWC; the
  reference's channel 0 is dropped on import (utils/torch_import.py).
  Its variants (roi_mask_feature_extractors.py, make_conv3x3): with
  ``use_gn`` (ROI_MASK_HEAD.USE_GN) each ``mask_fcn{i}`` drops its bias
  and a GroupNorm ``mask_fcn{i}_gn`` with the ReLU fused follows it (K3
  on the card); ``dilation`` (DILATION) dilates the convs; without
  ``use_deconv`` (PREDICTOR MaskRCNNConv1x1Predictor) the 1x1 conv reads
  the 14x14 features directly: (R, C - 1, 14, 14). With one pooler
  scale (the C4 models' unshared head on the stride-16 map) it pools
  that single map.
- ``crop_gt_masks_for_rois``: the 28x28 targets, cropped on the device
  from each matched GT's box-normalized bitmask (structures/masks.py) by
  ROIAlign of the roi mapped into the GT box's frame, then thresholded
  at 0.5.
- ``mask_loss``: binary cross-entropy on the matched class's channel
  over the positive rois (mask_head/loss.py maskrcnn_loss).

- ``MaskRCNNC4Predictor`` alone (the C4 Mask R-CNN): on the box head's
  res5 features, which the reference's C4 model shares with its mask
  branch (roi_heads.py:19), a 2x2 stride-2 transposed conv to
  CONV_LAYERS[-1] channels + ReLU and a 1x1 conv to C - 1 class
  channels, both in the compute dtype, kaiming-normal fan-out:
  (R, C - 1, 14, 14) logits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import (
    align_on_own_maps, multilevel_roi_align, roi_align)
from .layers import Conv, ConvTranspose, GroupNorm32, gn_or_relu

_LOGITS_STD = 0.001


class MaskHead(nn.Module):
    """MaskRCNNFPNFeatureExtractor (+ its GN and dilated variants) and
    MaskRCNNC4Predictor, or with ``use_deconv`` False
    MaskRCNNConv1x1Predictor."""

    def __init__(self, num_classes, in_channels=256,
                 conv_layers=(256, 256, 256, 256), resolution=14,
                 scales=(0.25, 0.125, 0.0625, 0.03125), sampling_ratio=2,
                 dtype=torch.float32, use_gn=False, dilation=1,
                 use_deconv=True):
        super().__init__()
        self.resolution = resolution
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.num_layers = len(conv_layers)
        channels = in_channels
        for i, out in enumerate(conv_layers):
            setattr(self, f"mask_fcn{i + 1}",
                    Conv(channels, out, 3, padding=dilation,
                         dilation=dilation, bias=not use_gn, dtype=dtype))
            if use_gn:
                setattr(self, f"mask_fcn{i + 1}_gn", GroupNorm32(out))
            channels = out
        self.conv5_mask = (ConvTranspose(channels, channels) if use_deconv
                           else None)
        self.mask_fcn_logits = Conv(channels, num_classes, 1, bias=True,
                                    dtype=dtype, normal_std=_LOGITS_STD)

    def forward(self, features, rois, roi_batch_idx):
        """features: the first len(scales) FPN maps (P2..P5), or the one
        map of a single scale, NCHW; rois (R, 4); roi_batch_idx (R,).
        Returns (R, C - 1, 28, 28) logits in the compute dtype (14 x 14
        without the deconv)."""
        out_size = (self.resolution, self.resolution)
        if len(self.scales) == 1:
            x = roi_align(features[0], rois, roi_batch_idx, out_size,
                          self.scales[0], self.sampling_ratio)
        else:
            x = multilevel_roi_align(features, rois, roi_batch_idx,
                                     out_size, self.scales,
                                     self.sampling_ratio)
        x = x.permute(0, 3, 1, 2).contiguous()  # NCHW, as K3 takes it
        for i in range(1, self.num_layers + 1):
            x = gn_or_relu(getattr(self, f"mask_fcn{i}_gn", None),
                           getattr(self, f"mask_fcn{i}")(x))
        if self.conv5_mask is not None:
            x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x)


class MaskRCNNC4Predictor(nn.Module):
    """The C4 mask predictor on shared res5 ROI features
    (roi_mask_predictors.py:10-31, the JAX package's
    MaskRCNNC4Predictor): NCHW (R, 2048, 7, 7) -> (R, C - 1, 14, 14)."""

    def __init__(self, num_classes, in_channels=2048, dim_reduced=256,
                 dtype=torch.float32):
        super().__init__()
        # Caffe2's MSRAFill: kaiming-normal, fan-out
        self.conv5_mask = ConvTranspose(
            in_channels, dim_reduced, dtype=dtype,
            normal_std=math.sqrt(2.0 / (4 * dim_reduced)))
        self.mask_fcn_logits = Conv(
            dim_reduced, num_classes, 1, bias=True, dtype=dtype,
            normal_std=math.sqrt(2.0 / num_classes))

    def forward(self, res5):
        return self.mask_fcn_logits(F.relu(self.conv5_mask(res5)))


def crop_gt_masks_for_rois(gt_masks, matched_gt_boxes, rois, out_size=28):
    """The mask targets: each roi's window bilinearly cropped from its
    matched GT's box-normalized bitmask and thresholded at 0.5.

    gt_masks (R, M, M) float, the matched GT's mask per roi;
    matched_gt_boxes (R, 4); rois (R, 4). Returns (R, out_size,
    out_size) float32 in {0, 1}."""
    m = gt_masks.shape[-1]
    gx1, gy1 = matched_gt_boxes[:, 0], matched_gt_boxes[:, 1]
    gw = torch.clamp(matched_gt_boxes[:, 2] - gx1 + 1.0, min=1.0)
    gh = torch.clamp(matched_gt_boxes[:, 3] - gy1 + 1.0, min=1.0)
    # the roi mapped into the GT box's mask frame
    mask_rois = torch.stack([
        (rois[:, 0] - gx1) / gw * m, (rois[:, 1] - gy1) / gh * m,
        (rois[:, 2] - gx1) / gw * m, (rois[:, 3] - gy1) / gh * m,
    ], dim=1)
    crops = align_on_own_maps(gt_masks.to(torch.float32), mask_rois,
                              (out_size, out_size), 2)
    return (crops > 0.5).to(torch.float32)


def mask_loss(mask_logits, roi_labels, mask_targets, roi_valid):
    """Binary cross-entropy of the matched class's channel (class - 1)
    against the targets, averaged over the pixels and over the positive
    rois. mask_logits (R, C - 1, M, M); roi_labels (R,); mask_targets
    (R, M, M); roi_valid (R,)."""
    posf = ((roi_labels > 0) & roi_valid).to(torch.float32)
    n = posf.sum().clamp(min=1.0)
    r = mask_logits.shape[0]
    channel = (roi_labels - 1).clamp(min=0).long()
    logits = mask_logits[torch.arange(r, device=channel.device),
                         channel].to(torch.float32)
    t = mask_targets
    bce = -(t * F.logsigmoid(logits)
            + (1 - t) * F.logsigmoid(-logits)).mean(dim=(1, 2))
    return {"loss_mask": (bce * posf).sum() / n}

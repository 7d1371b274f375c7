"""The Keypoint R-CNN keypoint head (port of
paa_tpu/modeling/roi_keypoint_head.py; reference
paa_core/modeling/roi_heads/keypoint_head/).

- ``KeypointHead``: KeypointRCNNFeatureExtractor (multilevel ROIAlign
  14x14 over P2..P5, sampling ratio 2, then CONV_LAYERS 3x3 convs +
  ReLU, (512,) * 8 by default, kaiming-normal fan-out, in the compute
  dtype) and KeypointRCNNPredictor (a 4x4 stride-2 transposed conv
  with padding 1 to the K keypoint channels at 28x28, in float32, then
  bilinear x2, align_corners=False, to 56x56): (R, K, 56, 56) float32
  logits, NCHW. The JAX package's are (R, 56, 56, K).
- ``keypoint_loss``: each roi's matched GT keypoints projected into its
  56x56 frame (structures/keypoints.py ``keypoints_to_heatmap``) and
  softmax cross-entropy over the 3,136 bins, averaged over the visible
  keypoints inside positive rois (KeypointRCNNLossComputation,
  loss.py:146-170).

At inference the heatmaps go to the host, where
``structures.keypoints.heatmaps_to_keypoints`` decodes them
(engine/inference.py).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.roi_align import multilevel_roi_align
from ..structures.keypoints import keypoints_to_heatmap
from .layers import Conv, ConvTranspose


def kaiming_normal_fan_out_std(kernel_size, out_channels):
    """The std of flax's variance_scaling(2, "fan_out", "normal") for a
    kernel (kh, kw, cin, cout): sqrt(2 / (kh * kw * cout))."""
    return math.sqrt(2.0 / (kernel_size * kernel_size * out_channels))


class KeypointHead(nn.Module):
    """KeypointRCNNFeatureExtractor + KeypointRCNNPredictor."""

    def __init__(self, num_keypoints=17, in_channels=256,
                 conv_layers=(512,) * 8, resolution=14,
                 scales=(0.25, 0.125, 0.0625, 0.03125), sampling_ratio=2,
                 dtype=torch.float32):
        super().__init__()
        self.resolution = resolution
        self.scales = tuple(scales)
        self.sampling_ratio = sampling_ratio
        self.num_layers = len(conv_layers)
        channels = in_channels
        for i, out in enumerate(conv_layers):
            setattr(self, f"conv_fcn{i + 1}", Conv(
                channels, out, 3, padding=1, bias=True, dtype=dtype,
                normal_std=kaiming_normal_fan_out_std(3, out)))
            channels = out
        self.kps_score_lowres = ConvTranspose(
            channels, num_keypoints, 4, stride=2, padding=1,
            normal_std=kaiming_normal_fan_out_std(4, num_keypoints))

    def forward(self, features, rois, roi_batch_idx):
        """features: the first len(scales) FPN maps (P2..P5), NCHW; rois
        (R, 4); roi_batch_idx (R,). Returns (R, K, 4 * resolution,
        4 * resolution) float32 logits."""
        x = multilevel_roi_align(
            features, rois, roi_batch_idx,
            (self.resolution, self.resolution), self.scales,
            self.sampling_ratio,
        ).permute(0, 3, 1, 2)
        for i in range(self.num_layers):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        return F.interpolate(self.kps_score_lowres(x), scale_factor=2,
                             mode="bilinear", align_corners=False)


def keypoint_loss(kp_logits, rois, roi_keypoints, roi_positive):
    """Softmax cross-entropy over the heatmap bins of each keypoint
    (loss.py KeypointRCNNLossComputation.__call__:146-170).

    kp_logits (R, K, S, S); rois (R, 4); roi_keypoints (R, K, 3), each
    roi's matched GT keypoints in image coordinates; roi_positive (R,)
    bool. The mean over the visible keypoints inside positive rois (0
    when there is none)."""
    r, k, s, _ = kp_logits.shape
    lin, valid = keypoints_to_heatmap(roi_keypoints.to(torch.float32),
                                      rois.to(torch.float32), s)
    validf = (valid * roi_positive[:, None]).reshape(-1).to(torch.float32)
    ce = F.cross_entropy(kp_logits.to(torch.float32).reshape(r * k, s * s),
                         lin.reshape(-1), reduction="none")
    return {"loss_kp": (ce * validf).sum() / validf.sum().clamp(min=1.0)}

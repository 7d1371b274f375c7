"""FPN (port of paa_tpu/modeling/fpn.py) in the two wirings the ported
configs use:

- "R-*-FPN-RETINANET" (the PAA, ATSS, FCOS and RetinaNet configs): the
  C2 lateral is skipped, P6 comes from P5 (RETINANET.USE_C5=False) or
  from C5 (USE_C5=True, RetinaNet's default) and P7 from relu(P6); the
  output is (P3, P4, P5, P6, P7);
- "R-*-FPN" (Faster R-CNN): the C2 lateral is used and P6 is
  ``LastLevelMaxPool``, a 1x1 max-pool of stride 2 of P5; the output is
  (P2, P3, P4, P5, P6).

Modules carry the flax names: ``fpn_inner{k}``/``fpn_layer{k}`` with k
the index of C_k among C2..C5 counted from 1 (2..4 when C2 is skipped).
With ``use_gn`` (FPN.USE_GN) each lateral and output conv drops its
bias and a GroupNorm ``fpn_inner{k}_gn``/``fpn_layer{k}_gn`` follows it
(K3 on the card), with ``use_relu`` (FPN.USE_RELU) then a ReLU (fused
into K3 after a GN): the reference's conv_with_kaiming_uniform(use_gn,
use_relu).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .layers import Conv, GroupNorm32, gn_or_relu

# the spans of the body and of the FPN, in serving and in the train
# step's forward; the benchmark's serve.body_ms, train.body_backward_ms
# and train.backward_idle_ms read them
SPAN_BODY = "detector/body"
SPAN_FPN = "detector/fpn"


def _upsample_nearest(x, target_hw):
    """Nearest resize of NCHW ``x`` to (H, W): a 2x repeat in the exact
    2x case FPN uses on padded inputs, else half-pixel-centre nearest
    like jax.image.resize."""
    h, w = x.shape[2:]
    if tuple(target_hw) == (2 * h, 2 * w):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")


class FPN(nn.Module):
    """Takes [C2, C3, C4, C5]; returns (P3, P4, P5, P6, P7) in the
    ``retina`` wiring (P6 from C5 with ``p6_from_c5``, else from P5),
    else (P2, P3, P4, P5, P6) with the pooled P6."""

    def __init__(self, in_channels_list, out_channels=256,
                 dtype=torch.float32, retina=True, p6_from_c5=False,
                 use_gn=False, use_relu=False):
        super().__init__()
        self.start = 1 if retina else 0
        self.use_relu = use_relu
        used = in_channels_list[self.start:]
        for i, cin in enumerate(used):
            k = self.start + i + 1
            for name, c, size in ((f"fpn_inner{k}", cin, 1),
                                  (f"fpn_layer{k}", out_channels, 3)):
                self.add_module(name, Conv(
                    c, out_channels, size, padding=size // 2,
                    bias=not use_gn, dtype=dtype))
                if use_gn:
                    self.add_module(f"{name}_gn", GroupNorm32(
                        out_channels, relu=use_relu))
        self.num_used = len(used)
        self.retina = retina
        self.p6_from_c5 = p6_from_c5
        if retina:
            p6_in = in_channels_list[-1] if p6_from_c5 else out_channels
            self.p6 = Conv(p6_in, out_channels, 3, stride=2,
                           padding=1, bias=True, dtype=dtype)
            self.p7 = Conv(out_channels, out_channels, 3, stride=2,
                           padding=1, bias=True, dtype=dtype)

    def _block(self, name, x):
        """conv, then GN and ReLU as configured."""
        return gn_or_relu(getattr(self, f"{name}_gn", None),
                          getattr(self, name)(x), self.use_relu)

    def forward(self, features):
        used = list(features)[self.start:]
        n = self.num_used
        k0 = self.start + 1
        laterals = [self._block(f"fpn_inner{k0 + i}", f)
                    for i, f in enumerate(used)]
        merged = [None] * n
        merged[-1] = laterals[-1]
        for i in range(n - 2, -1, -1):
            top = _upsample_nearest(merged[i + 1], laterals[i].shape[2:])
            merged[i] = laterals[i] + top
        results = [self._block(f"fpn_layer{k0 + i}", m)
                   for i, m in enumerate(merged)]
        if not self.retina:
            # LastLevelMaxPool: max_pool2d(P5, 1, 2) keeps every other pixel
            return (*results, results[-1][:, :, ::2, ::2])
        p6 = self.p6(used[-1] if self.p6_from_c5 else results[-1])
        p7 = self.p7(F.relu(p6))
        return (*results, p6, p7)


class ResNetFPNBackbone(nn.Module):
    """body + fpn (reference backbone.py:49-73)."""

    def __init__(self, resnet, in_channels_list, out_channels=256,
                 dtype=torch.float32, retina=True, p6_from_c5=False,
                 use_gn=False, use_relu=False):
        super().__init__()
        self.resnet = resnet
        self.fpn = FPN(in_channels_list, out_channels, dtype=dtype,
                       retina=retina, p6_from_c5=p6_from_c5, use_gn=use_gn,
                       use_relu=use_relu)

    def forward(self, x):
        with record_function(SPAN_BODY):
            features = self.resnet(x)
        with record_function(SPAN_FPN):
            return self.fpn(features)

"""Deformable (modulated) position-sensitive ROI pooling (port of
paa_tpu/ops/deform_pool.py; reference CUDA op
``deform_psroi_pooling_forward``, csrc/cuda/deform_pool_kernel_cuda.cu
DeformablePSROIPoolForwardKernel).

Each roi is cut into out_size x out_size bins; every bin averages
``sample_per_part`` ^ 2 bilinear samples of the position-sensitive
channel group of that bin, at places shifted by a learned per-part
offset (the ``trans`` branch, times ``trans_std``). A sample outside
the image is skipped, as the kernel's ``continue``; a bin's value is
the sum over its valid samples divided by their count, 0 without any.

Plain PyTorch on the port's NCHW layout, the reference op's: features
(B, C, H, W), trans (R, 2 * num_classes, part, part), pooled (R, D,
out_size, out_size). The samples are gathered from the flattened
features, so autograd gives the gradient of the features and of the
offsets, as ``jax.grad`` does for the JAX package's version. Nothing in
the JAX package calls it.
"""

from __future__ import annotations

import torch


def _bilinear(flat, base, x, y, width):
    """The JAX package's ``_bilinear`` at (x, y), already clamped into
    the map, on the channel planes that start at ``base`` of ``flat``
    (the features flattened): corners floor and ceil of each
    coordinate."""
    x1, y1 = torch.floor(x), torch.floor(y)
    x2, y2 = torch.ceil(x), torch.ceil(y)
    dx, dy = x - x1, y - y1

    def at(yy, xx):
        return flat[base + (yy * width + xx).long()]

    return ((1 - dx) * (1 - dy) * at(y1, x1)
            + (1 - dx) * dy * at(y2, x1)
            + dx * (1 - dy) * at(y1, x2)
            + dx * dy * at(y2, x2))


def deform_psroi_pool(features, rois, roi_batch_idx, trans=None, *,
                      spatial_scale, out_size, out_channels, group_size,
                      part_size=None, sample_per_part=4, trans_std=0.1):
    """features: (B, C, H, W) float32 with C == out_channels *
    group_size ^ 2 in the position-sensitive order c = (ctop * G + gh) *
    G + gw; rois: (R, 4) xyxy in image coordinates; roi_batch_idx: (R,);
    trans: (R, 2 * num_classes, part_size, part_size) offsets (channel
    2k is x of class k, 2k + 1 its y) or None (no offsets).

    Returns (R, out_channels, out_size, out_size)."""
    if part_size is None:
        part_size = out_size
    _, c, height, width = features.shape
    g, d, p, s = group_size, out_channels, out_size, sample_per_part
    assert c == d * g * g, (c, d, g)
    num_classes = 1 if trans is None else trans.shape[1] // 2
    ceach = d // num_classes
    dev = features.device
    r = rois.shape[0]
    rois = rois.to(torch.float32)

    bins = torch.arange(p, device=dev)
    cell = torch.clamp((bins * g) // p, 0, g - 1)  # gh or gw per bin
    part = torch.floor(bins.to(torch.float32) / p * part_size).long()
    x0 = torch.round(rois[:, 0]) * spatial_scale - 0.5
    y0 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    x1 = (torch.round(rois[:, 2]) + 1.0) * spatial_scale - 0.5
    y1 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x1 - x0, min=0.1)
    roi_h = torch.clamp(y1 - y0, min=0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    sub_w, sub_h = bin_w / s, bin_h / s

    # (R, classes, P, P) offsets at each bin's part cell
    if trans is None:
        tx = ty = torch.zeros(r, num_classes, p, p, device=dev)
    else:
        tr = trans.to(torch.float32)[:, :, part[:, None], part[None, :]]
        tx = tr[:, 0::2] * trans_std
        ty = tr[:, 1::2] * trans_std

    def view(t):  # (R,) -> (R, 1, 1, 1)
        return t[:, None, None, None]

    wstart = bins.to(torch.float32) * view(bin_w) + view(x0) + tx * view(
        roi_w)  # (R, K, P(h), P(w)) with the bin's column along w
    hstart = (bins.to(torch.float32)[:, None] * view(bin_h) + view(y0)
              + ty * view(roi_h))
    steps = torch.arange(s, dtype=torch.float32, device=dev)
    # (R, K, P, P, S(y), S(x))
    w_pts = (wstart[..., None, None]
             + steps * view(sub_w)[..., None, None])
    h_pts = (hstart[..., None, None]
             + steps[:, None] * view(sub_h)[..., None, None])
    w_pts, h_pts = torch.broadcast_tensors(w_pts, h_pts)
    valid = ((w_pts >= -0.5) & (w_pts <= width - 0.5)
             & (h_pts >= -0.5) & (h_pts <= height - 0.5))
    wc = torch.clamp(w_pts, 0.0, width - 1.0)
    hc = torch.clamp(h_pts, 0.0, height - 1.0)

    # channel of (class k, its channel e, bin (py, px)): (K, E, P, P)
    ctop = torch.arange(num_classes * ceach, device=dev).reshape(
        num_classes, ceach)
    chan = (ctop[:, :, None, None] * g + cell[:, None]) * g + cell
    # plane starts (R, K, E, P, P), then broadcast over the samples
    plane = (roi_batch_idx.long()[:, None, None, None, None] * c
             + chan) * (height * width)
    flat = features.reshape(-1)
    vals = _bilinear(flat, plane[..., None, None], wc[:, :, None],
                     hc[:, :, None], width)  # (R, K, E, P, P, S, S)
    keep = valid[:, :, None]
    total = torch.where(keep, vals, 0.0).sum(dim=(-2, -1))
    count = keep.sum(dim=(-2, -1))
    out = torch.where(count > 0, total / torch.clamp(count, min=1), 0.0)
    return out.reshape(r, d, p, p)

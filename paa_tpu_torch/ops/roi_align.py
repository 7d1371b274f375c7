"""ROIAlign, ROIPool and the FPN pooler (port of
paa_tpu/ops/roi_align.py).

The JAX package computes these in XLA, not in a Pallas kernel, so plain
PyTorch is their port. Semantics are the legacy maskrcnn-benchmark
ROIAlign (aligned=False: no -0.5 half-pixel offset, ``roi_w = max(end -
start, 1)``, ``sampling_ratio`` samples per bin along each axis,
averaged; reference ROIAlign_cuda.cu:24-90), with the JAX package's
edge handling: a sample is kept when -1 <= y <= H and -1 <= x <= W,
then clamped into the map, and ``y1 = min(y0 + 1, H - 1)``.

Features are the port's NCHW maps; pooled features come out
channels-last, (R, ph, pw, C), the JAX package's order, which the box
head's fc6 flattens. The sample grid of a roi is separable, so the
bilinear weights are built per axis and gathered as rows of a
channels-last table of the maps. Bilinear sums are float32 whatever the
features' dtype (bfloat16 rows times float32 weights promote, as in the
JAX package).

``_align`` runs its rois in chunks whose (R, Sy, Sx, C) float32 corner
terms stay under ``CHUNK_BYTES``: the mask head's 14x14 pool of 8,192
training rois at 256 channels would otherwise hold four 6.6 GB corner
tensors (and their gradients). Each roi's numbers do not depend on the
chunking.

``roi_align`` and ``multilevel_roi_align`` run inside the span
``roi_align/forward`` and count their calls and rois in ``COUNTS``
(``ops.launch_counts``: "roi_align", "roi_align_rois"), on every
device: ROIAlign has no kernel of its own.

``roi_pool`` is the max ROI pooling of the reference's ROIPool_cuda.cu
as the JAX package computes it: each bin of the rounded integer grid
takes the max of its pixels, an empty bin 0. Nothing in the JAX package
calls it.
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

# the largest float32 corner tensor (R, Sy, Sx, C) of one chunk of rois
CHUNK_BYTES = 1 << 30
# the span of a pooler call; the benchmark's serve.roi_align_ms reads it
SPAN_ROI_ALIGN = "roi_align/forward"
# the pooler's calls and the rois they pooled, in this process
COUNTS = {"roi_align": 0, "roi_align_rois": 0}


def _count(rois):
    COUNTS["roi_align"] += 1
    COUNTS["roi_align_rois"] += rois.shape[0]


def _constant(values, dtype, dev):
    """``values`` as a tensor on ``dev``, without waiting for the work
    queued there. ``torch.tensor(values, device=dev)`` copies and then
    synchronizes the stream: a host read in the middle of the call. A
    non-blocking copy from pageable memory is staged before it returns,
    so the host tensor may go at once."""
    return torch.tensor(values, dtype=dtype).to(dev, non_blocking=True)


def _axis_samples(start, end, bins, sampling_ratio, size):
    """Sample positions along one axis, per roi, and their bilinear
    terms. start/end/size (R,) float32 -> lo, hi (R, S) int64 indices,
    frac (R, S) and keep (R, S) with S = bins * sampling_ratio."""
    extent = torch.clamp(end - start, min=1.0)
    # The positions round as XLA compiles the JAX package's
    # start + offs * (extent / bins): the division by a constant becomes
    # a product with its float32 reciprocal, and the product and sum one
    # fused multiply-add (exact here in float64, rounded once). An ulp
    # off in a position moves a pooled feature by ~1e-5 through the
    # bilinear weights.
    bin_size = extent * (1.0 / bins)
    s = bins * sampling_ratio
    offs = (torch.arange(s, dtype=torch.float32, device=start.device)
            + 0.5) / sampling_ratio
    pos = (start[:, None].double() + offs[None, :].double()
           * bin_size[:, None].double()).float()
    size = size[:, None]
    keep = (pos >= -1.0) & (pos <= size)
    pos = torch.minimum(torch.clamp(pos, min=0.0), size - 1)
    lo = torch.floor(pos)
    hi = torch.minimum(lo + 1, size - 1)
    # a NaN position (a NaN roi, from a diverged RPN) reads pixel 0 with
    # NaN weights, so its bin is NaN, as XLA's clamped gather gives the
    # JAX package; a NaN index would read outside the table
    return (lo.nan_to_num(0.0).long(), hi.nan_to_num(0.0).long(), pos - lo,
            keep)


def _align(table, row0, height, width, rois, scale, output_size,
           sampling_ratio):
    """ROIAlign of R rois against rows of ``table`` (M, C), the
    channels-last pixels of the maps: roi r samples the (height[r],
    width[r]) map whose pixel (0, 0) is row ``row0[r]``, at coordinates
    ``rois[r] * scale[r]`` (``scale`` a scalar or (R,)). Returns (R, ph,
    pw, C) float32, computed in chunks of rois (``CHUNK_BYTES``)."""
    if sampling_ratio <= 0:
        raise ValueError("adaptive sampling_ratio is not supported; set > 0")
    ph, pw = output_size
    per_roi = ph * pw * sampling_ratio ** 2 * table.shape[1] * 4
    chunk = max(CHUNK_BYTES // per_roi, 1)
    r = rois.shape[0]
    if r <= chunk:
        return _align_chunk(table, row0, height, width, rois, scale,
                            output_size, sampling_ratio)
    scale = scale.expand(r)
    return torch.cat([
        _align_chunk(table, row0[i:i + chunk], height[i:i + chunk],
                     width[i:i + chunk], rois[i:i + chunk],
                     scale[i:i + chunk], output_size, sampling_ratio)
        for i in range(0, r, chunk)])


def _align_chunk(table, row0, height, width, rois, scale, output_size,
                 sampling_ratio):
    ph, pw = output_size
    rois = rois.to(torch.float32)
    height = height.to(torch.float32)
    width = width.to(torch.float32)
    y0, y1, ly, keep_y = _axis_samples(rois[:, 1] * scale, rois[:, 3] * scale,
                                       ph, sampling_ratio, height)
    x0, x1, lx, keep_x = _axis_samples(rois[:, 0] * scale, rois[:, 2] * scale,
                                       pw, sampling_ratio, width)
    w = width.long()[:, None, None]
    base = row0.long()[:, None, None]

    def corner(yy, xx, weight):
        rows = base + yy[:, :, None] * w + xx[:, None, :]  # (R, Sy, Sx)
        return table[rows] * weight[..., None]

    hy, hx = 1 - ly, 1 - lx
    out = (corner(y0, x0, hy[:, :, None] * hx[:, None, :])
           + corner(y0, x1, hy[:, :, None] * lx[:, None, :])
           + corner(y1, x0, ly[:, :, None] * hx[:, None, :])
           + corner(y1, x1, ly[:, :, None] * lx[:, None, :]))
    keep = (keep_y[:, :, None] & keep_x[:, None, :]).to(out.dtype)
    out = out * keep[..., None]
    r, c = out.shape[0], out.shape[-1]
    return out.reshape(r, ph, sampling_ratio, pw, sampling_ratio,
                       c).mean(dim=(2, 4))


def _channels_last_rows(feature):
    b, c, h, w = feature.shape
    return feature.permute(0, 2, 3, 1).reshape(b * h * w, c)


def roi_align(features, rois, roi_batch_idx, output_size=(7, 7),
              spatial_scale=1.0, sampling_ratio=2):
    """Batched ROIAlign on one map.

    features: (B, C, H, W); rois: (R, 4) xyxy in input coordinates;
    roi_batch_idx: (R,) image index per roi. Returns (R, ph, pw, C)
    float32."""
    _count(rois)
    _, _, h, w = features.shape
    r = rois.shape[0]
    dev = features.device
    with record_function(SPAN_ROI_ALIGN):
        return _align(
            _channels_last_rows(features), roi_batch_idx.long() * (h * w),
            torch.full((r,), h, device=dev), torch.full((r,), w, device=dev),
            rois, _constant(spatial_scale, torch.float32, dev),
            output_size, sampling_ratio,
        )


def align_on_own_maps(maps, rois, output_size, sampling_ratio=2):
    """ROIAlign of roi r on its own single-channel map r, at scale 1.

    maps: (R, H, W) float32; rois: (R, 4) xyxy in the maps' pixels.
    Returns (R, ph, pw) float32."""
    r, h, w = maps.shape
    dev = maps.device
    return _align(
        maps.reshape(r * h * w, 1), torch.arange(r, device=dev) * (h * w),
        torch.full((r,), h, device=dev), torch.full((r,), w, device=dev),
        rois, _constant(1.0, torch.float32, dev),
        output_size, sampling_ratio)[..., 0]


def fpn_level_for_rois(rois, k_min=2, k_max=5, canonical_scale=224,
                       canonical_level=4, eps=1e-6):
    """LevelMapper (reference modeling/poolers.py:11-36): the pooler
    level of each roi from its sqrt-area, +1 box convention, counted
    from k_min."""
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    s = torch.sqrt(w * h)
    # s / canonical_scale, as XLA compiles it (see _axis_samples)
    lvl = torch.floor(canonical_level + torch.log2(
        s * (1.0 / canonical_scale) + eps))
    return torch.clamp(lvl, k_min, k_max).long() - k_min


def multilevel_roi_align(features, rois, roi_batch_idx, output_size=(7, 7),
                         scales=(0.25, 0.125, 0.0625, 0.03125),
                         sampling_ratio=2):
    """FPN Pooler (poolers.py:39-124): each roi pools from the level its
    scale selects. The JAX package aligns every roi on every level and
    keeps its own level by a one-hot sum; the other levels' finite
    values are multiplied by 0 there, so aligning each roi on its own
    level alone gives the same numbers with a quarter of the gathers.

    features: one NCHW map per scale, same batch and channels."""
    _count(rois)
    with record_function(SPAN_ROI_ALIGN):
        k_min = int(-math.log2(scales[0]))
        k_max = int(-math.log2(scales[-1]))
        rois = rois.to(torch.float32)
        levels = fpn_level_for_rois(rois, k_min=k_min, k_max=k_max)
        dev = rois.device
        sizes = _constant([tuple(f.shape[2:]) for f in features],
                          torch.int64, dev)
        pixels = sizes[:, 0] * sizes[:, 1]
        offsets = torch.cumsum(pixels * features[0].shape[0], 0) - \
            pixels * features[0].shape[0]
        table = torch.cat([_channels_last_rows(f) for f in features])
        row0 = offsets[levels] + roi_batch_idx.long() * pixels[levels]
        scale = _constant(scales, torch.float32, dev)[levels]
        return _align(table, row0, sizes[levels, 0], sizes[levels, 1],
                      rois, scale, output_size, sampling_ratio)


def roi_pool(features, rois, roi_batch_idx, output_size=(7, 7),
             spatial_scale=1.0):
    """Max ROI pooling. features: (B, C, H, W); rois: (R, 4) xyxy in
    input coordinates; roi_batch_idx: (R,). Returns (R, ph, pw, C), as
    ``roi_align``.

    The roi's corners are rounded to the map's grid (half to even, as
    ``jnp.round``), its extent ``max(end - start + 1, 1)`` cut into
    ph x pw bins; bin (py, px) covers the rows floor(py * bin_h) +
    start_h to ceil((py + 1) * bin_h) + start_h (exclusive), and the
    columns alike, clipped to the map, with py * bin_h rounded as XLA
    compiles the JAX package's (``bounds``). The max is taken over the
    rows, then over the columns (the same max), in chunks of rois whose
    (r, ph, C, H, W) mask stays under ``CHUNK_BYTES``."""
    ph, pw = output_size
    _, c, h, w = features.shape
    dev = features.device
    rois = rois.to(torch.float32)
    start = torch.round(rois * spatial_scale)  # x1, y1, x2, y2

    def bounds(lo, hi, bins, size):
        extent = torch.clamp(hi - lo + 1, min=1.0)[:, None]
        # i * (extent / bins) as XLA compiles it: extent times the
        # float32 product of i and the float32 reciprocal of bins
        recip = torch.tensor(1.0 / bins, dtype=torch.float32, device=dev)
        i = torch.arange(bins + 1, dtype=torch.float32, device=dev) * recip
        first = torch.clamp(torch.floor(extent * i[:-1]) + lo[:, None],
                            0, size)
        last = torch.clamp(torch.ceil(extent * i[1:]) + lo[:, None], 0,
                           size)
        pos = torch.arange(size, dtype=torch.float32, device=dev)
        inside = (pos >= first[..., None]) & (pos < last[..., None])
        return inside, last <= first  # (R, bins, size), (R, bins)

    rows, empty_y = bounds(start[:, 1], start[:, 3], ph, h)
    cols, empty_x = bounds(start[:, 0], start[:, 2], pw, w)
    neg_inf = torch.tensor(float("-inf"), dtype=features.dtype, device=dev)
    chunk = max(CHUNK_BYTES // max(ph * c * h * w * 4, 1), 1)
    outs = []
    for i in range(0, rois.shape[0], chunk):
        feat = features[roi_batch_idx[i:i + chunk].long()]  # (r, C, H, W)
        row_max = torch.where(rows[i:i + chunk, :, None, :, None],
                              feat[:, None], neg_inf).amax(dim=3)
        outs.append(torch.where(cols[i:i + chunk, None, :, None, :],
                                row_max[:, :, None], neg_inf).amax(dim=-1))
    out = (torch.cat(outs) if outs else
           features.new_zeros((0, ph, pw, c)))
    empty = empty_y[:, :, None] | empty_x[:, None, :]
    return torch.where(empty[..., None], torch.zeros((), dtype=out.dtype,
                                                     device=dev), out)

"""Anchor generation (numpy, host side).

The port's own copy of paa_tpu/modeling/anchors.py: the PAA, ATSS and
RetinaNet anchor generators and FCOS's ``LocationGenerator``.
Re-implements the legacy-Detectron anchor math of the reference
(paa_core/modeling/rpn/anchor_generator.py:266-335 ``generate_anchors``
and :73-95 ``grid_anchors``) as host-side numpy precomputation: anchors
depend only on the padded feature-map shapes, so they are computed once
per shape and cached; the detector moves them to the device once.

The golden values in the reference file's comment block
(anchor_generator.py:238-263) are used as unit-test fixtures.
"""

from __future__ import annotations

import numpy as np


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    x_ctr = anchor[0] + 0.5 * (w - 1)
    y_ctr = anchor[1] + 0.5 * (h - 1)
    return w, h, x_ctr, y_ctr


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    size_ratios = size / ratios
    ws = np.round(np.sqrt(size_ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    ws = w * scales
    hs = h * scales
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def generate_cell_anchors(stride=16, sizes=(32, 64, 128, 256, 512),
                          aspect_ratios=(0.5, 1.0, 2.0)):
    """Cell anchors (A, 4) xyxy centered on stride/2, sqrt-areas ~ sizes."""
    scales = np.array(sizes, dtype=np.float64) / stride
    ratios = np.array(aspect_ratios, dtype=np.float64)
    anchor = np.array([1, 1, stride, stride], dtype=np.float64) - 0.5
    anchors = _ratio_enum(anchor, ratios)
    anchors = np.vstack(
        [_scale_enum(anchors[i, :], scales) for i in range(anchors.shape[0])]
    )
    return anchors.astype(np.float32)


def expand_octave_sizes(anchor_sizes, octave, scales_per_octave):
    """Per-level size tuples with octave expansion
    (anchor_generator.py:192-212 make_anchor_generator_paa)."""
    out = []
    for size in anchor_sizes:
        per_level = tuple(
            (octave ** (s / float(scales_per_octave))) * size
            for s in range(scales_per_octave)
        )
        out.append(per_level)
    return tuple(out)


def grid_anchors(grid_size, stride, cell_anchors):
    """Anchors for one feature level: (H*W*A, 4) float32, row-major over
    (y, x, anchor) exactly like the reference (anchor_generator.py:73-95)."""
    grid_height, grid_width = grid_size
    shifts_x = np.arange(0, grid_width * stride, step=stride, dtype=np.float32)
    shifts_y = np.arange(0, grid_height * stride, step=stride, dtype=np.float32)
    shift_x, shift_y = np.meshgrid(shifts_x, shifts_y)
    shift_x = shift_x.reshape(-1)
    shift_y = shift_y.reshape(-1)
    shifts = np.stack((shift_x, shift_y, shift_x, shift_y), axis=1)
    return (
        (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4)
    ).astype(np.float32)


class AnchorGenerator:
    """Precomputes anchors per static padded feature shape.

    Interface is functional: ``__call__(feature_shapes)`` with a tuple of
    (H, W) per level returns the concatenated (sum_l H_l*W_l*A, 4) anchors
    plus per-level counts. Results are cached per shape tuple.
    """

    def __init__(self, sizes, aspect_ratios, strides, straddle_thresh=0):
        assert len(strides) == len(sizes), "FPN needs #strides == #sizes"
        self.strides = tuple(strides)
        self.cell_anchors = [
            generate_cell_anchors(
                stride,
                size if isinstance(size, (tuple, list)) else (size,),
                aspect_ratios,
            )
            for stride, size in zip(strides, sizes)
        ]
        self.straddle_thresh = straddle_thresh
        self._cache = {}
        self._flat_cache = {}

    @property
    def num_anchors_per_location(self):
        return len(self.cell_anchors[0])

    def per_level(self, feature_shapes):
        """List of per-level (H*W*A, 4) numpy anchors."""
        key = tuple(tuple(s) for s in feature_shapes)
        if key not in self._cache:
            self._cache[key] = [
                grid_anchors(gs, stride, cell)
                for gs, stride, cell in zip(
                    feature_shapes, self.strides, self.cell_anchors
                )
            ]
        return self._cache[key]

    def __call__(self, feature_shapes):
        """Concatenated anchors (N, 4) and per-level anchor counts."""
        key = tuple(tuple(s) for s in feature_shapes)
        if key not in self._flat_cache:
            per_level = self.per_level(feature_shapes)
            counts = [a.shape[0] for a in per_level]
            self._flat_cache[key] = (np.concatenate(per_level, axis=0), counts)
        return self._flat_cache[key]


def make_anchor_generator_paa(cfg):
    sizes = expand_octave_sizes(
        cfg.MODEL.PAA.ANCHOR_SIZES, cfg.MODEL.PAA.OCTAVE,
        cfg.MODEL.PAA.SCALES_PER_OCTAVE,
    )
    return AnchorGenerator(
        sizes, cfg.MODEL.PAA.ASPECT_RATIOS, cfg.MODEL.PAA.ANCHOR_STRIDES,
        cfg.MODEL.PAA.STRADDLE_THRESH,
    )


def compute_locations(feature_shapes, strides):
    """Per-level (H*W, 2) float32 centre locations: grid * stride +
    stride // 2 (reference fcos.py compute_locations)."""
    out = []
    for (h, w), stride in zip(feature_shapes, strides):
        sx = np.arange(0, w * stride, stride, dtype=np.float32)
        sy = np.arange(0, h * stride, stride, dtype=np.float32)
        gx, gy = np.meshgrid(sx, sy)
        pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)
        out.append(pts + stride // 2)
    return out


class LocationGenerator:
    """FCOS per-location points with the AnchorGenerator interface: each
    level's (H*W, 2) grid ``* stride + stride // 2`` is tiled to (N, 4)
    (x, y, x, y), so downstream code treats the points as anchors
    (fcos_head.decode_ltrb reads columns 0 and 1)."""

    def __init__(self, strides):
        self.strides = tuple(strides)
        self._cache = {}

    @property
    def num_anchors_per_location(self):
        return 1

    def __call__(self, feature_shapes):
        """Concatenated (N, 4) float32 points and per-level counts."""
        key = tuple(tuple(s) for s in feature_shapes)
        if key not in self._cache:
            per_level = [
                np.concatenate([pts, pts], axis=1).astype(np.float32)
                for pts in compute_locations(feature_shapes, self.strides)
            ]
            counts = [p.shape[0] for p in per_level]
            self._cache[key] = (np.concatenate(per_level, axis=0), counts)
        return self._cache[key]


def make_anchor_generator_atss(cfg):
    sizes = expand_octave_sizes(
        cfg.MODEL.ATSS.ANCHOR_SIZES, cfg.MODEL.ATSS.OCTAVE,
        cfg.MODEL.ATSS.SCALES_PER_OCTAVE,
    )
    return AnchorGenerator(
        sizes, cfg.MODEL.ATSS.ASPECT_RATIOS, cfg.MODEL.ATSS.ANCHOR_STRIDES,
        cfg.MODEL.ATSS.STRADDLE_THRESH,
    )


def make_anchor_generator_retinanet(cfg):
    sizes = expand_octave_sizes(
        cfg.MODEL.RETINANET.ANCHOR_SIZES, cfg.MODEL.RETINANET.OCTAVE,
        cfg.MODEL.RETINANET.SCALES_PER_OCTAVE,
    )
    return AnchorGenerator(
        sizes,
        cfg.MODEL.RETINANET.ASPECT_RATIOS,
        cfg.MODEL.RETINANET.ANCHOR_STRIDES,
        cfg.MODEL.RETINANET.STRADDLE_THRESH,
    )

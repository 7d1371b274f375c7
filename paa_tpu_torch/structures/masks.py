"""Segmentation masks on the host (port of paa_tpu/structures/masks.py).

Each GT instance's COCO polygons are rasterized once, in the frame of
its own box, into a fixed-size "box-normalized" bitmask (112x112); the
train step crops its 28x28 targets from these on the device
(modeling/roi_mask_head.py). At evaluation a predicted 28x28 mask is
resized into its detection box and pasted into the image.

The JAX package calls cv2 for the polygon fill and the float resize.
The card machine has no cv2, so both are written here in numpy:

- ``fill_poly``: ``cv2.fillPoly(mask, polygons, 1)`` with integer
  vertices, shift 0 and 8-connected edges, bit for bit: every edge drawn
  as cv2's 8-connected line (``_line8``, clipped to the image as
  ``cv::clipLine``), then the even-odd scanline fill of cv2's
  FillEdgeCollection over 16.16 fixed-point edges (an edge clipped to
  the image starts at its clipped ends' x).
- ``resize_linear_f32``: ``cv2.resize`` of a float32 image with
  INTER_LINEAR, with cv2's sample positions and weights (positions in
  float64, float32 weights, edge taps clamped; a downscale by exactly 2
  on both axes is the 2x2 mean cv2 takes there). cv2's vectorized sums
  round in another order, so values can differ by a few float32 ulps
  (1.8e-7 at most over tests/test_torch_port_mask.py's sweep): a pasted
  pixel flips only where the value is that close to the threshold.
"""

from __future__ import annotations

import numpy as np

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _clip_line(w, h, x1, y1, x2, y2):
    """cv::clipLine to the (w, h) image: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w, h, x1, y1, x2, y2):
    return 0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h


def _line8(mask, x1, y1, x2, y2):
    """cv2's 8-connected line from (x1, y1) to (x2, y2), drawn left to
    right (LineIterator), clipped to the image."""
    h, w = mask.shape
    if not _inside(w, h, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += step
        else:
            x += 1
            y += sy if step else 0


def _c_div(a, b):
    """Integer division truncating toward zero, as C's."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _fill_edges(mask, edges):
    """cv2's FillEdgeCollection: edges [y0, y1, x (16.16), dx], filled
    even-odd by scanline, each span from the ceiling of its left edge to
    the floor of its right one."""
    h, w = mask.shape
    if len(edges) < 2:
        return
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3]
                                  for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= w << _XY_SHIFT:
        return
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    active, i = [], 0
    for y in range(edges[0][0], min(y_max, h)):
        active = [e for e in active if e[1] != y]
        while i < len(edges) and edges[i][0] == y:
            k = 0
            while k < len(active) and active[k][2] < edges[i][2]:
                k += 1
            active.insert(k, edges[i])
            i += 1
        for a, b in zip(active[0::2], active[1::2]):
            if y >= 0:
                lo, hi = sorted((a[2], b[2]))
                x1 = (lo + _XY_ONE - 1) >> _XY_SHIFT
                x2 = hi >> _XY_SHIFT
                if x1 < w and x2 >= 0:
                    mask[y, max(x1, 0):min(x2, w - 1) + 1] = 1
            a[2] += a[3]
            b[2] += b[3]
        active.sort(key=lambda e: e[2])


def fill_poly(mask, polygons):
    """``cv2.fillPoly(mask, polygons, 1)`` in place: mask (H, W) uint8;
    polygons: (n, 2) integer (x, y) vertex arrays, filled together
    (even-odd) with their outlines."""
    h, w = mask.shape
    edges = []
    for pts in polygons:
        pts = [(int(x), int(y)) for x, y in pts]
        x0, y0 = pts[-1]
        for x1, y1 in pts:
            _line8(mask, x0, y0, x1, y1)
            c0x, c0y, c1x, c1y = x0 << _XY_SHIFT, y0, x1 << _XY_SHIFT, y1
            if not _inside(w, h, x0, y0, x1, y1):
                _, a, b, c, d = _clip_line(w, h, x0, y0, x1, y1)
                c0x, c1x = a << _XY_SHIFT, c << _XY_SHIFT
                if b != d:
                    c0y, c1y = b, d
            if y0 != y1:
                dx = _c_div(c1x - c0x, c1y - c0y)
                if y0 < y1:
                    edges.append([y0, y1, c0x + (y0 - c0y) * dx, dx])
                else:
                    edges.append([y1, y0, c1x + (y1 - c1y) * dx, dx])
            x0, y0 = x1, y1
    _fill_edges(mask, edges)
    return mask


def _rounded_polygons(polygons, transform=None):
    out = []
    for p in polygons:
        if len(p) < 6:
            continue
        arr = np.asarray(p, dtype=np.float64).reshape(-1, 2)
        if transform is not None:
            arr = transform(arr)
        out.append(arr.round().astype(np.int32))
    return out


def polygons_to_bitmask(polygons, height, width):
    """COCO polygons ([x1, y1, x2, y2, ...] lists, those of fewer than
    three points skipped) rasterized into an (height, width) uint8
    mask."""
    return fill_poly(np.zeros((height, width), dtype=np.uint8),
                     _rounded_polygons(polygons))


def box_normalized_mask(polygons, box_xyxy, mask_size=112):
    """An instance's polygons rasterized in the frame of its own box: an
    (mask_size, mask_size) uint8 grid over box_xyxy (+1 width
    convention)."""
    x1, y1, x2, y2 = box_xyxy
    w = max(x2 - x1 + 1.0, 1.0)
    h = max(y2 - y1 + 1.0, 1.0)

    def to_box(arr):
        arr[:, 0] = (arr[:, 0] - x1) / w * mask_size
        arr[:, 1] = (arr[:, 1] - y1) / h * mask_size
        return arr

    return fill_poly(np.zeros((mask_size, mask_size), dtype=np.uint8),
                     _rounded_polygons(polygons, to_box))


def rasterize_instances(polygons_per_instance, boxes_xyxy, max_gt,
                        mask_size=112):
    """(max_gt, mask_size, mask_size) uint8 box-normalized GT masks."""
    out = np.zeros((max_gt, mask_size, mask_size), dtype=np.uint8)
    for i in range(min(len(polygons_per_instance), max_gt)):
        out[i] = box_normalized_mask(polygons_per_instance[i],
                                     boxes_xyxy[i], mask_size)
    return out


def _linear_taps(n_in, n_out):
    """cv2's INTER_LINEAR taps along one axis: (lo, hi, w_lo, w_hi), the
    positions and their fractions in float64, the weights float32;
    positions outside the input take its edge."""
    scale = 1.0 / (n_out / n_in)
    f = (np.arange(n_out) + 0.5) * scale - 0.5
    lo = np.floor(f).astype(np.int64)
    frac = f - lo
    frac[lo < 0] = 0.0
    lo[lo < 0] = 0
    last = lo >= n_in - 1
    frac[last] = 0.0
    lo[last] = n_in - 1
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = frac.astype(np.float32)
    return lo, hi, np.float32(1.0) - w_hi, w_hi


def resize_linear_f32(image, width, height):
    """``cv2.resize(image, (width, height),
    interpolation=cv2.INTER_LINEAR)`` of a float32 (H, W) image."""
    image = np.asarray(image, dtype=np.float32)
    ih, iw = image.shape
    if ih == 2 * height and iw == 2 * width:  # cv2 takes INTER_AREA here
        return (image.reshape(height, 2, width, 2).sum(axis=(1, 3))
                * np.float32(0.25)).astype(np.float32)
    xlo, xhi, xa, xb = _linear_taps(iw, width)
    rows = (image[:, xlo] * xa + image[:, xhi] * xb).astype(np.float64)
    ylo, yhi, ya, yb = _linear_taps(ih, height)
    return (rows[ylo] * ya[:, None] + rows[yhi] * yb[:, None]).astype(
        np.float32)


def paste_mask_in_image(mask, box_xyxy, image_height, image_width,
                        threshold=0.5):
    """Paste an (M, M) float mask predicted in the box's frame into the
    (image_height, image_width) image (reference
    roi_heads/mask_head/inference.py Masker.paste, simplified): resized
    to the rounded box, thresholded at ``threshold`` (None: kept as
    float32), outside the box 0."""
    x1, y1, x2, y2 = (int(round(v)) for v in box_xyxy)
    w = max(x2 - x1 + 1, 1)
    h = max(y2 - y1 + 1, 1)
    resized = resize_linear_f32(mask, w, h)
    if threshold is not None:
        resized = (resized > threshold).astype(np.uint8)
    out = np.zeros((image_height, image_width), dtype=resized.dtype)
    xs1, ys1 = max(x1, 0), max(y1, 0)
    xs2, ys2 = min(x2 + 1, image_width), min(y2 + 1, image_height)
    out[ys1:ys2, xs1:xs2] = resized[ys1 - y1: ys2 - y1, xs1 - x1: xs2 - x1]
    return out

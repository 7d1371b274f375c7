"""Person keypoints as fixed-shape arrays (port of
paa_tpu/structures/keypoints.py; reference
paa_core/structures/keypoint.py and
roi_heads/keypoint_head/inference.py).

Keypoints are (G, K, 3) float32 arrays (x, y, visibility), padded to
MAX_GT by the loader. Beside the constants (names, the left/right swap
of a flip, COCO's OKS sigmas) the module holds what the pipeline does
with them:

- ``resize_keypoints`` and ``flip_keypoints`` (numpy, the loader's
  transforms): a flip swaps left and right and zeroes the invisible
  points, as COCO's convention has it;
- ``keypoints_to_heatmap`` (torch, the keypoint loss): each point's bin
  in its roi's S x S heatmap, with the reference's snap of a point on
  the roi's right or bottom edge into the last bin;
- ``heatmaps_to_keypoints`` (the eval path, on the host): each
  detection's (K, 56, 56) map resized to its box's pixel size with
  cv2's float INTER_CUBIC (``resize_cubic``, computed here without cv2),
  the argmax per keypoint, its pixel centre and its softmax probability.
"""

from __future__ import annotations

import numpy as np
import torch

PERSON_KEYPOINT_NAMES = (
    "nose",
    "left_eye", "right_eye",
    "left_ear", "right_ear",
    "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
    "left_hip", "right_hip",
    "left_knee", "right_knee",
    "left_ankle", "right_ankle",
)

_FLIP_MAP = {
    "left_eye": "right_eye",
    "left_ear": "right_ear",
    "left_shoulder": "right_shoulder",
    "left_elbow": "right_elbow",
    "left_wrist": "right_wrist",
    "left_hip": "right_hip",
    "left_knee": "right_knee",
    "left_ankle": "right_ankle",
}


def _flip_indices():
    full = dict(_FLIP_MAP)
    full.update({v: k for k, v in _FLIP_MAP.items()})
    names = list(PERSON_KEYPOINT_NAMES)
    return np.asarray([names.index(full.get(n, n)) for n in names],
                      dtype=np.int64)


FLIP_INDS = _flip_indices()

# COCO's per-keypoint OKS sigmas (pycocotools cocoeval.py)
OKS_SIGMAS = np.asarray(
    [
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
    dtype=np.float64,
)


def resize_keypoints(kps, ratio_w, ratio_h):
    """Scale (G, K, 3) keypoint coordinates (keypoint.py resize)."""
    out = np.asarray(kps, dtype=np.float32).copy()
    out[..., 0] *= ratio_w
    out[..., 1] *= ratio_h
    return out


def flip_keypoints(kps, width):
    """Horizontal flip of (G, K, 3) keypoints in an image ``width``
    wide: the left/right swap, x -> width - x - 1 (the +1 pixel
    convention), and the invisible points zeroed (keypoint.py
    transpose)."""
    out = np.asarray(kps, dtype=np.float32)[:, FLIP_INDS].copy()
    out[..., 0] = width - out[..., 0] - 1.0
    out[out[..., 2] == 0] = 0.0
    return out


def keypoints_to_heatmap(kps, rois, heatmap_size):
    """Each keypoint's bin in its roi's heatmap (reference keypoint.py
    keypoints_to_heat_map, :154-188).

    kps (R, K, 3), rois (R, 4) xyxy, float32 tensors. Returns lin (R, K)
    int64, the bin y * S + x (0 where invalid), and valid (R, K) int32:
    inside the heatmap and visible. Bins are floor((x - x1) * S /
    (x2 - x1)); a point exactly on x2 (or y2) takes the last bin."""
    s = heatmap_size
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    scale_x = s / (rois[:, 2:3] - x1)
    scale_y = s / (rois[:, 3:4] - y1)
    x, y = kps[..., 0], kps[..., 1]
    xi = torch.floor((x - x1) * scale_x).to(torch.int64)
    yi = torch.floor((y - y1) * scale_y).to(torch.int64)
    xi = torch.where(x == rois[:, 2:3], s - 1, xi)
    yi = torch.where(y == rois[:, 3:4], s - 1, yi)
    valid = (xi >= 0) & (yi >= 0) & (xi < s) & (yi < s) & (kps[..., 2] > 0)
    lin = (yi * s + xi) * valid
    return lin, valid.to(torch.int32)


# cv2's bicubic coefficient (imgproc/resize.cpp interpolateCubic)
_CUBIC_A = -0.75


def _cubic_taps(n_in, n_out):
    """cv2's float INTER_CUBIC taps along one axis: for output d, f =
    float32((d + 0.5) * (1 / (n_out / n_in)) - 0.5), s = floor(f), the
    four source indices s - 1 .. s + 2 clamped into [0, n_in) and the
    float32 weights of interpolateCubic(f - s). Returns (n_out, 4) int64
    indices and (n_out, 4) float32 weights."""
    scale = 1.0 / (n_out / n_in)
    d = torch.arange(n_out, dtype=torch.float64)
    f = ((d + 0.5) * scale - 0.5).to(torch.float32)
    s = torch.floor(f)
    x = f - s
    a = torch.tensor(_CUBIC_A, dtype=torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + 1
    w2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + 1
    w3 = one - w0 - w1 - w2
    idx = s.to(torch.int64)[:, None] + torch.arange(-1, 3)
    return idx.clamp(0, n_in - 1), torch.stack([w0, w1, w2, w3], dim=1)


def resize_cubic(maps, height, width):
    """(K, H, W) float32 maps resized to (K, height, width) with the
    numbers of ``cv2.resize(map_hwk, (width, height),
    interpolation=INTER_CUBIC)`` on the (H, W, K) map, bit for bit:

    - rows first: each output the float32 sum ((s0 a0 + s1 a1) + s2 a2)
      + s3 a3 of its four taps, clamped to the edge (cv2's HResizeCubic);
    - then columns, over each output row's W * K interleaved values:
      ((s3 b3 + s2 b2) + s1 b1) + s0 b0 in cv2's 4-lane vector loop, and
      the scalar ((s0 b0 + s1 b1) + s2 b2) + s3 b3 on the last W * K mod 4
      values of the row (VResizeCubicVec_32f and its tail).

    Equal sizes copy. That holds for K of 2 and from 5 up (the
    keypoint head's 17); for K of 1, 3 or 4 cv2 5.0 takes other code,
    whose values differ from these by up to ~4e-6 of the map's largest
    magnitude."""
    maps = torch.as_tensor(maps, dtype=torch.float32)
    k, h, w = maps.shape
    if (h, w) == (height, width):
        return maps.clone()
    out = maps
    if width != w:
        idx, a = _cubic_taps(w, width)
        out = ((out[:, :, idx[:, 0]] * a[:, 0] + out[:, :, idx[:, 1]]
                * a[:, 1]) + out[:, :, idx[:, 2]] * a[:, 2]) + \
            out[:, :, idx[:, 3]] * a[:, 3]
    if height != h:
        idx, b = _cubic_taps(h, height)
        rows = [out[:, idx[:, j]] for j in range(4)]
        b = b.T[:, None, :, None]
        out = ((rows[3] * b[3] + rows[2] * b[2]) + rows[1] * b[1]) + \
            rows[0] * b[0]
        # the vector loop's tail: the last (width * k) % 4 values of each
        # row, value x * k + c of the (width, k) row
        for flat in range(width * k - (width * k) % 4, width * k):
            x, c = divmod(flat, k)
            out[c, :, x] = ((rows[0][c, :, x] * b[0, 0, :, 0]
                             + rows[1][c, :, x] * b[1, 0, :, 0])
                            + rows[2][c, :, x] * b[2, 0, :, 0]) + \
                rows[3][c, :, x] * b[3, 0, :, 0]
    return out


def heatmaps_to_keypoints(maps, rois):
    """(R, K, S, S) float32 heatmap logits and (R, 4) xyxy boxes ->
    (R, K, 3) float32 keypoints (x, y, score) (reference
    keypoint_head/inference.py heatmaps_to_keypoints): each map resized
    to ceil(max(w, 1)) x ceil(max(h, 1)) of its box by ``resize_cubic``,
    its first argmax (row-major) per keypoint, that pixel's centre
    (+0.5) scaled back by box size / resized size and shifted by the
    box's corner, and the argmax's softmax probability over the map
    (0 when the logit is not finite)."""
    maps = torch.as_tensor(maps, dtype=torch.float32)
    rois = np.asarray(rois, dtype=np.float32)
    r, k = maps.shape[:2]
    out = np.zeros((r, k, 3), dtype=np.float32)
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    for i in range(r):
        w = int(np.ceil(widths[i]))
        h = int(np.ceil(heights[i]))
        flat = resize_cubic(maps[i], h, w).reshape(k, -1)
        pos = flat.argmax(dim=1)
        logit = flat.gather(1, pos[:, None])[:, 0]
        # exp(logit - max) is 1: the probability is 1 / sum(exp(. - max))
        prob = 1.0 / torch.exp(flat - logit[:, None]).sum(dim=1)
        pos = pos.numpy()
        yi, xi = pos // w, pos % w
        out[i, :, 0] = (xi + 0.5) * (widths[i] / w) + rois[i, 0]
        out[i, :, 1] = (yi + 0.5) * (heights[i] / h) + rois[i, 1]
        out[i, :, 2] = np.where(torch.isfinite(logit).numpy(),
                                prob.numpy(), 0)
    return out

"""Run-length-encoded binary masks and mask IoU in numpy (port of
paa_tpu/evaluation/mask_rle.py).

pycocotools is not a dependency; the reference evaluates
instance masks by converting them to COCO RLE and computing RLE IoU
(reference paa_core/data/datasets/evaluation/coco/coco_eval.py:13-67 via
pycocotools.mask). This module reimplements the needed subset:

- ``encode``: HxW uint8 bitmask -> {"size": [h, w], "counts": [...]}
  with column-major (Fortran) run order and the COCO convention that
  counts[0] is the number of leading zeros.
- ``decode``, ``area``, and pairwise ``iou`` with crowd semantics
  (crowd GT -> union = dt area, matching pycocotools maskUtils.iou).
- ``polygons_to_rle``: COCO polygon segmentation -> RLE at (h, w).

IoU works on interval representations (run start/end arrays) with a
vectorized two-pointer sweep — no full-bitmask materialization per pair.
"""

from __future__ import annotations

import numpy as np


def encode(bitmask: np.ndarray) -> dict:
    """HxW {0,1} array -> COCO-style uncompressed RLE dict."""
    h, w = bitmask.shape
    flat = np.asarray(bitmask, dtype=np.uint8).flatten(order="F")
    # run boundaries
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate([[0], diff, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        counts = [0] + counts  # counts[0] is always a zero-run
    if not flat.size:
        counts = [0]
    return {"size": [int(h), int(w)], "counts": counts}


def decode(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in rle["counts"]:
        if val:
            flat[pos: pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def _runs(rle: dict) -> np.ndarray:
    """(R, 2) array of [start, end) intervals of 1s in the flat order."""
    counts = np.asarray(rle["counts"], dtype=np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    # odd count positions are 1-runs (counts[0] is a zero-run)
    return np.stack([starts[1::2], ends[1::2]], axis=1)


def area(rle: dict) -> int:
    counts = rle["counts"]
    return int(sum(counts[1::2]))


def _intersect_area(runs_a: np.ndarray, runs_b: np.ndarray) -> int:
    """Total overlap length of two sorted, disjoint interval sets."""
    if not len(runs_a) or not len(runs_b):
        return 0
    # for each run in a, overlap with runs of b:
    # candidates are b-runs with start < a_end and end > a_start
    starts_b = runs_b[:, 0]
    ends_b = runs_b[:, 1]
    lo = np.searchsorted(ends_b, runs_a[:, 0], side="right")
    hi = np.searchsorted(starts_b, runs_a[:, 1], side="left")
    total = 0
    for (a0, a1), l, h in zip(runs_a, lo, hi):
        if h > l:
            s = np.maximum(starts_b[l:h], a0)
            e = np.minimum(ends_b[l:h], a1)
            total += int(np.clip(e - s, 0, None).sum())
    return total


def iou(dt_rles, gt_rles, iscrowd) -> np.ndarray:
    """Pairwise mask IoU (n_dt, n_gt); crowd GT uses union = dt area."""
    n_d, n_g = len(dt_rles), len(gt_rles)
    out = np.zeros((n_d, n_g))
    d_runs = [_runs(r) for r in dt_rles]
    g_runs = [_runs(r) for r in gt_rles]
    d_area = [area(r) for r in dt_rles]
    g_area = [area(r) for r in gt_rles]
    for j in range(n_g):
        for i in range(n_d):
            inter = _intersect_area(d_runs[i], g_runs[j])
            union = (
                d_area[i]
                if iscrowd[j]
                else d_area[i] + g_area[j] - inter
            )
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def polygons_to_rle(segmentation, h: int, w: int) -> dict:
    """COCO polygon list (or already-RLE dict) -> RLE at (h, w)."""
    if isinstance(segmentation, dict):  # already RLE (uncompressed)
        counts = segmentation["counts"]
        if isinstance(counts, list):
            return {"size": segmentation["size"], "counts": list(counts)}
        raise ValueError("compressed RLE strings are not supported")
    from ..structures.masks import polygons_to_bitmask

    return encode(polygons_to_bitmask(segmentation, h, w))

"""The comparisons that decide ``correct``. Each returns numbers; the
cell's limits file (``limits/<cell>.json``) gives each number its limit,
and a number above its limit makes the run incorrect. A cell's family
(``families/<family>.py``) chooses the comparisons; the PAA family's:

Serving:
- ``head_gap``: for each head output (cls_logits, box_regression,
  iou_pred) and FPN level, the root-mean-square of the program's minus
  the reference's values over their standard deviation in the
  reference; the worst of them;
- ``det_mismatch``: detection slots of any window call whose validity
  or label differs from the reference's post-processing of the
  program's own head outputs; ``det_box_gap_px`` and ``det_score_gap``:
  the largest difference of a valid slot's box coordinate (pixels) and
  score.

Training (the first steps of the one train state that the window then
drives):
- ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss terms and total;
- ``num_pos_gap``: the same for the number of positives (the GMM's
  assignment); ``num_pos_gap_first``: the first step's alone (the
  later steps start from the program's own, not bit-reproducible,
  update);
- ``grad_gap``, ``change_gap``: per trainable tensor, the gap between
  the program's and the reference's norm of the first gradient (as the
  optimizer got it), and of the change of the parameters over the
  steps, over the larger of the reference's norm of that tensor and of
  the median tensor; the worst tensor. ``grad_gap_median``,
  ``change_gap_median``: the median tensor's gap. A tensor whose
  reference gradient norm is under a thousandth of the median tensor's
  is left out (it moves by round-off alone).

A cell's limits file names the numbers it compares; the others are
printed on an earlier line.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and cuDNN convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class HeadGap:
    """Accumulates rms(p - r) / std(r) per (output, level)."""

    def __init__(self, keys, levels):
        self.acc = {(k, l): [0.0, 0.0, 0.0, 0] for k in keys
                    for l in range(levels)}

    def add(self, key, level, p, r):
        p, r = p.double(), r.double()
        a = self.acc[(key, level)]
        a[0] += float(((p - r) ** 2).sum())
        a[1] += float(r.sum())
        a[2] += float((r * r).sum())
        a[3] += r.numel()

    def values(self):
        out = {}
        for (k, l), (se, s, ss, n) in self.acc.items():
            var = max(ss / n - (s / n) ** 2, 1e-30)
            out[f"{k}.P{l + 3}"] = math.sqrt(se / n / var)
        return out

    def worst(self):
        return max(self.values().values())


def detections_gap(ref_dets, calls, outputs, limits):
    """Every window call's detections against the reference's for its
    pool batch. Returns ({det_mismatch, det_box_gap_px, det_score_gap},
    number of calls that fail the limits)."""
    mismatch, box_gap, score_gap, failed = 0, 0.0, 0.0, 0
    for k, out in zip(calls, outputs):
        r = ref_dets[k]
        both = out["valid"] & r["valid"]
        bad = int((out["valid"] != r["valid"]).sum()
                  + ((out["labels"] != r["labels"]) & both).sum())
        bg = float((out["boxes"] - r["boxes"]).abs().amax(-1)[both].max()) \
            if both.any() else 0.0
        sg = float((out["scores"] - r["scores"]).abs()[both].max()) \
            if both.any() else 0.0
        mismatch += bad
        box_gap, score_gap = max(box_gap, bg), max(score_gap, sg)
        one = {"det_mismatch": bad, "det_box_gap_px": bg,
               "det_score_gap": sg}
        if any(one[n] > limits[n] for n in one if n in limits):
            failed += 1
    return ({"det_mismatch": mismatch, "det_box_gap_px": box_gap,
             "det_score_gap": score_gap}, failed)


def rel_gap(p, r):
    return abs(p - r) / max(abs(r), 1e-12)


def norm_gaps(prog_norms, ref_norms, ref_grad_norms):
    """Per-tensor gaps of two {name: norm} dicts, each over the larger of
    the reference's norm and the median tensor's; tensors whose
    reference gradient is under a thousandth of the median tensor's
    gradient are left out. Returns (worst gap, its tensor, the median
    tensor's gap, the tensors left out)."""
    med_g = sorted(ref_grad_norms.values())[len(ref_grad_norms) // 2]
    kept = [n for n in ref_norms if ref_grad_norms[n] >= 1e-3 * med_g]
    med = sorted(ref_norms[n] for n in kept)[len(kept) // 2]
    gaps = sorted((abs(prog_norms[n] - ref_norms[n])
                   / max(ref_norms[n], med, 1e-30), n) for n in kept)
    return (gaps[-1][0], gaps[-1][1], gaps[len(gaps) // 2][0],
            sorted(set(ref_norms) - set(kept)))


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers the limits
    file names (a cell compares those; the others are only printed). A
    named number that the run did not give, or a NaN, is incorrect; so
    is an empty limits file."""
    rows, ok = [], bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, limit))
        if not value <= limit:
            ok = False
    return ok, rows

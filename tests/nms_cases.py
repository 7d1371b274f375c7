"""Inputs of the NMS tests, made with numpy from fixed seeds: random
batches and the edges of K1's sort and tile sweep (csrc/nms_batched.cu).
The CPU tests against the JAX package (test_torch_port_nms.py), the
card's tests (test_torch_port_cuda.py) and chip_smoke.py build their
cases here, so that a fix to a case reaches all three. Imports only
numpy.
"""

import numpy as np

# Equal top scores at 70 indices: sorted positions 0-69, three of K1's
# sweep tiles of 32. Boxes that do not overlap, except copies (position
# in TIED) of the box just before each tile boundary and of one inside a
# tile: (copy, original).
TIED = np.arange(3, 143, 2)
TIED_DUPLICATES = ((32, 31), (64, 63), (40, 35))

EDGES = ("ties_across_tiles", "max_out_below_survivors",
         "max_out_above_valid", "one_box_suppresses_all", "class_agnostic",
         "low_and_infinite_scores", "n1", "thresh_zero", "thresh_negative",
         "paa", "rpn")


def random_case(seed, bsz, n, n_labels=5):
    """Random boxes with exact score ties, one all-invalid row (row 1),
    and duplicate boxes (IoU exactly 1): boxes, scores, labels, valid."""
    rng = np.random.RandomState(seed)
    boxes = rng.uniform(0, 200, (bsz, n, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 80, (bsz, n, 2))
    boxes[:, 1] = boxes[:, 0]
    scores = rng.uniform(0, 1, (bsz, n)).astype(np.float32)
    scores[:, 10:40] = scores[:, 5:6]  # exact ties, some suppress others
    labels = rng.randint(0, n_labels, (bsz, n)).astype(np.int32)
    valid = rng.rand(bsz, n) > 0.2
    if bsz > 1:
        valid[1] = False
    return boxes, scores, labels, valid


def spread(n):
    """n boxes on a grid that do not overlap."""
    i = np.arange(n)
    xy = np.stack([i % 40 * 30.0, i // 40 * 30.0], -1)
    return np.concatenate([xy, xy + 20.0], -1).astype(np.float32)


def with_ties(boxes, scores, labels, valid):
    """Put TIED's equal top scores, label 1, into every row, in place.
    Greedy NMS at IoU 0.5 picks them first, in index order, and drops
    the copies: ``tied_picks()``."""
    boxes[:, TIED] = spread(len(TIED))
    for copy, orig in TIED_DUPLICATES:
        boxes[:, TIED[copy]] = boxes[:, TIED[orig]]
    scores[:, TIED] = 2.0
    labels[:, TIED] = 1
    valid[:, TIED] = True


def tied_picks():
    return np.delete(TIED, [c for c, _ in TIED_DUPLICATES])


def main_path_rows(name, rows):
    """Rows shaped like a main path's K1 input: "paa", N=5000 per image
    over 80 labels, 100 picks at IoU 0.6, class-aware; or "rpn", N=1000
    proposals per row sorted by score, the last fifth of the rows (the
    smallest level) 819 long, 1,000 picks at IoU 0.7, class-agnostic."""
    rng = np.random.RandomState(len(name))
    n = 5000 if name == "paa" else 1000
    c = rng.uniform(0, 1200, (rows, n, 2))
    wh = rng.choice([32.0, 64.0, 128.0, 256.0], (rows, n, 1)) * \
        rng.uniform(0.7, 1.4, (rows, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1, (rows, n)).astype(np.float32)
    labels = rng.randint(1, 81, (rows, n)).astype(np.int32)
    valid = rng.rand(rows, n) > 0.05
    if name == "paa":
        return (boxes, scores, labels, valid), 0.6, 100, True
    scores = -np.sort(-scores)  # rows arrive sorted
    labels[:] = 0
    valid[:] = True
    valid[-max(1, rows // 5):, 819:] = False
    return (boxes, scores, labels, valid), 0.7, 1000, False


def edge_case(name, rows=None):
    """(boxes, scores, labels, valid), thresh, max_out, class_aware of
    one edge of EDGES. ``rows`` sets the batch of the main-path shapes
    (default: the path's own, PAA 8 and the RPN 40)."""
    if name in ("paa", "rpn"):
        return main_path_rows(name, rows or (8 if name == "paa" else 40))
    if name == "ties_across_tiles":
        boxes, scores, labels, valid = random_case(31, 2, 200)
        valid[1] = True
        with_ties(boxes, scores, labels, valid)
        return (boxes, scores, labels, valid), 0.5, 100, True
    if name == "max_out_below_survivors":
        return random_case(32, 3, 300), 0.6, 5, True
    if name == "max_out_above_valid":
        args = random_case(33, 2, 40)
        args[3][0] = np.arange(40) % 5 == 0
        return args, 0.6, 64, True
    if name == "one_box_suppresses_all":
        boxes, scores, labels, valid = random_case(34, 2, 150)
        boxes[:] = boxes[:, :1]
        return (boxes, scores, labels, valid), 0.6, 100, False
    if name == "class_agnostic":
        return random_case(35, 3, 500), 0.5, 200, False
    if name == "low_and_infinite_scores":
        boxes, scores, labels, valid = random_case(36, 2, 120)
        valid[1] = True
        boxes[:] = spread(120)
        special = [-6e29, -5e29, -1e30, -np.inf, np.inf, np.inf, -0.0, 0.0,
                   -2e30]
        for row in range(2):
            at = np.random.RandomState(row).choice(120, len(special), False)
            scores[row, at] = special
            valid[row, at] = True
        return (boxes, scores, labels, valid), 0.6, 100, True
    if name == "n1":
        boxes = np.asarray([[[1, 2, 30, 40]], [[5, 5, 9, 9]]], np.float32)
        scores = np.asarray([[0.3], [-0.5]], np.float32)
        return ((boxes, scores, np.ones((2, 1), np.int32),
                 np.ones((2, 1), bool)), 0.6, 4, True)
    if name in ("thresh_zero", "thresh_negative"):
        # K1 skips the IoU of boxes that do not overlap only for
        # thresholds >= 0; the boxes of the last row touch exactly
        # (x2 + 1 == the next x1: zero intersection)
        boxes, scores, labels, valid = random_case(37, 3, 300)
        x = np.arange(300, dtype=np.float32) * 21.0
        boxes[-1] = np.stack([x, x * 0, x + 20.0, x * 0 + 20.0], -1)
        thresh = 0.0 if name == "thresh_zero" else -0.25
        return (boxes, scores, labels, valid), thresh, 100, True
    raise KeyError(name)

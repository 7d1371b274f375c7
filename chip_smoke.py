#!/usr/bin/env python3
"""Drive the PyTorch port (paa_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Build the CUDA kernels from paa_tpu_torch/csrc (one nvcc per source,
   in parallel, sm_90a): K1 nms_batched.cu, K2 nms_global.cu, K3
   group_norm.cu.
2. K1, the batched NMS kernel, against its plain PyTorch version on the
   card: B=8, N=5000 and 77, max_out=100, IoU 0.6, class-aware and
   class-agnostic, with exact score ties and all-invalid rows; the RPN's
   shape (40 rows of N=1000, max_out 1000, class-agnostic, IoU 0.7);
   equal top scores over three of K1's sweep tiles, with duplicate boxes
   across both tile boundaries; and a row with a valid NaN score (no
   picks). keep_idx and keep_valid equal, keep_scores bit-equal.
3. K2, the NMS kernel for any N, against its plain version: B=8 at
   N=80,000, at K1's capacity + 1 (through ``nms_batched``, which must
   route there) and at N=300; the single-image ``nms`` at N=80,000;
   max_out 100 and 1000; class-aware and agnostic; exact score ties and
   an all-invalid row. Then each route of K2 (clusters of 1, 2 and 16
   CTAs, and the scratch kernel above 16 CTAs' capacity), score ties on
   both sides of every boundary between CTA ranges, every valid
   candidate in one CTA's range, fewer valid candidates than max_out,
   and an all-invalid image. All three outputs bit-equal.
4. K3, the GroupNorm+ReLU kernel, against its plain version at the five
   tower shapes of an 8 x 800 x 1344 batch, at shapes whose launch takes
   each cluster size from 1 to 4, 8 and 16 and the streaming
   instantiation, and with groups that start off 16-byte boundaries: float32 (TF32 off) within 1e-5, bfloat16 within one bf16
   ulp (plus 1e-6 near zero).
5. The PAA main path: PAA-R50 (configs/paa/paa_R_50_FPN_1x.yaml, full
   width, 80 classes) in bfloat16 with weights from a seed serves three
   requests of 8 x 800 x 1344 uint8 images through ``make_eval_fn``.
   Checks shapes, finiteness, boxes inside the image, detections > 0, and
   the launch counts of the run (K1 once and K3 40 times per request).
6. The same model in float32 on the card (TF32 off) against the same
   model on the CPU, whose wrappers take the plain versions, at a small
   input: head outputs and detections agree.
7. The Faster R-CNN main path: configs/e2e_faster_rcnn_R_50_FPN_1x.yaml
   at full width (256 FPN channels, 81 classes, MLP 1024, RPN
   1000/1000/1000) in bfloat16, weights from seed 0 and the foreground
   cls_score bias from seed 1, serves three 8 x 800 x 1344 requests.
   Same checks, labels in 1..80, and the launch counts of the run (K1
   once for the RPN and K2 once for the box head per request).
8. The Faster R-CNN in float32 on the card against the CPU at a small
   input, as phase 6.
9. Timing on the card (CUDA events): end-to-end img/s of each path, and
   per forward each kernel's time at the path's own inputs beside its
   plain version's, its bound and, where one PyTorch call computes the
   same function, that call's time; for K1 the tiles its sweep ran and
   the most picks in a row; for K2 and K3 the cluster size chosen and
   cudaOccupancyMaxActiveClusters for it.
10. A torch.profiler window of three requests of each path: device time
    per request by kernel class (the Faster R-CNN box head's kernels by
    a span around ``module.box``), and the device's idle share.
11. Training, K3's gradient: the autograd Function around K3 (forward
    K3, backward the VJP of the plain version, recomputed) against
    autograd through the plain version at the towers' shapes of a
    16 x 800 x 1344 batch, float32 and bfloat16: forward within K3's
    tolerances, gradients of x, weight and bias equal.
12. The training main path: PAA-R50 at full width in bfloat16 (params
    and losses float32), weights from seed 0, through
    ``make_bucket_train_step`` and ``do_train``: 10 SGD steps (the
    config's lr 0.01, constant warmup 1/3, weight decay 1e-4, momentum
    0.9) on one batch of 16 uint8 images of 800 x 1344 (content
    800 x 1333) with 100 GT slots, 3-12 valid per image. Every loss
    finite, num_pos > 0, the last step's loss below the first's, K3
    launched 40 times per step and no NMS; peak device memory.
13. One training step in float32 (TF32 off) on the card and on the CPU
    at 2 x 256 x 320 from the same weights and batch: losses, num_pos,
    the positive mask and the updated parameters agree; the same step
    on the card with a fault planted in K3's gradient does not.
14. Timing and a profile of the train step: step ms and img/s (CUDA
    events after 2 warm-up steps); torch.profiler over three
    steps with device busy, wall and idle share per span (forward,
    assignment, losses, backward, K3's backward recompute, optimizer).

15. (Run after phase 8.) PAA-R50 COCO-style evaluation, dataset to AP
    table, at full width: 32 PPM images at COCO's common sizes (written
    to a temporary directory, 3-12 boxes each over the 80 sparse
    category ids) through the port's ``inference``: the bucketed loader
    (800 x 1333 in (800, 1344) / (1344, 800), raw uint8 batches of 8,
    short tails padded with image_id -1), make_eval_fn in bfloat16 with
    the serving cell's seeded weights and cls bias (K3 40 and K1 once
    per batch), the COCO evaluator, coco_results.json and bbox.json.
    Checks the launch counts of the run, the 12 metrics, a detection
    for every real image and none for padding; prints the loader's,
    the model calls' and the end-to-end img/s, the device's idle share
    inside the model calls (torch.profiler) and the AP table (random
    weights: not an accuracy).
16. The same eval path in float32 (TF32 off) on the card and on the CPU
    from the same weights: four PPM images at MIN_SIZE_TEST 256 in the
    buckets (256, 320) / (320, 256), against ground truth made of the
    CPU's five best detections per image on a first pass. Detections
    matched as in phase 6, the 12 metrics within 1e-3.

Phase 13 also runs the step a third time on the CPU with the network in
float64 (every convolution, FrozenBN and GroupNorm), the referee of the
two float32 steps, and phase 11 checks K3's Function at a group of zero
variance with a zero bias (the ReLU input exactly 0: half the upstream
gradient, as the JAX package's custom VJP gives).

The line before the last is the ``kernels`` JSON; the card's name and
power limit (nvidia-smi) come on a line before it; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits with 2.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH, HW, SIZE = 8, (800, 1344), (800.0, 1333.0)
# training: SOLVER.IMS_PER_BATCH images, GT slots, steps of the main path
TRAIN_BATCH, MAX_GT, TRAIN_STEPS = 16, 100, 10
TOWER_HW = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
SLEEP_CYCLES = 35_000_000  # ~20 ms at the H100's 1.755 GHz boost clock
GN_PER_LEVEL = 8  # 2 towers x 4 GroupNorm+ReLU
ROOT = os.path.dirname(os.path.abspath(__file__))
PAA_CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
FRCNN_CONFIG = os.path.join(ROOT, "configs",
                            "e2e_faster_rcnn_R_50_FPN_1x.yaml")
# an IoU and its compare: 2 x (min, max, sub, add, max), mul, add, sub,
# div, compare; and a label compare
NMS_IOU_OPS, NMS_LABEL_OPS = 15, 1
# bytes read of every candidate (score, valid), of a valid one besides
# (box, label), and written per output slot (idx, score, valid)
NMS_BYTES_ALL, NMS_BYTES_VALID, NMS_BYTES_OUT = 4 + 1, 16 + 4, 4 + 4 + 1
# the COCO evaluator's 12 bbox metrics
METRICS = ("AP", "AP50", "AP75", "APs", "APm", "APl",
           "AR1", "AR10", "AR100", "ARs", "ARm", "ARl")


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Device ms per call of ``fn`` over ``reps`` calls. Where ``fn``
    waits for the device itself, its waits count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # queue the calls behind a device-side sleep (~20 ms), so that the
    # host's launch time between them does not show in the device's time
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nms_case(seed, bsz, n, dev):
    """Boxes over an 800 x 1333 image with heavy overlap, exact score
    ties and one all-invalid row (the last)."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 1200, (bsz, n, 2))
    wh = rng.uniform(8, 300, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=2).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]
    scores = rng.uniform(0.05, 1.0, (bsz, n)).astype(np.float32)
    scores[:, 100:400] = scores[:, 50:51]
    labels = rng.randint(1, 81, (bsz, n)).astype(np.int32)
    valid = rng.rand(bsz, n) > 0.1
    valid[-1] = False
    return [torch.from_numpy(a).to(dev) for a in (boxes, scores, labels,
                                                  valid)]


def same_keeps(got, want, what):
    for g, w, name in zip(got, want, ("keep_idx", "keep_scores",
                                     "keep_valid")):
        check(g.dtype == w.dtype and torch.equal(g, w),
              f"{what}: kernel != plain in {name}")


def nms_bound(args, got, real_n=None):
    """Least time for the NMS of this input, and the IoUs it needs.
    Greedy's i-th pick is the i-th live candidate (valid, score > -5e29)
    in (score desc, index asc) order that no earlier pick suppresses, so
    the function needs no argmax: only, for each live candidate up to
    the last pick of a row that fills max_out (every live candidate of a
    row that ends short of it), a test against each kept box ranked
    ahead of it: a label compare when class-aware, and an IoU for the
    same label. A row with a valid NaN score needs none. Ops against the
    f32 peak. Bytes against HBM: every real candidate's score and valid
    flag, the box and label of the valid ones, the outputs. ``real_n``
    (per row) leaves out padding added to a row; invalid, it adds no
    operations."""
    _, scores, labels, valid, _, max_out, aware = args
    bsz, n = scores.shape
    live = (valid & (scores > -5e29)
            & ~(valid & scores.isnan()).any(dim=1, keepdim=True))
    order = torch.where(live, scores, float("-inf")).sort(
        dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=scores.device).expand(bsz, n))
    pairs = ious = 0
    for b in range(bsz):
        kept = got[0][b][got[2][b]].long()
        kept_rank = rank[b, kept]
        last = kept_rank[-1] if len(kept) == max_out else n
        cand = live[b] & (rank[b] <= last)
        ahead = kept_rank[None, :] < rank[b][cand][:, None]
        pairs += int(ahead.sum())
        if aware:
            ahead &= labels[b][cand][:, None] == labels[b, kept][None, :]
        ious += int(ahead.sum())
    if real_n is None:
        real_n = [n] * bsz
    nbytes = (sum(real_n) * NMS_BYTES_ALL + int(valid.sum()) * NMS_BYTES_VALID
              + bsz * max_out * NMS_BYTES_OUT)
    ops = ious * NMS_IOU_OPS + (pairs * NMS_LABEL_OPS if aware else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations"), ious


def rpn_case(seed, dev, rows=5 * BATCH, n=1000):
    """Rows shaped like the RPN's: five levels of BATCH images, N=1000
    proposals per row sorted by objectness, the smallest level's rows
    819 long (13 x 21 x 3 anchors at 800 x 1344), one label."""
    boxes, scores, _, _ = nms_case(seed, rows, n, dev)
    scores = scores.sort(dim=1, descending=True).values
    valid = torch.ones(rows, n, dtype=torch.bool, device=dev)
    valid[-BATCH:, 819:] = False
    return [boxes, scores, torch.zeros_like(valid, dtype=torch.int32),
            valid]


def shared_cases():
    """tests/nms_cases.py: the NMS inputs this script shares with the
    tests (numpy only)."""
    path = os.path.join(ROOT, "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    import nms_cases

    return nms_cases


def tie_case(dev):
    """Equal top scores over three of K1's sweep tiles, with copies of
    boxes across both tile boundaries (tests/nms_cases.py): the picks
    must take them in index order and drop the copies."""
    args = nms_case(9, BATCH, 300, "cpu")
    shared_cases().with_ties(*(a.numpy() for a in args))
    return [a.to(dev) for a in args]


def phase_nms(dev):
    from paa_tpu_torch.ops import nms

    cases = [(f"N={n} class_aware={aware}", nms_case(n, BATCH, n, dev),
              0.6, 100, aware) for n in (5000, 77) for aware in (True, False)]
    cases.append(("RPN rows 40x1000 max_out=1000 agnostic IoU 0.7",
                  rpn_case(11, dev), 0.7, 1000, False))
    cases.append(("equal top scores over three tiles", tie_case(dev), 0.5,
                  100, True))
    nan = nms_case(13, BATCH, 5000, dev)
    nan[1][2, 4321], nan[3][2, 4321] = float("nan"), True
    cases.append(("a valid NaN score in row 2", nan, 0.6, 100, True))
    for what, args, thresh, max_out, aware in cases:
        before = nms.nms_batched.launches
        got = nms.nms_batched(*args, thresh, max_out, aware)
        check(nms.nms_batched.launches == before + 1,
              f"nms_batched {what}: K1 not launched once")
        same_keeps(got, nms.nms_batched_plain(*args, thresh, max_out, aware),
                   f"nms_batched {what}")
        # picks in every row with a valid score, unless one is NaN
        rows = got[2].any(dim=1).tolist()
        valid = args[3]
        expect = (valid.any(dim=1)
                  & ~(valid & args[1].isnan()).any(dim=1)).tolist()
        check(rows == expect,
              f"nms_batched {what}: rows with picks {rows}, not {expect}")
        if what.startswith("equal"):
            keep = shared_cases().tied_picks().tolist()
            check(got[0][0, :len(keep)].tolist() == keep,
                  f"nms_batched {what}: picks {got[0][0, :8].tolist()}")
    print(json.dumps({"phase": "nms_vs_plain", "ok": True,
                      "cases": [c[0] for c in cases]}))


def phase_nms_global(dev):
    """K2 against its plain version through ``_nms_global`` (the batched
    dispatch), ``nms_batched`` above K1's capacity and ``nms``."""
    from paa_tpu_torch.ops import nms

    limit = nms.k1_max_candidates(dev)
    cases = [  # (entry point, N, max_out, class_aware)
        ("_nms_global", 80000, 100, True),
        ("_nms_global", 80000, 100, False),
        ("_nms_global", 80000, 1000, True),
        ("nms_batched", limit + 1, 100, True),
        ("nms_batched", limit + 1, 1000, False),
        ("_nms_global", 300, 100, True), ("_nms_global", 300, 1000, False),
        ("nms", 80000, 100, True), ("nms", 80000, 1000, False),
    ]
    done = []
    for entry, n, max_out, aware in cases:
        what = f"{entry} N={n} max_out={max_out} class_aware={aware}"
        args = nms_case(n + max_out, BATCH, n, dev)
        before = (nms.nms_batched.launches, nms._nms_global.launches)
        if entry == "nms":  # one image: the first row
            got = [t[None] for t in nms.nms(*(a[0] for a in args), 0.5,
                                            max_out, aware)]
            args = [a[:1] for a in args]
        else:
            got = getattr(nms, entry)(*args, 0.5, max_out, aware)
        after = (nms.nms_batched.launches, nms._nms_global.launches)
        check(after == (before[0], before[1] + 1),
              f"{what}: launches K1/K2 went {before} -> {after}, "
              "expected K2 once")
        same_keeps(got, nms.nms_batched_plain(*args, 0.5, max_out, aware),
                   what)
        check(bool(got[2][0].any()), f"{what}: no picks in row 0")
        if entry != "nms":
            check(not bool(got[2][-1].any()),
                  f"{what}: picks in the all-invalid row")
        done.append(what)
    done += k2_route_cases(dev)
    print(json.dumps({"phase": "nms_global_vs_plain", "ok": True,
                      "k1_capacity": limit,
                      "k2_cluster_capacity": nms.k2_capacity(dev),
                      "B": BATCH, "cases": done}))


def _only_valid(args, idx):
    valid = torch.zeros_like(args[3])
    valid[:, torch.as_tensor(list(idx), dtype=torch.long,
                             device=valid.device)] = True
    return args[:3] + [valid]


def k2_route_cases(dev):
    """K2's routes and the cluster route's edges, each against the plain
    version through ``_nms_global``."""
    from paa_tpu_torch.ops import nms

    cap = nms.k2_capacity(dev)
    n = 80000
    chunk = -(-n // nms.k2_plan(n, cap)[1])
    cases = [(f"route N={m}", m, lambda a: a, 100, ("cluster", cs))
             for m, cs in ((cap, 1), (cap + 1, 2), (16 * cap, 16))]
    cases.append((f"route N={16 * cap + 1}", 16 * cap + 1, lambda a: a,
                   100, ("scratch", 1)))

    def ties(a):  # equal top scores either side of each range boundary
        edges = [r * chunk + d for r in range(1, n // chunk + 1)
                 for d in (-1, 0) if r * chunk + d < n]
        for i, j in enumerate(edges):
            a[0][:, j] = torch.tensor([1e4 * i, 0.0, 1e4 * i + 5, 5.0])
        a[1][:, edges] = 2.0
        a[3][:] = True
        return a

    cases += [
        ("ties across CTA ranges, all valid", n, ties, 100, None),
        ("all valid in one CTA's range", n,
         lambda a: _only_valid(a, range(5 * chunk, 5 * chunk + 900)), 100,
         None),
        ("50 valid, max_out 100", n,
         lambda a: _only_valid(a, range(7, n, n // 50)), 100, None),
        ("all-invalid images", n, lambda a: _only_valid(a, []), 100, None),
    ]
    done = []
    for what, m, prep, max_out, route in cases:
        if route is not None:
            check(nms.k2_plan(m, cap) == route,
                  f"K2 {what}: route {nms.k2_plan(m, cap)}, not {route}")
        args = prep(nms_case(m, BATCH, m, dev))
        before = nms._nms_global.launches
        got = nms._nms_global(*args, 0.5, max_out, True)
        check(nms._nms_global.launches == before + 1,
              f"K2 {what}: not launched once")
        same_keeps(got, nms.nms_batched_plain(*args, 0.5, max_out, True),
                   f"K2 {what}")
        if what.startswith("ties"):
            check(got[0][0, :2].tolist() == [chunk - 1, chunk],
                  f"K2 {what}: first picks {got[0][0, :4].tolist()}")
        done.append(f"K2 {what} ({nms.k2_plan(m, cap)})")
    return done


def _bf16_ulp(x):
    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


# K3 shapes beyond the towers (B, C, H, W): with them the launch takes
# every cluster size from 1 to 4, 8 and 16, the streaming instantiation
# (a group beyond 16 CTAs' share), one channel of 8 positions per group,
# and groups off 16-byte boundaries (C=64 in 32 groups at odd H*W, once
# with cs 3)
GN_EXTRA_SHAPES = [
    (2, 256, 48, 48), (1, 256, 72, 96), (1, 256, 192, 192),
    (1, 256, 200, 200), (1, 32, 2, 4), (3, 64, 5, 7), (1, 64, 101, 199),
]


def phase_group_norm(dev):
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False  # f32 compare: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    worst, plans = {}, set()
    shapes = [(BATCH, 256, h, w) for h, w in TOWER_HW] + GN_EXTRA_SHAPES
    for shape in shapes:
        bsz, c, h, w = shape
        what = "x".join(map(str, shape))
        x = (torch.randn(*shape, generator=gen) * 1.5 + 0.4).to(dev)
        s = (torch.rand(c, generator=gen) + 0.5).to(dev)
        b = (torch.randn(c, generator=gen) * 0.2).to(dev)
        got = gn.group_norm_relu(x, s, b)
        err32 = float((got - gn.group_norm_relu_plain(x, s, b)).abs().max())
        check(err32 <= 1e-5, f"group_norm_relu f32 {what}: err {err32}")
        xb = x.to(torch.bfloat16)
        got = gn.group_norm_relu(xb, s, b).float()
        want = gn.group_norm_relu_plain(xb, s, b).float()
        err = (got - want).abs()
        ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
        check(bool((err <= ulp + 1e-6).all()),
              f"group_norm_relu bf16 {what}: beyond one ulp, max err "
              f"{float(err.max())}")
        worst[what] = {"f32": err32, "bf16": float(err.max())}
        for size in (4, 2):
            p = gn.gn_plan(bsz, c, h * w, 32, size)
            plans.add((p.cs, p.resident))
    cs_seen = sorted({p[0] for p in plans if p[1]})
    check(set(range(1, 5)) | {8, 16} <= set(cs_seen)
          and any(not p[1] for p in plans),
          f"group_norm_relu: launches covered {sorted(plans)}")
    print(json.dumps({"phase": "group_norm_vs_plain", "ok": True,
                      "resident_cluster_sizes": cs_seen,
                      "plans_cs_resident": sorted(plans),
                      "max_abs_err": worst}))
    return max(worst[f"{BATCH}x256x{h}x{w}"]["bf16"] for h, w in TOWER_HW)


def build_cfg(dtype, path, extra=()):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype, *extra])
    cfg.freeze()
    return cfg


def seeded_model(dtype, device):
    """Full-width PAA-R50 with weights from seed 0 and the cls_logits bias
    drawn from seed 1 around the 0.05 threshold (logit -2.944), so that
    an untrained net yields candidates."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(build_cfg(dtype, PAA_CONFIG),
                                  device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.head.cls_logits.bias
    with torch.no_grad():
        bias.copy_(torch.empty(bias.shape).uniform_(-3.5, -2.5,
                                                    generator=gen))
    return model


def seeded_frcnn(dtype, device):
    """Full-width Faster R-CNN R-50-FPN with weights from seed 0 and the
    80 foreground cls_score biases drawn from seed 1 in [25, 35]. The
    random box head's logits spread with a std of ~30 across classes,
    so a roi's softmax is nearly one-hot whatever the bias; lifting the
    foreground one std above the background keeps the background from
    winning, so each of the 1000 rois of an image gives a foreground
    candidate above the 0.05 threshold."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(build_cfg(dtype, FRCNN_CONFIG),
                                  device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.box_head.cls_score.bias
    with torch.no_grad():
        bias[1:].copy_(torch.empty(bias.numel() - 1).uniform_(
            25.0, 35.0, generator=gen))
    return model


def request(seed, bsz, hw, size):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *hw, 3)).astype(np.uint8)
    sizes = np.tile(np.asarray(size, np.float32), (bsz, 1))
    return torch.from_numpy(images), torch.from_numpy(sizes)


def launch_counts():
    from paa_tpu_torch.ops import group_norm, nms

    return {"nms_batched": nms.nms_batched.launches,
            "nms_global": nms._nms_global.launches,
            "group_norm_relu": group_norm.group_norm_relu.launches}


def zero_launch_counts():
    from paa_tpu_torch.ops import group_norm, nms

    nms.nms_batched.launches = 0
    nms._nms_global.launches = 0
    group_norm.group_norm_relu.launches = 0


def check_detections(dets, what, min_score):
    """Shapes, finiteness, boxes in the image, scores and labels in range
    for every request; returns the valid detections per request."""
    n_valid = []
    for det in dets:
        check(tuple(det["boxes"].shape) == (BATCH, 100, 4)
              and tuple(det["scores"].shape) == (BATCH, 100)
              and tuple(det["labels"].shape) == (BATCH, 100)
              and tuple(det["valid"].shape) == (BATCH, 100),
              f"{what}: detection shapes")
        boxes, valid = det["boxes"], det["valid"]
        check(bool(torch.isfinite(boxes).all())
              and bool(torch.isfinite(det["scores"]).all()),
              f"{what}: non-finite output")
        vb = boxes[valid]
        # score voting averages clipped boxes: a few float32 ulps of slack
        slack = 1e-3
        check(bool((vb >= 0).all())
              and bool((vb[:, 0::2] <= SIZE[1] - 1 + slack).all())
              and bool((vb[:, 1::2] <= SIZE[0] - 1 + slack).all()),
              f"{what}: boxes outside the image")
        s = det["scores"][valid]
        check(bool((s > min_score).all()) and bool((s <= 1).all()),
              f"{what}: scores out of range")
        labels = det["labels"][valid]
        check(bool((labels >= 1).all()) and bool((labels <= 80).all()),
              f"{what}: labels out of range")
        n_valid.append(int(valid.sum()))
    check(min(n_valid) > 0, f"{what}: no detections {n_valid}")
    return n_valid


def serve(model, what, seed, expected, min_score):
    """Three requests through make_eval_fn with the launch counts set to
    0 just before and read just after."""
    eval_fn = model.make_eval_fn()
    reqs = [request(seed + i, BATCH, HW, SIZE) for i in range(3)]
    zero_launch_counts()
    times, dets = [], []
    for images, sizes in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_fn(images, sizes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dets.append(det)
    launches = launch_counts()
    check(launches == expected,
          f"{what}: launches {launches}, expected {expected}")
    n_valid = check_detections(dets, what, min_score)
    print(json.dumps({"phase": what, "ok": True, "requests": 3,
                      "batch": BATCH, "hw": HW, "launches": launches,
                      "valid_detections": n_valid, "request_s": times}))
    return eval_fn, launches


def phase_main_path(dev):
    model = seeded_model("bfloat16", dev)
    eval_fn, launches = serve(
        model, "main_path", 10,
        {"nms_batched": 3, "nms_global": 0, "group_norm_relu": 120}, 0.0)
    return model, eval_fn, launches


def phase_frcnn_main_path(dev):
    model = seeded_frcnn("bfloat16", dev)
    eval_fn, launches = serve(
        model, "faster_rcnn_main_path", 40,
        {"nms_batched": 3, "nms_global": 3, "group_norm_relu": 0}, 0.05)
    return model, eval_fn, launches


def match_detections(gpu, cpu, what):
    """Each card detection must have a CPU detection of its label within
    0.5 px; 95% must, and the counts agree within 5%."""
    matched = total = 0
    for i in range(gpu["valid"].shape[0]):
        gv, cv = gpu["valid"][i], cpu["valid"][i]
        for box, label in zip(gpu["boxes"][i][gv], gpu["labels"][i][gv]):
            total += 1
            same = cpu["labels"][i][cv] == label
            d = (cpu["boxes"][i][cv][same] - box).abs().amax(dim=1)
            matched += int(d.numel() > 0 and float(d.min()) <= 0.5)
    n_cpu = int(cpu["valid"].sum())
    check(total > 0 and abs(total - n_cpu) <= 0.05 * n_cpu
          and matched >= 0.95 * total,
          f"{what}: {matched}/{total} card detections matched, "
          f"{n_cpu} on the CPU")
    return {"detections": total, "matched": matched,
            "cpu_detections": n_cpu}


def card_vs_cpu(dev, build, outputs, what):
    """The f32 model of ``build`` on the card against the same model on
    the CPU (plain versions) at 2 x 256 x 320; ``outputs(model, x)``
    gives the tensors compared within 1e-3 of their largest magnitude."""
    from paa_tpu_torch.ops.image_norm import device_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    outs, dets = [], []
    for device in (dev, "cpu"):
        model = build("float32", device)
        x = device_normalize(images.to(device), sizes.to(device),
                             model.cfg.INPUT.PIXEL_MEAN,
                             model.cfg.INPUT.PIXEL_STD)
        with torch.inference_mode():
            outs.append({k: v.float().cpu() for k, v in outputs(
                model, x.permute(0, 3, 1, 2).contiguous()).items()})
        dets.append({k: v.cpu() for k, v in
                     model.make_eval_fn()(images, sizes).items()})
    errs = {}
    for k, want in outs[1].items():
        errs[k] = float((outs[0][k] - want).abs().max()
                        / want.abs().max())
        check(errs[k] <= 1e-3, f"{what}: {k} rel err {errs[k]}")
    print(json.dumps({"phase": what, "ok": True, "hw": [256, 320],
                      "rel_err": errs,
                      **match_detections(*dets, what)}))


def phase_reference(dev):
    card_vs_cpu(dev, seeded_model, lambda m, x: m.module(x), "card_vs_cpu")


def phase_frcnn_reference(dev):
    card_vs_cpu(dev, seeded_frcnn, lambda m, x: m.module.backbone_rpn(x)[1],
                "faster_rcnn_card_vs_cpu")


def e2e_rate(eval_fn, seed, what, name, dev):
    images, sizes = request(seed, BATCH, HW, SIZE)
    eval_fn(images, sizes)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        eval_fn(images, sizes)
    torch.cuda.synchronize()
    e2e_s = (time.perf_counter() - t0) / reps
    print(json.dumps({"metric": "e2e_img_per_s", "path": what,
                      "value": BATCH / e2e_s, "batch": BATCH, "hw": HW,
                      "dtype": "bfloat16", "request_ms": e2e_s * 1e3,
                      "card": name}))
    return images.to(dev), sizes.to(dev)


def k1_tiles(args, got):
    """The tiles of 32 sorted candidates K1's sweep ran on this input, as
    the kernel counts them (summed over rows, and the most in a row), and
    the most picks in a row. One more launch, outside the main path's
    counted run."""
    from paa_tpu_torch.ops import nms

    tiles = torch.zeros(args[1].shape[0], dtype=torch.int32,
                        device=args[1].device)
    nms._nms_batched_cuda(*args, tiles=tiles)
    return {"tiles_swept": int(tiles.sum()),
            "most_tiles_in_a_row": int(tiles.max()),
            "most_picks_in_a_row": int(got[2].sum(dim=1).max())}


def time_nms(entry, args, kernel_reps, what, real_n=None):
    """A kernel against its plain version on one input: bit-equal, then
    both timed; returns the timing fields of a kernels entry."""
    from paa_tpu_torch.ops import nms

    got = entry(*args)
    same_keeps(got, nms.nms_batched_plain(*args), what)
    bound, by, ious = nms_bound(args, got, real_n)
    return ious, got, {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: entry(*args), kernel_reps),
        "plain_ms": cuda_ms(lambda: nms.nms_batched_plain(*args), 3, 1),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def phase_timing(dev, model, eval_fn, launches, gn_err, name):
    from paa_tpu_torch.modeling.paa_inference import paa_candidates
    from paa_tpu_torch.ops import nms
    from paa_tpu_torch.ops.image_norm import device_normalize

    images, sizes = e2e_rate(eval_fn, 20, "paa", name, dev)

    # NMS at the main path's own candidates
    with torch.inference_mode():
        x = device_normalize(images, sizes, model.cfg.INPUT.PIXEL_MEAN,
                             model.cfg.INPUT.PIXEL_STD)
        outputs = model.module(x.permute(0, 3, 1, 2).contiguous())
        anchors, counts = model.anchors_for(HW)
        cand = paa_candidates(outputs, sizes, anchors, counts,
                              model.postprocess_config())
    args = (*cand, 0.6, 100, True)
    ious, got, timing = time_nms(nms.nms_batched, args, 20,
                                 "nms_batched on the PAA candidates")
    k1 = {
        "name": "nms_batched", "route": "cuda",
        "source": "paa_tpu_torch/csrc/nms_batched.cu",
        "replaces": "paa_tpu/ops/nms_pallas.py:191",
        "launches": launches["nms_batched"], **timing,
    }
    print(json.dumps({"kernel_detail": "nms_batched", "path": "paa",
                      "B": cand[1].shape[0], "N": cand[1].shape[1],
                      "route": "sort + tile sweep", **k1_tiles(args, got),
                      "ious_needed": ious, "valid_picks": int(got[2].sum()),
                      "card": name}))

    totals, per_level = gn_forward_cost(dev, BATCH, 5)
    k3 = {
        "name": "group_norm_relu", "route": "cuda",
        "source": "paa_tpu_torch/csrc/group_norm.cu",
        "replaces": "paa_tpu/ops/fused_gn.py:146",
        "launches": launches["group_norm_relu"], "max_abs_err": gn_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"], "bound_by": "bytes",
        "library_ms": totals["library_ms"],
    }
    print(json.dumps({"kernel_detail": "group_norm_relu", "dtype":
                      "bfloat16", "B": BATCH,
                      "per_launch_by_level": per_level, "card": name}))
    train, per_level = gn_forward_cost(dev, TRAIN_BATCH, 6, backward=True)
    k3["training"] = {"B": TRAIN_BATCH, **train}
    print(json.dumps({"kernel_detail": "group_norm_relu", "dtype":
                      "bfloat16", "B": TRAIN_BATCH, "path": "paa_train",
                      "per_launch_by_level": per_level, "card": name}))
    return k1, k3


def gn_forward_cost(dev, bsz, seed, backward=False):
    """K3 per forward of the towers at batch ``bsz`` (8 launches at each
    level's shape, bfloat16): its ms beside the plain version's, the
    bound (bytes: x read once, y written once, the affine) and
    ``F.group_norm`` + ``F.relu``; with ``backward`` also the ms of the
    gradient's recompute (the plain version's VJP, for x, weight and
    bias). Returns (totals, per level)."""
    from paa_tpu_torch.ops import group_norm as gn

    gen = torch.Generator().manual_seed(seed)
    s = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0}
    per_level = {}
    for h, w in TOWER_HW:
        x = torch.randn(bsz, 256, h, w, generator=gen).to(
            dev, torch.bfloat16)
        level = {
            "ms": cuda_ms(lambda: gn.group_norm_relu(x, s, b), 50),
            "plain_ms": cuda_ms(lambda: gn.group_norm_relu_plain(x, s, b),
                                20),
            "library_ms": cuda_ms(lambda: F.relu(F.group_norm(
                x, 32, s.to(x.dtype), b.to(x.dtype), 1e-5)), 50),
            "bound_ms": 1e3 * (2 * x.numel() * x.element_size()
                               + 2 * 256 * 4) / HBM_BYTES_PER_S,
        }
        if backward:
            ins = [t.detach().requires_grad_(True) for t in (x, s, b)]
            up = torch.randn_like(x)

            def vjp():
                with torch.enable_grad():
                    torch.autograd.grad(gn.group_norm_relu_plain(*ins),
                                        ins, up)

            level["backward_recompute_ms"] = cuda_ms(vjp, 10)
        for k, v in level.items():
            totals[k] = totals.get(k, 0.0) + GN_PER_LEVEL * v
        plan = gn.gn_plan(bsz, 256, h * w, 32, x.element_size())
        per_level[f"{h}x{w}"] = {**level, "cs": plan.cs,
                                 "threads": plan.threads,
                                 "max_active_clusters":
                                     gn.gn_max_active_clusters(x)}
    return totals, per_level


def phase_frcnn_timing(dev, model, eval_fn, launches, name):
    """End to end, then K2 on the box head's own candidates and K1 on
    the RPN's own NMS rows of one request."""
    from paa_tpu_torch.modeling.roi_box_head import box_head_candidates
    from paa_tpu_torch.modeling.rpn import (
        RPNConfig, rpn_nms_input, select_proposals)
    from paa_tpu_torch.ops import nms
    from paa_tpu_torch.ops.image_norm import device_normalize

    images, sizes = e2e_rate(eval_fn, 50, "faster_rcnn", name, dev)
    cfg, module = model.cfg, model.module
    rc = RPNConfig.from_cfg(cfg)
    bc = model.postprocess_config()
    with torch.inference_mode():
        x = device_normalize(images, sizes, cfg.INPUT.PIXEL_MEAN,
                             cfg.INPUT.PIXEL_STD)
        features, rpn = module.backbone_rpn(x.permute(0, 3, 1, 2)
                                            .contiguous())
        anchors, counts = model.anchors_for(HW)
        (boxes, scores, labels, valid, max_out), level_boxes, _ = \
            rpn_nms_input(rpn, sizes, anchors, counts, rc)
        proposals, _, p_valid = select_proposals(rpn, sizes, anchors,
                                                 counts, rc)
        k = proposals.shape[1]
        cls, deltas = module.box(
            features, proposals.reshape(-1, 4),
            torch.arange(BATCH, device=dev).repeat_interleave(k))
        cand = box_head_candidates(
            cls.reshape(BATCH, k, -1), deltas.reshape(BATCH, k, -1, 4),
            proposals, p_valid, sizes, bc)
    per_image = [int(v) for v in cand[3].sum(dim=1)]
    check(min(per_image) >= 1000,
          f"box head: candidates above {bc.score_thresh} per image "
          f"{per_image}, expected at least 1000")

    before = (nms.nms_batched.launches, nms._nms_global.launches)
    args = (*cand, bc.nms_thresh, bc.detections_per_img, True)
    ious, got, timing = time_nms(nms.nms_batched, args, 20,
                                 "nms_batched (K2) on the box head's "
                                 "candidates")
    check(nms.nms_batched.launches == before[0]
          and nms._nms_global.launches > before[1],
          "box head NMS did not route to K2")
    k2 = {
        "name": "nms_global", "route": "cuda",
        "source": "paa_tpu_torch/csrc/nms_global.cu",
        "replaces": "paa_tpu/ops/nms_pallas.py:238",
        "launches": launches["nms_global"], **timing,
    }
    n = cand[1].shape[1]
    print(json.dumps({"kernel_detail": "nms_global", "path": "faster_rcnn",
                      "B": BATCH, "N": n,
                      "steps": int((got[2].sum(dim=1) + 1).clamp(
                          max=args[5]).sum()), "ious_needed": ious,
                      "route": nms.k2_plan(n, nms.k2_capacity(dev)),
                      "max_active_clusters":
                          nms.k2_max_active_clusters(dev, n),
                      "valid_picks": int(got[2].sum()),
                      "candidates_per_image": per_image,
                      "proposals_per_image": [int(v) for v in
                                              p_valid.sum(dim=1)],
                      "cls_logit_std_across_classes": float(
                          cls.std(dim=1).mean()),
                      "card": name}))

    rpn_args = (boxes, scores, labels, valid, rc.nms_thresh, max_out, False)
    real_n = [lb.shape[1] for lb in level_boxes for _ in range(BATCH)]
    ious, got, k1_rpn = time_nms(nms.nms_batched, rpn_args, 10,
                                 "nms_batched (K1) on the RPN rows", real_n)
    print(json.dumps({"kernel_detail": "nms_batched", "path": "faster_rcnn",
                      "rows": scores.shape[0], "N": scores.shape[1],
                      "max_out": max_out, "route": "sort + tile sweep",
                      **k1_tiles(rpn_args, got), "ious_needed": ious,
                      "real_n_per_level": real_n[::BATCH],
                      "valid_per_row": [int(v) for v in valid.sum(dim=1)],
                      "valid_picks": int(got[2].sum()), **k1_rpn,
                      "card": name}))
    return k2, k1_rpn


def train_batch(seed, bsz, hw, size, max_gt=MAX_GT):
    """A batch in the loader's contract: uint8 images (content ``size``)
    and 3-12 GT boxes per image (COCO averages about 7) in ``max_gt``
    slots, sqrt(area) log-uniform in 16-512 px, aspect ratio log-uniform
    in 1/2-2, inside the content, labels 1-80; the other slots padding
    (label 0)."""
    images, sizes = request(seed, bsz, hw, size)
    rng = np.random.RandomState(seed + 1)
    boxes = np.zeros((bsz, max_gt, 4), np.float32)
    labels = np.zeros((bsz, max_gt), np.int32)
    h, w = size
    for b in range(bsz):
        n = rng.randint(3, 13)
        side = np.exp(rng.uniform(np.log(16), np.log(512), n))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
        x1 = rng.uniform(0, w - 1 - bw)
        y1 = rng.uniform(0, h - 1 - bh)
        boxes[b, :n] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
        labels[b, :n] = rng.randint(1, 81, n)
    return {"images": images, "image_sizes": sizes,
            "gt_boxes": torch.from_numpy(boxes),
            "gt_labels": torch.from_numpy(labels)}


def train_state(model):
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.solver import make_optimizer

    return TrainState(model.module, make_optimizer(model.cfg,
                                                   model.module)[0])


EVAL_IMAGES = 32
EVAL_SPAN = "eval_fn"  # record_function span around each model call


def synth_dataset(root, n_images, seed):
    """A COCO-style dataset of ``n_images`` PPM images at COCO's common
    sizes (640x480, 480x640, 427x640, 500x375, ...) with low-frequency
    content and 3-12 boxes each over COCO's 80 sparse category ids."""
    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco

    ann_file, img_dir = synth_coco(root, n_images, seed=seed)
    return COCODataset(ann_file, img_dir,
                       remove_images_without_annotations=False)


def timed_eval_calls(model):
    """Make ``model.make_eval_fn`` time each call (host clock, the card
    synchronized) inside an EVAL_SPAN span; returns the list it fills."""
    from torch.profiler import record_function

    make, calls = model.make_eval_fn, []

    def make_timed(state=None):
        fn = make(state)

        def timed(images, sizes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(EVAL_SPAN):
                out = fn(images, sizes)
                torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out
        return timed

    model.make_eval_fn = make_timed
    return calls


def eval_idle_share(prof):
    """The device's idle share inside the EVAL_SPAN spans of a profile:
    1 - (kernel time within the spans, overlaps counted once) / (the
    spans' time)."""
    from torch.autograd import DeviceType

    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name == EVAL_SPAN]
    kernels = [(e.time_range.start, e.time_range.end) for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels or not spans:
        return "not measured"
    busy = sum(_union_us([(max(a, s0), min(b, s1)) for a, b in kernels
                          if b > s0 and a < s1]) for s0, s1 in spans)
    return 1.0 - busy / sum(s1 - s0 for s0, s1 in spans)


def read_bbox_json(folder):
    with open(os.path.join(folder, "bbox.json")) as f:
        return json.load(f)


def phase_eval_main_path(dev, name):
    """PAA-R50 COCO-style evaluation, dataset to AP table, at full width:
    32 PPM images through the port's ``inference`` (the bucketed loader
    at 800 x 1333 in (800, 1344) / (1344, 800), raw uint8 batches of 8
    with the short tails padded by image_id -1, make_eval_fn in bfloat16
    with K3 and K1, the COCO evaluator), with the serving cell's seeded
    weights and cls bias; the launch counts set to 0 just before and
    read just after. Then the loader alone, and a profiled run for the
    device's idle share during the model calls."""
    import logging

    from torch.profiler import ProfilerActivity, profile

    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.engine.inference import inference

    tmp = tempfile.mkdtemp(prefix="paa_eval_")
    dataset = synth_dataset(os.path.join(tmp, "coco"), EVAL_IMAGES, 11)
    model = seeded_model("bfloat16", dev)
    cfg = model.cfg
    logger = logging.getLogger("chip_smoke.eval")
    out_dir = os.path.join(tmp, "inference")
    calls = timed_eval_calls(model)

    zero_launch_counts()
    t0 = time.perf_counter()
    results = inference(cfg, model, dataset, output_folder=out_dir,
                        logger=logger)
    e2e_s = time.perf_counter() - t0
    launches = launch_counts()
    batches = len(calls)
    expected = {"nms_batched": batches, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW) * batches}
    check(launches == expected and batches > 0,
          f"eval_main_path: launches {launches}, expected {expected}")
    check(sorted(results) == sorted(METRICS) and all(
        math.isfinite(v) and -1.0 <= v <= 1.0 for v in results.values()),
        f"eval_main_path: results {results}")
    with open(os.path.join(out_dir, "coco_results.json")) as f:
        check(json.load(f) == results, "eval_main_path: coco_results.json")
    dets = read_bbox_json(out_dir)
    per_image = {}
    for d in dets:
        per_image[d["image_id"]] = per_image.get(d["image_id"], 0) + 1
    ids = sorted(r.id for r in dataset.records)
    check(-1 not in per_image, "eval_main_path: a padding image predicted")
    check(sorted(per_image) == ids,
          f"eval_main_path: images without detections "
          f"{sorted(set(ids) - set(per_image))}")
    check(all(len(d["bbox"]) == 4 and all(map(math.isfinite, d["bbox"]))
              and d["bbox"][2] > 0 and d["bbox"][3] > 0
              and 0 < d["score"] <= 1 for d in dets),
          "eval_main_path: malformed detection")
    cold = {"e2e_img_per_s": EVAL_IMAGES / e2e_s,
            "model_img_per_s": EVAL_IMAGES / sum(calls),
            "model_call_ms": [c * 1e3 for c in calls]}
    # steady state: the same path again, every shape seen once
    del calls[:]
    t0 = time.perf_counter()
    inference(cfg, model, dataset, logger=logger)
    e2e_s = time.perf_counter() - t0
    model_s = sum(calls)
    call_ms = [c * 1e3 for c in calls]

    # the loader alone, then a profiled run of the whole path
    t0 = time.perf_counter()
    loaded = list(make_data_loader(cfg, dataset, is_train=False))
    loader_s = time.perf_counter() - t0
    n_loaded = sum(int((b["image_ids"] >= 0).sum()) for b in loaded)
    check(n_loaded == EVAL_IMAGES, f"eval_main_path: loader gave {n_loaded}")
    # the model calls alone, on the batches loaded above
    eval_fn = model.make_eval_fn()
    del calls[:]
    for b in loaded:
        eval_fn(torch.from_numpy(b["images"]),
                torch.from_numpy(b["image_sizes"]))
    alone_s = sum(calls)
    stages = loader_stages(cfg, dataset)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        inference(cfg, model, dataset, logger=logger)
    idle = eval_idle_share(prof)
    del model.make_eval_fn
    print(json.dumps({"phase": "eval_main_path", "ok": True,
                      "images": EVAL_IMAGES, "batches": batches,
                      "batch": cfg.TEST.IMS_PER_BATCH,
                      "buckets": [list(b) for b in cfg.TPU.TEST_BUCKETS],
                      "dtype": "bfloat16", "launches": launches,
                      "detections": len(dets),
                      "loader_img_per_s": EVAL_IMAGES / loader_s,
                      "model_img_per_s": EVAL_IMAGES / model_s,
                      "e2e_img_per_s": EVAL_IMAGES / e2e_s,
                      "model_call_ms": call_ms, "first_run": cold,
                      "model_alone_img_per_s": EVAL_IMAGES / alone_s,
                      "device_idle_share_in_model_calls": idle,
                      "loader_stage_ms_per_image": stages,
                      "card": name}))
    print(json.dumps({"ap_table": "random weights (seed 0, cls bias seed "
                      "1), a synthetic dataset: not an accuracy",
                      **results}))
    shutil.rmtree(tmp, ignore_errors=True)
    return launches


def loader_stages(cfg, dataset):
    """ms per image of the loader's stages, one thread, host clock:
    decode (the PPM read), resize (EvalTransform) and batch assembly
    (make_batch into the padded uint8 bucket)."""
    from paa_tpu_torch.data.loader import BucketAssigner, make_batch
    from paa_tpu_torch.data.transforms import build_transforms

    transform = build_transforms(cfg, is_train=False, defer_normalize=True)
    assigner = BucketAssigner(cfg.TPU.TEST_BUCKETS)
    spent = {"decode": 0.0, "resize": 0.0, "batch": 0.0}
    for i, r in enumerate(dataset.records):
        t0 = time.perf_counter()
        img = dataset.load_image(i)
        t1 = time.perf_counter()
        img, boxes = transform(img, r.boxes)
        t2 = time.perf_counter()
        make_batch([{"image": img, "boxes": boxes, "labels": r.labels,
                     "image_id": r.id, "orig_size": (r.height, r.width)}],
                   assigner.assign(*img.shape[:2]), cfg.TPU.MAX_GT,
                   device_normalize=True)
        t3 = time.perf_counter()
        for k, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2)):
            spent[k] += dt
    return {k: v * 1e3 / len(dataset) for k, v in spent.items()}


def _detections_by_image(dets, image_ids):
    """bbox.json entries as match_detections' padded tensors: xyxy boxes
    (+1 convention back from xywh) and category ids, per image."""
    n = max([sum(d["image_id"] == i for d in dets) for i in image_ids]
            + [1])
    boxes = torch.zeros(len(image_ids), n, 4)
    labels = torch.zeros(len(image_ids), n, dtype=torch.int64)
    valid = torch.zeros(len(image_ids), n, dtype=torch.bool)
    for row, img_id in enumerate(image_ids):
        mine = [d for d in dets if d["image_id"] == img_id]
        for j, d in enumerate(mine):
            x, y, w, h = d["bbox"]
            boxes[row, j] = torch.tensor([x, y, x + w - 1, y + h - 1])
            labels[row, j] = d["category_id"]
            valid[row, j] = True
    return {"boxes": boxes, "labels": labels, "valid": valid}


def phase_eval_card_vs_cpu(dev):
    """The whole eval path, dataset to AP table, in float32 (TF32 off) on
    the card and on the CPU (plain versions) from the same weights: four
    PPM images resized to 256 (at most 320) in the buckets (256, 320) and
    (320, 256). So that the AP is not 0 for random weights, the ground
    truth is the CPU's five best detections of each image on a first
    pass. Detections matched as in phase 6; the 12 AP values within
    1e-3."""
    import logging

    from paa_tpu_torch.data.coco import COCODataset
    from paa_tpu_torch.data.synth import synth_coco
    from paa_tpu_torch.engine.inference import inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="paa_eval_ref_")
    ann_file, img_dir = synth_coco(os.path.join(tmp, "coco"), 4, seed=12)
    first = COCODataset(ann_file, img_dir,
                        remove_images_without_annotations=False)
    cfg = build_cfg("float32", PAA_CONFIG, [
        "INPUT.MIN_SIZE_TEST", 256, "INPUT.MAX_SIZE_TEST", 320,
        "TPU.TEST_BUCKETS", ((256, 320), (320, 256)),
        "TEST.IMS_PER_BATCH", 2])
    logger = logging.getLogger("chip_smoke.eval")
    models = {d: seeded_model("float32", d) for d in (dev, "cpu")}
    folder = os.path.join(tmp, "first")
    inference(cfg, models["cpu"], first, output_folder=folder, logger=logger)
    with open(ann_file) as f:
        data = json.load(f)
    data["annotations"] = []
    ids = [r.id for r in first.records]
    for img_id in ids:
        mine = sorted((d for d in read_bbox_json(folder)
                       if d["image_id"] == img_id), key=lambda d: -d["score"])
        for d in mine[:5]:
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img_id,
                bbox=d["bbox"], area=d["bbox"][2] * d["bbox"][3],
                category_id=d["category_id"], iscrowd=0))
    ann_file = os.path.join(tmp, "cpu_top5.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    dataset = COCODataset(ann_file, img_dir,
                          remove_images_without_annotations=False)
    results, dets = [], []
    for device in (dev, "cpu"):
        folder = os.path.join(tmp, str(device))
        results.append(inference(cfg, models[device], dataset,
                                 output_folder=folder, logger=logger))
        dets.append(read_bbox_json(folder))
    matched = match_detections(*[_detections_by_image(d, ids)
                                 for d in dets], "eval_card_vs_cpu")
    ap_err = {k: abs(results[0][k] - v) for k, v in results[1].items()}
    check(sorted(ap_err) == sorted(METRICS)
          and max(ap_err.values()) <= 1e-3 and results[1]["AP"] > 0,
          f"eval_card_vs_cpu: AP {results}")
    print(json.dumps({"phase": "eval_card_vs_cpu", "ok": True,
                      "images": len(ids), "gt": len(data["annotations"]),
                      "ap_card": results[0], "ap_abs_err": ap_err,
                      **matched}))
    shutil.rmtree(tmp, ignore_errors=True)


def phase_gn_grad(dev):
    """The autograd Function around K3 against autograd through the
    plain version, at the towers' shapes of a training batch."""
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    worst = {}
    for h, w in TOWER_HW:
        shape = (TRAIN_BATCH, 256, h, w)
        x32 = torch.randn(*shape, generator=gen) * 1.5 + 0.4
        s = (torch.rand(256, generator=gen) + 0.5).to(dev)
        b = (torch.randn(256, generator=gen) * 0.2).to(dev)
        up32 = torch.randn(*shape, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            what = f"{dtype} {'x'.join(map(str, shape))}"
            x, up = x32.to(dev, dtype), up32.to(dev, dtype)
            ins = [t.clone().requires_grad_(True) for t in (x, s, b)]
            before = gn.group_norm_relu.launches
            y = gn.group_norm_relu(*ins)
            check(gn.group_norm_relu.launches == before + 1
                  and type(y.grad_fn).__name__ == "GroupNormReLUBackward",
                  f"gn grad {what}: K3 not launched through the Function")
            y.backward(up)
            refs = [t.clone().requires_grad_(True) for t in (x, s, b)]
            want = gn.group_norm_relu_plain(*refs)
            want.backward(up)
            y, want = y.detach(), want.detach()
            err = (y.float() - want.float()).abs()
            if dtype == torch.float32:
                check(float(err.max()) <= 1e-5,
                      f"gn grad {what}: forward err {float(err.max())}")
            else:
                ulp = _bf16_ulp(torch.maximum(y.float().abs(),
                                              want.float().abs()))
                check(bool((err <= ulp + 1e-6).all()),
                      f"gn grad {what}: forward beyond one ulp")
            for got, ref, n in zip(ins, refs, ("x", "weight", "bias")):
                check(got.grad.dtype == ref.grad.dtype
                      and torch.equal(got.grad, ref.grad),
                      f"gn grad {what}: d{n} differs by "
                      f"{float((got.grad - ref.grad).abs().max())}")
            worst[what] = float(err.max())
    tie = gn_zero_variance_tie(dev)
    print(json.dumps({"phase": "gn_grad_vs_plain", "ok": True,
                      "gradients": "equal", "forward_max_abs_err": worst,
                      "zero_variance_tie_dbias": tie}))


def gn_zero_variance_tie(dev):
    """K3 through the Function at a group of zero variance with a zero
    bias (1 x 64 x 4 x 4, channels 0-1 all 1.0, weight 1, bias[0:2] 0):
    the ReLU input is exactly 0, where the JAX package's custom VJP
    (``jnp.maximum``) gives half the upstream gradient, so d bias of
    channels 0-1 is half their upstream sum, as the plain version's."""
    from paa_tpu_torch.ops import group_norm as gn

    gen = torch.Generator().manual_seed(9)
    x = torch.randn(1, 64, 4, 4, generator=gen) * 1.2 + 0.3
    x[0, 0:2] = 1.0
    b = torch.randn(64, generator=gen) * 0.2
    b[0:2] = 0.0
    up = torch.randn(1, 64, 4, 4, generator=gen).to(dev)
    ins = [t.to(dev).requires_grad_(True) for t in (x, torch.ones(64), b)]
    before = gn.group_norm_relu.launches
    gn.group_norm_relu(*ins).backward(up)
    check(gn.group_norm_relu.launches == before + 1,
          "gn zero-variance tie: K3 not launched")
    want = 0.5 * up[0, 0:2].sum(dim=(1, 2))
    got = ins[2].grad[0:2]
    check(bool(torch.allclose(got, want, rtol=1e-6, atol=0)),
          f"gn zero-variance tie: d bias {got.tolist()}, want "
          f"{want.tolist()}")
    return got.tolist()


def phase_train_main_path(dev, name):
    """10 steps of do_train at full width on one batch; the launch counts
    set to 0 just before and read just after."""
    from paa_tpu_torch.engine import do_train
    from paa_tpu_torch.modeling import build_detection_model

    cfg = build_cfg("bfloat16", PAA_CONFIG,
                    ["SOLVER.MAX_ITER", TRAIN_STEPS])
    model = build_detection_model(cfg, device=dev, seed=0)
    state = train_state(model)
    batch = train_batch(70, TRAIN_BATCH, HW, SIZE)
    seen = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    t0 = time.perf_counter()
    do_train(cfg, model, state, [batch] * TRAIN_STEPS,
             metric_hook=lambda i, m: seen.update({i: m}))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    expected = {"nms_batched": 0, "nms_global": 0,
                "group_norm_relu": GN_PER_LEVEL * len(TOWER_HW)
                * TRAIN_STEPS}
    check(launches == expected,
          f"train_main_path: launches {launches}, expected {expected}")
    check(sorted(seen) == list(range(1, TRAIN_STEPS + 1)),
          f"train_main_path: metrics of steps {sorted(seen)}")
    for i, m in seen.items():
        check(all(math.isfinite(v) for v in m.values()),
              f"train_main_path: step {i} {m}")
        check(m["num_pos"] > 0, f"train_main_path: step {i} no positives")
    check(seen[TRAIN_STEPS]["loss"] < seen[1]["loss"],
          f"train_main_path: loss {seen[1]['loss']} -> "
          f"{seen[TRAIN_STEPS]['loss']}")
    n_gt = (batch["gt_labels"] > 0).sum(dim=1).tolist()
    print(json.dumps({
        "phase": "train_main_path", "ok": True, "batch": TRAIN_BATCH,
        "hw": HW, "max_gt": MAX_GT, "gt_per_image": n_gt,
        "steps": TRAIN_STEPS, "dtype": "bfloat16", "launches": launches,
        "losses": {k: [seen[i][k] for i in sorted(seen)]
                   for k in seen[1]},
        "do_train_s": wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2**30,
        "card": name}))
    return model, state, batch, launches


def _with_pos_mask(loss):
    """``loss`` that also reports its positive mask among the step's
    metrics (the train step sums only the ``loss_*`` entries)."""
    def call(*args, **kwargs):
        out, aux = loss(*args, return_aux=True, **kwargs)
        return {**out, "pos_mask": aux["pos_mask"]}
    return call


def train_once(model, batch):
    """One train step of ``model`` on ``batch`` with a fresh optimizer:
    (host metrics, the step's positive mask, the parameters before and
    after it), all on the CPU."""
    loss_call, loss_cfg = model.loss_fn()
    model.loss_fn = lambda: (_with_pos_mask(loss_call), loss_cfg)
    state = train_state(model)
    params = dict(model.module.named_parameters())
    before = {n: p.detach().cpu().clone() for n, p in params.items()}
    metrics = model.make_bucket_train_step(
        tuple(batch["images"].shape[1:3]))(state, batch)
    pos_mask = metrics.pop("pos_mask").cpu()
    return ({k: float(v) for k, v in metrics.items()}, pos_mask, before,
            {n: p.detach().cpu() for n, p in params.items()})


def update_norm_err(got, want, before):
    """|update of got - update of want| over |update of want|, 2-norms."""
    upd = want - before
    return float((got - want).norm() / upd.norm().clamp(min=1e-30))


def update_errors(got, want, before):
    """The four parameter tensors whose update (after - before) in
    ``got`` is farthest from that in ``want``: by the difference's norm
    over the update's norm, and by its largest element over the update's
    largest element."""
    share, norm = {}, {}
    for n, p in want.items():
        upd = p - before[n]
        diff = got[n] - before[n] - upd
        share[n] = float(diff.abs().max() / upd.abs().max().clamp(min=1e-30))
        norm[n] = float(diff.norm() / upd.norm().clamp(min=1e-30))
    return (sorted(norm.items(), key=lambda kv: -kv[1])[:4],
            sorted(share.items(), key=lambda kv: -kv[1])[:4])


def _gn_plain_stats_detached(x, weight, bias, num_groups=32, eps=1e-5):
    """group_norm_relu_plain with its group statistics taken as constants:
    a wrong gradient of x (the mean and variance terms are missing)."""
    b, c, h, w = x.shape
    xf = x.to(torch.float32).reshape(b, num_groups, -1)
    mean = xf.mean(dim=2, keepdim=True).detach()
    var = (xf - mean).square().mean(dim=2, keepdim=True).detach()
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    out = xn * weight[:, None, None] + bias[:, None, None]
    return torch.relu(out).to(x.dtype)


# about 3x the worst of the card's step against the CPU's, and of either
# against the float64 referee, on an H100 80GB HBM3 (3.1e-3 and 9.7e-3;
# PERF.md, PR 6)
UPDATE_NORM_TOL, UPDATE_SHARE_TOL = 9e-3, 2.9e-2


def phase_train_reference(dev):
    """One float32 train step on the card against the same on the CPU
    (plain versions), from the same weights and batch at 2 x 256 x 320:
    losses within 1e-4 relative, num_pos and the positive mask equal;
    each parameter tensor's update (after - before) within
    UPDATE_NORM_TOL of its norm, and every element within
    UPDATE_SHARE_TOL of the tensor's largest update. Both float32 steps
    are also held to those limits against a float64 step on the CPU
    (``float64_referee``). Why the limits are not tighter: the two sides
    round in float32 in different orders and by different algorithms.
    The referee shows it: the card's convolutions round ~4x coarser than
    the CPU's (``conv_precision_probe``), cuDNN's algorithms add ~3e-4 of
    update error in the head and the FPN that PyTorch's own convolutions
    on the card do not, and K3 adds nothing (its plain forward gives the
    same updates); the head's GroupNorm gradients subtract group means,
    which amplifies what differs. On an H100 80GB HBM3 the worst tensor
    was at 3.1e-3 of its norm and 9.7e-3 of its largest element, the
    same in every run, both against the CPU and against float64
    (PERF.md). The same step on the card with a fault planted in K3's
    gradient (the group statistics taken as constants; x's gradient 1.05
    times the right one) must land beyond the limits: GroupNormReLU's
    backward recomputes through the module's group_norm_relu_plain,
    which each fault replaces for one step."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = build_cfg("float32", PAA_CONFIG)
    batch = train_batch(99, 2, (256, 320), (256.0, 300.0))
    runs = [train_once(build_detection_model(cfg, device=d, seed=0), batch)
            for d in (dev, "cpu")]
    (m_gpu, pos_gpu, before, p_gpu), (m_cpu, pos_cpu, _, p_cpu) = runs
    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-12)
                for k, v in m_cpu.items()}
    worst_norm, worst_share = update_errors(p_gpu, p_cpu, before)
    referee = float64_referee(dev, cfg, batch, before, p_gpu, p_cpu,
                              pos_cpu)
    referee["conv_probe"] = conv_precision_probe(dev)
    check(m_gpu["num_pos"] == m_cpu["num_pos"] > 0
          and torch.equal(pos_gpu, pos_cpu),
          "train_card_vs_cpu: positive masks differ")
    check(max(loss_err.values()) <= 1e-4, f"train_card_vs_cpu: {loss_err}")
    check(worst_norm[0][1] <= UPDATE_NORM_TOL
          and worst_share[0][1] <= UPDATE_SHARE_TOL,
          f"train_card_vs_cpu: updates {worst_norm} {worst_share}")
    planted = {}
    plain = gn.group_norm_relu_plain
    faults = {"gn_stats_detached": _gn_plain_stats_detached,
              "gn_dx_x1.05": lambda x, *args: plain(
                  x.detach() + (x - x.detach()) * 1.05, *args)}
    for fault, fn in faults.items():
        gn.group_norm_relu_plain = fn
        try:
            _, _, _, p_bad = train_once(
                build_detection_model(cfg, device=dev, seed=0), batch)
        finally:
            gn.group_norm_relu_plain = plain
        f_norm, f_share = update_errors(p_bad, p_cpu, before)
        planted[fault] = {"worst_update_norm_err": f_norm[0],
                          "worst_update_share": f_share[0]}
        check(f_norm[0][1] > UPDATE_NORM_TOL
              or f_share[0][1] > UPDATE_SHARE_TOL,
              f"train_card_vs_cpu: planted {fault} within the limits: "
              f"{f_norm} {f_share}")
    print(json.dumps({"phase": "train_card_vs_cpu", "ok": True,
                      "hw": [256, 320], "num_pos": m_gpu["num_pos"],
                      "loss_rel_err": loss_err,
                      "worst_update_norm_err": worst_norm,
                      "worst_update_share": worst_share,
                      "float64_referee": referee,
                      "planted_faults": planted}))


def conv_precision_probe(dev):
    """How far one float32 convolution of the head towers (B=2 at the
    five pyramid levels of a 256 x 320 input, 3 x 3, 256 channels) is
    from float64: the largest relative 2-norm error over the levels of
    the output, the input gradient and the weight gradient, on the CPU
    and on the card (TF32 off), by level."""
    gen = torch.Generator().manual_seed(13)
    w = torch.randn(256, 256, 3, 3, generator=gen,
                    dtype=torch.float64) / 48.0
    out = {}
    for h, wd in ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3)):
        x = torch.randn(2, 256, h, wd, generator=gen, dtype=torch.float64)
        up = torch.randn(2, 256, h, wd, generator=gen, dtype=torch.float64)

        def run(device, dtype):
            xs, ws = (t.to(device, dtype).clone().requires_grad_(True)
                      for t in (x, w))
            y = F.conv2d(xs, ws, padding=1)
            y.backward(up.to(device, dtype))
            return [t.detach().cpu().double()
                    for t in (y, xs.grad, ws.grad)]

        want = run("cpu", torch.float64)
        out[f"{h}x{wd}"] = {
            side: {n: float(f"{float((g - r).norm() / r.norm()):.3g}")
                   for n, g, r in zip(("fprop", "dgrad", "wgrad"),
                                      run(d, torch.float32), want)}
            for side, d in (("cpu", "cpu"), ("card", dev))}
    return out


def float64_referee(dev, cfg, batch, before, p_gpu, p_cpu, pos_cpu):
    """The same step once more on the CPU with the network in float64
    (every convolution, FrozenBN and GroupNorm; the loss and the GMM
    stay float32, the parameters and SGD too): its positive mask must be
    the float32 steps', and each float32 step, the card's and the CPU's,
    within the update limits of it. Two more card steps say where the
    card's error comes from: one with cuDNN off (PyTorch's own
    convolutions, TF32 off) and one with the towers' GroupNorm+ReLU
    forward the plain version in place of K3."""
    from paa_tpu_torch.modeling import build_detection_model, layers
    from paa_tpu_torch.ops import group_norm as gn

    model = build_detection_model(cfg, device="cpu", seed=0)
    for m in model.module.modules():
        if isinstance(m, layers.Conv):
            m.dtype = torch.float64
    _, pos64, before64, p64 = train_once(model, batch)
    check(all(torch.equal(before[n], before64[n]) for n in before)
          and torch.equal(pos64, pos_cpu),
          "train_card_vs_cpu: the float64 step's positives differ")
    torch.backends.cudnn.enabled = False
    try:
        _, _, _, p_native = train_once(
            build_detection_model(cfg, device=dev, seed=0), batch)
    finally:
        torch.backends.cudnn.enabled = True
    kernel = layers.group_norm_relu
    layers.group_norm_relu = lambda x, w, b, g, eps: gn.GroupNormReLU.apply(
        x, w, b, g, eps, gn.group_norm_relu_plain)
    try:
        _, _, _, p_plain_gn = train_once(
            build_detection_model(cfg, device=dev, seed=0), batch)
    finally:
        layers.group_norm_relu = kernel
    sides = {"card_f32": p_gpu, "cpu_f32": p_cpu,
             "card_f32_cudnn_off": p_native,
             "card_f32_plain_gn": p_plain_gn}
    out = {}
    for side, params in sides.items():
        norm, share = update_errors(params, p64, before)
        out[side] = {"worst_update_norm_err": norm[0],
                     "worst_update_share": share[0]}
        if side in ("card_f32", "cpu_f32"):
            check(norm[0][1] <= UPDATE_NORM_TOL
                  and share[0][1] <= UPDATE_SHARE_TOL,
                  f"train_card_vs_cpu: {side} against float64: "
                  f"{norm} {share}")
    # the norm error of every tensor that some side has above 1e-4, in
    # the module's order (sides as above)
    errs = {n: [update_norm_err(p[n], p64[n], before[n])
                for p in sides.values()] for n in before}
    out["norm_err_above_1e-4"] = {
        n: [float(f"{e:.3g}") for e in v] for n, v in errs.items()
        if max(v) > 1e-4}
    return out


def phase_train_timing(model, state, batch, name):
    """Step ms and img/s of the train step (CUDA events after 2 warm-up
    steps)."""
    step = model.make_bucket_train_step(HW)
    ms = cuda_step_ms(lambda: step(state, batch), 5)
    out = {"step_ms": ms, "img_per_s": TRAIN_BATCH / ms * 1e3}
    print(json.dumps({"metric": "train_step", "path": "paa_train",
                      "batch": TRAIN_BATCH, "hw": HW, "dtype": "bfloat16",
                      **out, "card": name}))
    return out


def cuda_step_ms(fn, reps, warmup=2):
    """ms per call of ``fn`` between CUDA events, host time included (no
    device-side sleep: a train step's host gaps are part of it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_train_profile(model, state, batch, name):
    """torch.profiler over three train steps. Each kernel goes to the
    innermost span around its launch (input: the batch's copy and
    normalize; forward, assignment, losses, backward, K3's backward
    recompute, optimizer; "other": outside every span), matched through
    the trace's launch correlation. Per span class: host ms in the span,
    the device window from its first kernel's start to its last's end in
    each occurrence, the device busy time in it and the windows' idle
    share; and the step's device busy time, wall time and idle share."""
    from torch.profiler import ProfilerActivity, profile

    from paa_tpu_torch.engine import train_step as ts
    from paa_tpu_torch.modeling import paa_loss as pl
    from paa_tpu_torch.ops import group_norm as gn

    spans_named = {ts.SPAN_INPUT: "input", ts.SPAN_FORWARD: "forward",
                   pl.SPAN_ASSIGN: "assignment", pl.SPAN_LOSSES: "losses",
                   ts.SPAN_BACKWARD: "backward",
                   gn.SPAN_BACKWARD: "gn_backward_recompute",
                   ts.SPAN_OPTIMIZER: "optimizer"}
    step = model.make_bucket_train_step(HW)
    step(state, batch)
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = trace_events(prof)
    spans = [(e["ts"], e["ts"] + e["dur"], spans_named[e["name"]])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in spans_named]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not kernels:
        print(json.dumps({"phase": "train_profile",
                          "device_time": "not measured", "card": name}))
        return

    def span_of(t):
        inside = [(b - a, a, label) for a, b, label in spans if a <= t <= b]
        return min(inside)[1:] if inside else (None, "other")

    per = {}  # (span occurrence start, label) -> kernel intervals
    by_kernel_class = {}
    for k in kernels:
        at = launched.get(k.get("args", {}).get("correlation"))
        occurrence = span_of(at) if at is not None else (None, "other")
        per.setdefault(occurrence, []).append((k["ts"], k["ts"] + k["dur"]))
        cls = kernel_class(k["name"])
        by_kernel_class[cls] = (by_kernel_class.get(cls, 0.0)
                                + k["dur"] / steps / 1e3)
    classes = {}
    for (_, label), iv in per.items():
        c = classes.setdefault(label, {"window_us": 0.0, "busy_us": 0.0})
        c["window_us"] += max(b for _, b in iv) - min(a for a, _ in iv)
        c["busy_us"] += _union_us(iv)
    host = {}
    for a, b, label in spans:
        host[label] = host.get(label, 0.0) + (b - a)
    out = {}
    for label, c in sorted(classes.items(), key=lambda kv: -kv[1]["busy_us"]):
        out[label] = {"host_ms": host.get(label, 0.0) / steps / 1e3,
                      "device_busy_ms": c["busy_us"] / steps / 1e3}
        if label != "other":  # one occurrence per span, not per step
            out[label].update(
                device_window_ms=c["window_us"] / steps / 1e3,
                idle_share=1.0 - c["busy_us"] / max(c["window_us"], 1e-9))
    busy = _union_us([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    print(json.dumps({
        "phase": "train_profile", "steps": steps, "batch": TRAIN_BATCH,
        "by_span": out, "device_busy_ms_per_step": busy / steps / 1e3,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "ms_per_step_by_kernel_class": dict(sorted(
            by_kernel_class.items(), key=lambda kv: -kv[1])),
        "card": name}))


def trace_events(prof):
    """The profile's events as its Chrome trace lists them (kernels carry
    the correlation id of the runtime call that launched them)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def _union_us(intervals):
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


BOX_SPAN = "box_head"  # record_function span around FasterRCNN.box
BOX_LABEL = "box head (ROIAlign + f32 MLP)"


def kernel_class(name):
    n = name.lower()
    classes = (
        ("nms_batched (K1)", ("nms_batched",)),
        ("nms_global (K2)", ("nms_global", "nms_cluster")),
        ("group_norm_relu (K3)", ("gn_relu",)),
        ("memcpy", ("memcpy", "memset")),
        ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
        ("convolution", ("conv", "xmma", "gemm", "fprop", "cudnn",
                         "cutlass", "implicit")),
        ("sort (top-k)", ("sort", "radix")),
        ("gather/scatter/index", ("scatter", "gather", "index")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    )
    for label, keys in classes:
        if any(k in n for k in keys):
            return label
    return "other"


def _profiled(model, eval_fn, images, sizes, reqs):
    """``reqs`` requests under torch.profiler, with the two-stage box
    head (``module.box``, when the model has one) inside a BOX_SPAN span.
    Returns the profile and the window's wall time in microseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    module = model.module
    box = getattr(module, "box", None)
    if box is not None:
        def traced_box(*args):
            with record_function(BOX_SPAN):
                return box(*args)
        module.box = traced_box
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reqs):
                eval_fn(images, sizes)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        if box is not None:
            del module.box
    return prof, wall_us


def phase_profile(model, eval_fn, seed, what, name):
    """Device time by kernel class over three requests (torch.profiler)
    and the device's idle share of that window (host clock). The kernels
    that the CPU ops inside the box head's span launched count as the
    box head, whatever their names."""
    from torch.autograd import DeviceType

    images, sizes = request(seed, BATCH, HW, SIZE)
    eval_fn(images, sizes)
    torch.cuda.synchronize()
    reqs = 3
    prof, wall_us = _profiled(model, eval_fn, images, sizes, reqs)
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != BOX_SPAN]
    if not kernels:
        print(json.dumps({"phase": "profile", "path": what,
                          "device_time": "not measured", "card": name}))
        return
    by_class, by_name, spans = {}, {}, []
    for e in kernels:
        ms = e.time_range.elapsed_us() / reqs / 1e3
        spans.append((e.time_range.start, e.time_range.end))
        label = kernel_class(e.name)
        by_class[label] = by_class.get(label, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    box_spans = [(e.time_range.start, e.time_range.end) for e in cpu
                 if e.name == BOX_SPAN]
    box_by_name = {}
    for e in cpu:  # each kernel is listed under the one op that launched it
        if any(a <= e.time_range.start <= b for a, b in box_spans):
            for k in e.kernels:
                if k.name != BOX_SPAN:
                    box_by_name[k.name] = (box_by_name.get(k.name, 0.0)
                                           + k.duration / reqs / 1e3)
    for k, ms in box_by_name.items():  # move them to the box head class
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) - ms
        by_class[BOX_LABEL] = by_class.get(BOX_LABEL, 0.0) + ms
    busy = _union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {
        "phase": "profile", "path": what, "requests": reqs, "batch": BATCH,
        "ms_per_request_by_class": dict(sorted(
            by_class.items(), key=lambda kv: -kv[1])),
        "device_busy_ms_per_request": busy / reqs / 1e3,
        "wall_ms_per_request": wall_us / reqs / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms": {k[:100]: v for k, v in top},
    }
    if box_spans:
        out["box_head"] = "not measured" if not box_by_name else {
            "kernels_ms": {k[:100]: v for k, v in sorted(
                box_by_name.items(), key=lambda kv: -kv[1])[:6]},
            "gemm_ms": sum(v for k, v in box_by_name.items()
                           if "gemm" in k.lower()),
        }
    print(json.dumps({**out, "card": name}))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paa_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    name = card()
    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"phase": "build", "nvcc_s": built,
                      "build_s": time.perf_counter() - t0,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    phase_nms(dev)
    phase_nms_global(dev)
    gn_err = phase_group_norm(dev)
    paa, paa_eval, paa_launches = phase_main_path(dev)
    phase_reference(dev)
    frcnn, frcnn_eval, frcnn_launches = phase_frcnn_main_path(dev)
    phase_frcnn_reference(dev)
    eval_launches = phase_eval_main_path(dev, name)
    phase_eval_card_vs_cpu(dev)
    phase_gn_grad(dev)
    trained, state, batch, train_launches = phase_train_main_path(dev, name)
    phase_train_reference(dev)
    k1, k3 = phase_timing(dev, paa, paa_eval, paa_launches, gn_err, name)
    k2, k1_rpn = phase_frcnn_timing(dev, frcnn, frcnn_eval, frcnn_launches,
                                    name)
    phase_train_timing(trained, state, batch, name)
    # K1 serves every inference path: its launches are the main paths'
    # runs, its times those at PAA's candidates, with the RPN's beside them
    by_path = {"paa": paa_launches["nms_batched"],
               "faster_rcnn": frcnn_launches["nms_batched"],
               "paa_eval": eval_launches["nms_batched"]}
    k1.update(launches=sum(by_path.values()), launches_by_path=by_path,
              faster_rcnn_rpn=k1_rpn)
    # K3 serves PAA's serving, eval and training paths: its times are per
    # serving forward (B=8), with the training forward's (B=16) beside
    by_path = {"paa": paa_launches["group_norm_relu"],
               "paa_train": train_launches["group_norm_relu"],
               "paa_eval": eval_launches["group_norm_relu"]}
    k3.update(launches=sum(by_path.values()), launches_by_path=by_path)
    phase_profile(paa, paa_eval, 30, "paa", name)
    phase_profile(frcnn, frcnn_eval, 60, "faster_rcnn", name)
    phase_train_profile(trained, state, batch, name)
    print(name)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

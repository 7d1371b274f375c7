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
   class-agnostic, with exact score ties and all-invalid rows. keep_idx
   and keep_valid equal, keep_scores bit-equal.
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
   same function, that call's time; for K2 and K3 the cluster size
   chosen and cudaOccupancyMaxActiveClusters for it.
10. A torch.profiler window of three requests of each path: device time
    per request by kernel class (the Faster R-CNN box head's kernels by
    a span around ``module.box``), and the device's idle share.

The line before the last is the ``kernels`` JSON; the card's name and
power limit (nvidia-smi) come on a line before it; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits with 2.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BATCH, HW, SIZE = 8, (800, 1344), (800.0, 1333.0)
TOWER_HW = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
SLEEP_CYCLES = 35_000_000  # ~20 ms at the H100's 1.755 GHz boost clock
GN_PER_LEVEL = 8  # 2 towers x 4 GroupNorm+ReLU
ROOT = os.path.dirname(os.path.abspath(__file__))
PAA_CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
FRCNN_CONFIG = os.path.join(ROOT, "configs",
                            "e2e_faster_rcnn_R_50_FPN_1x.yaml")
NMS_OPS = 18  # per valid candidate per step: argmax compare, IoU, suppress
# bytes read of every candidate (score, valid), of a valid one besides
# (box, label), and written per output slot (idx, score, valid)
NMS_BYTES_ALL, NMS_BYTES_VALID, NMS_BYTES_OUT = 4 + 1, 16 + 4, 4 + 4 + 1


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


def nms_bound(keep_valid, valid, max_out, real_n=None):
    """Least time for the NMS of this input. Each row runs its picks plus
    the step that finds it exhausted (at most max_out), and a step needs
    an IoU only for the row's valid candidates: ops against the f32 peak.
    Bytes against HBM: every real candidate's score and valid flag, the
    box and label of the valid ones, the outputs. ``real_n`` (per row)
    leaves out padding added to a row; invalid, it adds no operations."""
    steps = torch.clamp(keep_valid.sum(dim=1) + 1, max=max_out).cpu()
    n_valid = valid.sum(dim=1).cpu()
    if real_n is None:
        real_n = [valid.shape[1]] * valid.shape[0]
    nbytes = (sum(real_n) * NMS_BYTES_ALL + int(n_valid.sum())
              * NMS_BYTES_VALID + valid.shape[0] * max_out * NMS_BYTES_OUT)
    ops = int((steps * n_valid).sum()) * NMS_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return int(steps.sum()), 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def phase_nms(dev):
    from paa_tpu_torch.ops import nms

    for n in (5000, 77):
        args = nms_case(n, BATCH, n, dev)
        for class_aware in (True, False):
            got = nms.nms_batched(*args, 0.6, 100, class_aware)
            want = nms.nms_batched_plain(*args, 0.6, 100, class_aware)
            same_keeps(got, want, f"nms_batched N={n} "
                       f"class_aware={class_aware}")
            check(bool(got[2][0].any()) and not bool(got[2][-1].any()),
                  "nms_batched: unexpected valid pattern")
    print(json.dumps({"phase": "nms_vs_plain", "ok": True,
                      "cases": "B=8 N=5000,77 max_out=100 aware/agnostic"}))


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


def build_cfg(dtype, path):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(path)
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype])
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


def time_nms(entry, args, kernel_reps, what, real_n=None):
    """A kernel against its plain version on one input: bit-equal, then
    both timed; returns the timing fields of a kernels entry."""
    from paa_tpu_torch.ops import nms

    got = entry(*args)
    same_keeps(got, nms.nms_batched_plain(*args), what)
    steps, bound, by = nms_bound(got[2], args[3], args[5], real_n)
    return steps, got, {
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: entry(*args), kernel_reps),
        "plain_ms": cuda_ms(lambda: nms.nms_batched_plain(*args), 3, 1),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }


def phase_timing(dev, model, eval_fn, launches, gn_err, name):
    from paa_tpu_torch.modeling.paa_inference import paa_candidates
    from paa_tpu_torch.ops import group_norm as gn
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
    steps, got, timing = time_nms(nms.nms_batched, args, 20,
                                  "nms_batched on the PAA candidates")
    k1 = {
        "name": "nms_batched", "route": "cuda",
        "source": "paa_tpu_torch/csrc/nms_batched.cu",
        "replaces": "paa_tpu/ops/nms_pallas.py:191",
        "launches": launches["nms_batched"], **timing,
    }
    print(json.dumps({"kernel_detail": "nms_batched", "path": "paa",
                      "B": cand[1].shape[0], "N": cand[1].shape[1],
                      "steps": steps, "valid_picks": int(got[2].sum()),
                      "card": name}))

    # GroupNorm+ReLU: per forward, 8 launches at each tower shape
    gen = torch.Generator().manual_seed(5)
    s = (torch.rand(256, generator=gen) + 0.5).to(dev)
    b = (torch.randn(256, generator=gen) * 0.2).to(dev)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0}
    per_level = {}
    for h, w in TOWER_HW:
        x = torch.randn(BATCH, 256, h, w, generator=gen).to(
            dev, torch.bfloat16)
        ms = cuda_ms(lambda: gn.group_norm_relu(x, s, b), 50)
        plain = cuda_ms(lambda: gn.group_norm_relu_plain(x, s, b), 20)
        lib = cuda_ms(lambda: F.relu(F.group_norm(x, 32, s.to(x.dtype),
                                                  b.to(x.dtype), 1e-5)), 50)
        nbytes = 2 * x.numel() * x.element_size() + 2 * 256 * 4
        plan = gn.gn_plan(BATCH, 256, h * w, 32, x.element_size())
        per_level[f"{h}x{w}"] = {"ms": ms, "plain_ms": plain,
                                 "library_ms": lib,
                                 "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                                 "cs": plan.cs, "threads": plan.threads,
                                 "max_active_clusters":
                                     gn.gn_max_active_clusters(x)}
        totals["ms"] += GN_PER_LEVEL * ms
        totals["plain_ms"] += GN_PER_LEVEL * plain
        totals["library_ms"] += GN_PER_LEVEL * lib
        totals["bytes"] += GN_PER_LEVEL * nbytes
    k3 = {
        "name": "group_norm_relu", "route": "cuda",
        "source": "paa_tpu_torch/csrc/group_norm.cu",
        "replaces": "paa_tpu/ops/fused_gn.py:146",
        "launches": launches["group_norm_relu"], "max_abs_err": gn_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": 1e3 * totals["bytes"] / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": totals["library_ms"],
    }
    print(json.dumps({"kernel_detail": "group_norm_relu", "dtype":
                      "bfloat16", "per_launch_by_level": per_level,
                      "card": name}))
    return k1, k3


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
    steps, got, timing = time_nms(nms.nms_batched, args, 20,
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
                      "B": BATCH, "N": n, "steps": steps,
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
    steps, got, k1_rpn = time_nms(nms.nms_batched, rpn_args, 10,
                                  "nms_batched (K1) on the RPN rows", real_n)
    print(json.dumps({"kernel_detail": "nms_batched", "path": "faster_rcnn",
                      "rows": scores.shape[0], "N": scores.shape[1],
                      "max_out": max_out, "steps": steps,
                      "real_n_per_level": real_n[::BATCH],
                      "valid_per_row": [int(v) for v in valid.sum(dim=1)],
                      "valid_picks": int(got[2].sum()), **k1_rpn,
                      "card": name}))
    return k2, k1_rpn


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
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
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
    k1, k3 = phase_timing(dev, paa, paa_eval, paa_launches, gn_err, name)
    k2, k1_rpn = phase_frcnn_timing(dev, frcnn, frcnn_eval, frcnn_launches,
                                    name)
    # K1 serves both paths: its launches are the two main paths' runs,
    # its times those at PAA's candidates, with the RPN's beside them
    by_path = {"paa": paa_launches["nms_batched"],
               "faster_rcnn": frcnn_launches["nms_batched"]}
    k1.update(launches=sum(by_path.values()), launches_by_path=by_path,
              faster_rcnn_rpn=k1_rpn)
    phase_profile(paa, paa_eval, 30, "paa", name)
    phase_profile(frcnn, frcnn_eval, 60, "faster_rcnn", name)
    print(name)
    print(json.dumps({"kernels": [k1, k2, k3]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (paa_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. Build the CUDA kernels from paa_tpu_torch/csrc (nvcc, sm_90a) and
   compile the Triton kernel.
2. The batched NMS kernel against its plain PyTorch version on the card:
   B=8, N=5000, max_out=100, IoU 0.6, class-aware and class-agnostic,
   with exact score ties and all-invalid rows. keep_idx and keep_valid
   equal, keep_scores bit-equal.
3. The GroupNorm+ReLU kernel against its plain version at the five tower
   shapes of an 8 x 800 x 1344 batch: float32 (TF32 off) within 1e-5,
   bfloat16 within one bf16 ulp (plus 1e-6 near zero).
4. The main path: PAA-R50 (configs/paa/paa_R_50_FPN_1x.yaml, full width,
   80 classes) in bfloat16 with weights from a seed serves three requests
   of 8 x 800 x 1344 uint8 images through ``make_eval_fn``. Checks shapes,
   finiteness, boxes inside the image, detections > 0, and that the launch
   counts show both kernels on the path (NMS once and GroupNorm 40 times
   per request).
5. The same model in float32 on the card (TF32 off) against the same
   model on the CPU, whose wrappers take the plain versions, at a small
   input: head outputs and detections agree.
6. Timing on the card (CUDA events): end-to-end img/s, and per forward
   each kernel's time beside its plain version's, its bound and, where
   one PyTorch call computes the same function, that call's time.
7. A torch.profiler window of three requests: device time per request by
   kernel class, and the device's idle share.

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
GN_PER_LEVEL = 8  # 2 towers x 4 GroupNorm+ReLU


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


def nms_case(seed, bsz, n, dev):
    """Boxes over an 800 x 1333 image with heavy overlap, exact score
    ties and one all-invalid row."""
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


def phase_nms(dev):
    from paa_tpu_torch.ops import nms

    for n in (5000, 77):
        args = nms_case(n, BATCH, n, dev)
        for class_aware in (True, False):
            got = nms.nms_batched(*args, 0.6, 100, class_aware)
            want = nms.nms_batched_plain(*args, 0.6, 100, class_aware)
            for g, w, name in zip(got, want, ("keep_idx", "keep_scores",
                                             "keep_valid")):
                check(g.dtype == w.dtype and torch.equal(g, w),
                      f"nms_batched kernel != plain: {name}, N={n}, "
                      f"class_aware={class_aware}")
            check(bool(got[2][0].any()) and not bool(got[2][-1].any()),
                  "nms_batched: unexpected valid pattern")
    print(json.dumps({"phase": "nms_vs_plain", "ok": True,
                      "cases": "B=8 N=5000,77 max_out=100 aware/agnostic"}))


def _bf16_ulp(x):
    mag = x.abs().clamp(min=torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def phase_group_norm(dev):
    from paa_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False  # f32 compare: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    worst = {}
    for h, w in TOWER_HW:
        x = (torch.randn(BATCH, 256, h, w, generator=gen) * 1.5 + 0.4).to(dev)
        s = (torch.rand(256, generator=gen) + 0.5).to(dev)
        b = (torch.randn(256, generator=gen) * 0.2).to(dev)
        got = gn.group_norm_relu(x, s, b)
        err32 = float((got - gn.group_norm_relu_plain(x, s, b)).abs().max())
        check(err32 <= 1e-5, f"group_norm_relu f32 {h}x{w}: err {err32}")
        xb = x.to(torch.bfloat16)
        got = gn.group_norm_relu(xb, s, b).float()
        want = gn.group_norm_relu_plain(xb, s, b).float()
        err = (got - want).abs()
        ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
        check(bool((err <= ulp + 1e-6).all()),
              f"group_norm_relu bf16 {h}x{w}: beyond one ulp, max err "
              f"{float(err.max())}")
        worst[f"{h}x{w}"] = {"f32": err32, "bf16": float(err.max())}
    print(json.dumps({"phase": "group_norm_vs_plain", "ok": True,
                      "max_abs_err": worst}))
    return max(v["bf16"] for v in worst.values())


def build_cfg(dtype):
    from paa_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "paa", "paa_R_50_FPN_1x.yaml"))
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", dtype])
    cfg.freeze()
    return cfg


def seeded_model(dtype, device):
    """Full-width PAA-R50 with weights from seed 0 and the cls_logits bias
    drawn from seed 1 around the 0.05 threshold (logit -2.944), so that
    an untrained net yields candidates."""
    from paa_tpu_torch.modeling import build_detection_model

    model = build_detection_model(build_cfg(dtype), device=device, seed=0)
    gen = torch.Generator().manual_seed(1)
    bias = model.module.head.cls_logits.bias
    with torch.no_grad():
        bias.copy_(torch.empty(bias.shape).uniform_(-3.5, -2.5,
                                                    generator=gen))
    return model


def request(seed, bsz, hw, size):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *hw, 3)).astype(np.uint8)
    sizes = np.tile(np.asarray(size, np.float32), (bsz, 1))
    return torch.from_numpy(images), torch.from_numpy(sizes)


def phase_main_path(dev):
    from paa_tpu_torch.ops import group_norm, nms

    model = seeded_model("bfloat16", dev)
    eval_fn = model.make_eval_fn()
    reqs = [request(10 + i, BATCH, HW, SIZE) for i in range(3)]
    nms.nms_batched.launches = 0
    group_norm.group_norm_relu.launches = 0
    times, dets = [], []
    for images, sizes in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = eval_fn(images, sizes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        dets.append(det)
    launches = {"nms_batched": nms.nms_batched.launches,
                "group_norm_relu": group_norm.group_norm_relu.launches}
    check(launches == {"nms_batched": 3, "group_norm_relu": 120},
          f"main path launches {launches}, expected NMS 1 and GroupNorm "
          f"40 per request")
    n_valid = []
    for det in dets:
        check(tuple(det["boxes"].shape) == (BATCH, 100, 4)
              and tuple(det["scores"].shape) == (BATCH, 100)
              and tuple(det["labels"].shape) == (BATCH, 100)
              and tuple(det["valid"].shape) == (BATCH, 100),
              "main path: detection shapes")
        boxes, valid = det["boxes"], det["valid"]
        check(bool(torch.isfinite(boxes).all())
              and bool(torch.isfinite(det["scores"]).all()),
              "main path: non-finite output")
        vb = boxes[valid]
        # score voting averages clipped boxes: a few float32 ulps of slack
        slack = 1e-3
        check(bool((vb >= 0).all())
              and bool((vb[:, 0::2] <= SIZE[1] - 1 + slack).all())
              and bool((vb[:, 1::2] <= SIZE[0] - 1 + slack).all()),
              "main path: boxes outside the image")
        s = det["scores"][valid]
        check(bool((s > 0).all()) and bool((s <= 1).all()),
              "main path: scores out of range")
        labels = det["labels"][valid]
        check(bool((labels >= 1).all()) and bool((labels <= 80).all()),
              "main path: labels out of range")
        n_valid.append(int(valid.sum()))
    check(min(n_valid) > 0, f"main path: no detections {n_valid}")
    print(json.dumps({"phase": "main_path", "ok": True, "requests": 3,
                      "batch": BATCH, "hw": HW, "launches": launches,
                      "valid_detections": n_valid,
                      "request_s": times}))
    return model, eval_fn, launches


def phase_reference(dev):
    """The f32 model on the card against the same model on the CPU (plain
    versions) at a small input."""
    from paa_tpu_torch.ops.image_norm import device_normalize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, sizes = request(99, 2, (256, 320), (256.0, 300.0))
    outs, dets = [], []
    for device in (dev, "cpu"):
        model = seeded_model("float32", device)
        x = device_normalize(images.to(device), sizes.to(device),
                             model.cfg.INPUT.PIXEL_MEAN,
                             model.cfg.INPUT.PIXEL_STD)
        with torch.inference_mode():
            outs.append({k: v.float().cpu() for k, v in model.module(
                x.permute(0, 3, 1, 2).contiguous()).items()})
        dets.append({k: v.cpu() for k, v in
                     model.make_eval_fn()(images, sizes).items()})
    errs = {}
    for k, want in outs[1].items():
        errs[k] = float((outs[0][k] - want).abs().max()
                        / want.abs().max())
        check(errs[k] <= 1e-3, f"reference: head output {k} rel err "
              f"{errs[k]}")
    gpu, cpu = dets
    matched = total = 0
    for i in range(2):
        gv, cv = gpu["valid"][i], cpu["valid"][i]
        for box, label in zip(gpu["boxes"][i][gv], gpu["labels"][i][gv]):
            total += 1
            same = cpu["labels"][i][cv] == label
            d = (cpu["boxes"][i][cv][same] - box).abs().amax(dim=1)
            matched += int(d.numel() > 0 and float(d.min()) <= 0.5)
    n_cpu = int(cpu["valid"].sum())
    check(total > 0 and abs(total - n_cpu) <= 0.05 * n_cpu
          and matched >= 0.95 * total,
          f"reference: {matched}/{total} card detections matched, "
          f"{n_cpu} on the CPU")
    print(json.dumps({"phase": "card_vs_cpu", "ok": True, "hw": [256, 320],
                      "head_rel_err": errs, "detections": total,
                      "matched": matched, "cpu_detections": n_cpu}))


def phase_timing(dev, model, eval_fn, launches, gn_err, name):
    from paa_tpu_torch.modeling.paa_inference import paa_candidates
    from paa_tpu_torch.ops import group_norm as gn
    from paa_tpu_torch.ops import nms
    from paa_tpu_torch.ops.image_norm import device_normalize

    images, sizes = request(20, BATCH, HW, SIZE)
    eval_fn(images, sizes)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        eval_fn(images, sizes)
    torch.cuda.synchronize()
    e2e_s = (time.perf_counter() - t0) / reps
    print(json.dumps({"metric": "e2e_img_per_s", "value": BATCH / e2e_s,
                      "batch": BATCH, "hw": HW, "dtype": "bfloat16",
                      "request_ms": e2e_s * 1e3, "card": name}))

    # NMS at the main path's own candidates
    images, sizes = images.to(dev), sizes.to(dev)
    with torch.inference_mode():
        x = device_normalize(images, sizes, model.cfg.INPUT.PIXEL_MEAN,
                             model.cfg.INPUT.PIXEL_STD)
        outputs = model.module(x.permute(0, 3, 1, 2).contiguous())
        anchors, counts = model.anchors_for(HW)
        cand = paa_candidates(outputs, sizes, anchors, counts,
                              model.postprocess_config())
    args = (*cand, 0.6, 100, True)
    got = nms.nms_batched(*args)
    want = nms.nms_batched_plain(*args)
    for g, w in zip(got, want):
        check(torch.equal(g, w), "nms_batched kernel != plain on the main "
              "path's candidates")
    bsz, n = cand[1].shape
    steps = int(torch.clamp(got[2].sum(dim=1) + 1, max=100).sum())
    nms_bytes = bsz * n * (16 + 4 + 4 + 1) + bsz * 100 * (4 + 4 + 1)
    nms_ops = steps * n * 18  # argmax compare + IoU + suppress per step
    nms_bound = 1e3 * max(nms_bytes / HBM_BYTES_PER_S,
                          nms_ops / F32_OPS_PER_S)
    k1 = {
        "name": "nms_batched", "route": "cuda",
        "source": "paa_tpu_torch/csrc/nms_batched.cu",
        "replaces": "paa_tpu/ops/nms_pallas.py:191",
        "launches": launches["nms_batched"], "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: nms.nms_batched(*args), 20),
        "plain_ms": cuda_ms(lambda: nms.nms_batched_plain(*args), 3, 1),
        "bound_ms": nms_bound,
        "bound_by": ("bytes" if nms_bytes / HBM_BYTES_PER_S
                     >= nms_ops / F32_OPS_PER_S else "operations"),
        "library_ms": None,
    }
    print(json.dumps({"kernel_detail": "nms_batched", "B": bsz, "N": n,
                      "steps": steps, "valid_picks":
                      int(got[2].sum()), "card": name}))

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
        per_level[f"{h}x{w}"] = {"ms": ms, "plain_ms": plain,
                                 "library_ms": lib,
                                 "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        totals["ms"] += GN_PER_LEVEL * ms
        totals["plain_ms"] += GN_PER_LEVEL * plain
        totals["library_ms"] += GN_PER_LEVEL * lib
        totals["bytes"] += GN_PER_LEVEL * nbytes
    k3 = {
        "name": "group_norm_relu", "route": "triton",
        "source": "paa_tpu_torch/ops/group_norm.py",
        "replaces": "paa_tpu/ops/fused_gn.py:146",
        "launches": launches["group_norm_relu"], "max_abs_err": gn_err,
        "ms": totals["ms"], "plain_ms": totals["plain_ms"],
        "bound_ms": 1e3 * totals["bytes"] / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": totals["library_ms"],
    }
    print(json.dumps({"kernel_detail": "group_norm_relu", "dtype":
                      "bfloat16", "per_launch_by_level": per_level,
                      "card": name}))
    return [k1, k3]


def kernel_class(name):
    n = name.lower()
    classes = (
        ("nms_batched (K1)", ("nms_batched",)),
        ("group_norm_relu (K3)", ("gn_relu",)),
        ("memcpy", ("memcpy", "memset")),
        ("layout transposes", ("nchwtonhwc", "nhwctonchw", "transpose")),
        ("convolution", ("conv", "xmma", "gemm", "fprop", "cudnn",
                         "cutlass", "implicit")),
        ("sort (top-k tier)", ("sort", "radix")),
        ("gather/scatter/index", ("scatter", "gather", "index")),
        ("reductions", ("reduce",)),
        ("elementwise", ("elementwise", "vectorized", "unrolled")),
    )
    for label, keys in classes:
        if any(k in n for k in keys):
            return label
    return "other"


def phase_profile(eval_fn, name):
    """Device time by kernel class over three requests (torch.profiler)
    and the device's idle share of that window (host clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    images, sizes = request(30, BATCH, HW, SIZE)
    eval_fn(images, sizes)
    torch.cuda.synchronize()
    reqs = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reqs):
            eval_fn(images, sizes)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(json.dumps({"phase": "profile", "device_time": "not measured",
                          "card": name}))
        return
    by_class, by_name, spans = {}, {}, []
    for e in kernels:
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        label = kernel_class(e.name)
        by_class[label] = by_class.get(label, 0.0) + us / reqs / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + us / reqs / 1e3
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "phase": "profile", "requests": reqs, "batch": BATCH,
        "ms_per_request_by_class": dict(sorted(
            by_class.items(), key=lambda kv: -kv[1])),
        "device_busy_ms_per_request": busy / reqs / 1e3,
        "wall_ms_per_request": wall_us / reqs / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms": {k[:100]: v for k, v in top},
        "card": name,
    }))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paa_tpu_torch.ops import _build
    from paa_tpu_torch.ops import group_norm

    dev = torch.device("cuda", 0)
    name = card()
    t0 = time.perf_counter()
    built = _build.build_all()
    t1 = time.perf_counter()
    x = torch.ones(1, 32, 2, 2, device=dev)
    group_norm.group_norm_relu(x, torch.ones(32, device=dev),
                               torch.zeros(32, device=dev))
    torch.cuda.synchronize()
    print(json.dumps({"phase": "build", "nvcc_s": built,
                      "build_s": t1 - t0,
                      "triton_compile_s": time.perf_counter() - t1,
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    phase_nms(dev)
    gn_err = phase_group_norm(dev)
    model, eval_fn, launches = phase_main_path(dev)
    phase_reference(dev)
    kernels = phase_timing(dev, model, eval_fn, launches, gn_err, name)
    phase_profile(eval_fn, name)
    print(name)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

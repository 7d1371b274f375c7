"""Train-step profile of the port (port of tools/profile_train_step.py).

    python -m paa_tpu_torch.tools.profile_train_step \\
        [--config-file configs/paa/paa_R_50_FPN_1x.yaml] [--batch N] \\
        [--hw 800 1344] [--steps 3] [--top 25] [--device cpu] \\
        [KEY VALUE ...]

Builds the config's model in bfloat16 (TPU.COMPUTE_DTYPE; a trailing
``KEY VALUE`` may set it back) with weights from seed 0, its SGD train
state and one synthetic batch of ``--batch`` images (default the
config's SOLVER.IMS_PER_BATCH): uint8 pixels, 3-12 GT boxes per image
in TPU.MAX_GT slots, with octagon masks or keypoints where the model
trains on them. It warms the train step up, times ``--steps`` steps
(CUDA events on the card, the host clock on the CPU), counts one step's
FLOPs (``torch.utils.flop_counter.FlopCounterMode``: convolutions and
matrix products, forward and backward), then profiles ``--steps`` steps
with ``torch.profiler``. It prints:

- step ms and img/s; TFLOP/step and TFLOP/s, and the share of the
  card's published bf16 peak where the card is one whose peak it knows;
- device-busy ms per step and the device's idle share of the wall;
- per span of the step (engine/train_step.py's input, forward, backward
  and optimizer; the forward's body, FPN and head, and the DCN forward;
  the loss's assignment and losses; K3's and the DCN's backward
  recompute; the two-stage spans; the host reads ``sync/h2d_copy`` and
  ``sync/gmm_converged``): host ms, host ms outside any span
  nested in it ("self"), and device-busy ms of the kernels launched in
  it (each kernel counts in the innermost span around its launch,
  matched through the trace's launch correlation; "other": outside
  every span);
- device ms per step by kernel class (``kernel_class``: K1/K2/K3 by
  name, convolution, GEMM, copy/layout, sort, gather/scatter, reduction,
  elementwise, other) and the ``--top`` kernels.

The last line is the result as JSON, with the kernels' launches over
the whole run (K3 in the towers' forward). Device numbers are "not
measured" on the CPU. Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np

# published dense bf16 peaks (NVIDIA's data sheets), by the device name
# torch reports; other cards print no share
BF16_PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
KERNEL_CLASSES = (
    ("nms_batched (K1)", ("nms_batched",)),
    ("nms_global (K2)", ("nms_global", "nms_cluster")),
    ("group_norm_relu (K3)", ("gn_relu",)),
    ("copy/layout", ("memcpy", "memset", "nchwtonhwc", "nhwctonchw",
                     "transpose")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit",
                     "cudnn")),
    ("GEMM", ("gemm", "gemv", "xmma", "cutlass")),
    ("sort (top-k)", ("sort", "radix")),
    ("gather/scatter/index", ("scatter", "gather", "index")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_class(name):
    """The class of a device kernel (or memcpy/memset) by its name."""
    n = name.lower()
    for label, keys in KERNEL_CLASSES:
        if any(k in n for k in keys):
            return label
    return "other"


def train_spans():
    """{record_function name: label} of every span a train step opens."""
    from ..engine import train_step as ts
    from ..modeling import atss_loss, detector, fcos_loss, fpn
    from ..modeling import paa_loss as pl
    from ..modeling import retinanet_head
    from ..modeling import two_stage as two
    from ..ops import dcn, gmm, image_norm
    from ..ops import group_norm as gn

    spans = {ts.SPAN_INPUT: "input", ts.SPAN_FORWARD: "forward",
             fpn.SPAN_BODY: "body", fpn.SPAN_FPN: "fpn",
             detector.SPAN_HEAD: "head",
             dcn.SPAN_FORWARD: "dcn_forward",
             ts.SPAN_BACKWARD: "backward",
             gn.SPAN_BACKWARD: "gn_backward_recompute",
             dcn.SPAN_BACKWARD: "dcn_backward_recompute",
             ts.SPAN_OPTIMIZER: "optimizer",
             image_norm.SPAN_SYNC_H2D: image_norm.SPAN_SYNC_H2D,
             gmm.SPAN_SYNC_CONVERGED: gmm.SPAN_SYNC_CONVERGED}
    for span in (two.SPAN_RPN_LOSS, two.SPAN_PROPOSALS,
                 two.SPAN_ROI_SAMPLING, two.SPAN_BOX_HEAD,
                 two.SPAN_BOX_LOSS, two.SPAN_MASK_HEAD,
                 two.SPAN_MASK_TARGETS, two.SPAN_MASK_LOSS,
                 two.SPAN_KEYPOINT_HEAD, two.SPAN_KEYPOINT_LOSS):
        spans[span] = span.split("/")[1]
    for loss in (pl, atss_loss, fcos_loss, retinanet_head):
        spans.update({loss.SPAN_ASSIGN: "assignment",
                      loss.SPAN_LOSSES: "losses"})
    return spans


def trace_events(prof):
    """The profile's events as its Chrome trace lists them (kernels carry
    the correlation id of the runtime call that launched them)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def union_us(intervals):
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_ms(fn, reps, device, warmup=2):
    """ms per call of ``fn`` after ``warmup`` calls: between CUDA events
    on the card (host time included), on the host clock otherwise."""
    import torch

    for _ in range(warmup):
        fn()
    _synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def step_flops(step, state, batch):
    """FLOPs of one call of ``step(state, batch)`` (one more update of
    ``state``): convolutions and matrix products, forward and
    backward."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    return counter.get_total_flops()


def profile_steps(step, state, batch, device, steps=3, top=25):
    """torch.profiler over ``steps`` calls of ``step(state, batch)``
    after one warm-up call. Returns a dict: steps, batch, hw, by_span
    ({label: host_ms, host_self_ms, and with device time device_busy_ms,
    device_window_ms (from the first kernel's start to the last's end in
    each occurrence) and idle_share}), wall_ms_per_step, and either
    device_time "not measured" (no kernel in the trace) or
    device_busy_ms_per_step, device_idle_share,
    ms_per_step_by_kernel_class and top_kernels_ms. Every ms is per
    step."""
    from torch.profiler import ProfilerActivity, profile

    spans_named = train_spans()
    step(state, batch)
    _synchronize(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch)
        _synchronize(device)
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
    images = batch["images"]
    result = {"steps": steps, "batch": int(images.shape[0]),
              "hw": [int(d) for d in images.shape[1:3]]}

    def span_of(t):
        inside = [(b - a, a, label) for a, b, label in spans if a <= t <= b]
        return min(inside)[1:] if inside else (None, "other")

    host, host_self = {}, {}
    for a, b, label in spans:
        nested = [(c, d) for c, d, _ in spans
                  if a <= c and d <= b and (c, d) != (a, b)]
        host[label] = host.get(label, 0.0) + (b - a)
        host_self[label] = (host_self.get(label, 0.0) + (b - a)
                            - union_us(nested))
    per = {}  # (span occurrence start, label) -> kernel intervals
    by_kernel_class, by_name = {}, {}
    for k in kernels:
        at = launched.get(k.get("args", {}).get("correlation"))
        occurrence = span_of(at) if at is not None else (None, "other")
        per.setdefault(occurrence, []).append((k["ts"], k["ts"] + k["dur"]))
        ms = k["dur"] / steps / 1e3
        cls = kernel_class(k["name"])
        by_kernel_class[cls] = by_kernel_class.get(cls, 0.0) + ms
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + ms
    classes = {}
    for (_, label), iv in per.items():
        c = classes.setdefault(label, {"window_us": 0.0, "busy_us": 0.0})
        c["window_us"] += max(b for _, b in iv) - min(a for a, _ in iv)
        c["busy_us"] += union_us(iv)
    by_span = {}
    for label in sorted(set(host) | set(classes),
                        key=lambda s: -classes.get(s, {}).get("busy_us", 0)):
        out = by_span[label] = {}
        if label in host:
            out.update(host_ms=host[label] / steps / 1e3,
                       host_self_ms=host_self[label] / steps / 1e3)
        if label in classes:
            c = classes[label]
            out["device_busy_ms"] = c["busy_us"] / steps / 1e3
            if label != "other":  # one occurrence per span, not per step
                out.update(
                    device_window_ms=c["window_us"] / steps / 1e3,
                    idle_share=1.0 - c["busy_us"] / max(c["window_us"],
                                                        1e-9))
    result.update(by_span=by_span, wall_ms_per_step=wall_us / steps / 1e3)
    if not kernels:
        result["device_time"] = "not measured"
        return result
    busy = union_us([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    result.update(
        device_busy_ms_per_step=busy / steps / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        ms_per_step_by_kernel_class=dict(sorted(
            by_kernel_class.items(), key=lambda kv: -kv[1])),
        top_kernels_ms=dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:top]))
    return result


def _num_classes(model):
    from ..modeling.detector import DENSE_HEADS

    cfg = model.cfg
    if model.head_type in DENSE_HEADS:
        return cfg.MODEL[DENSE_HEADS[model.head_type][0]].NUM_CLASSES
    return cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES


def synthetic_batch(model, bsz, hw, seed=0):
    """A batch in the loader's contract for ``model``'s train step:
    uint8 images of content ``hw``, 3-12 GT boxes per image (sqrt(area)
    log-uniform in 16 px to 0.6 of the shorter side, aspect ratio 1/2-2,
    labels among the model's classes) in TPU.MAX_GT slots, and where the
    step reads them each GT's octagon mask (data/synth.py) or 17
    keypoints inside its box."""
    import torch

    from ..data.synth import box_keypoints, box_octagon
    from ..structures.masks import rasterize_instances

    rng = np.random.RandomState(seed)
    h, w = hw
    max_gt = model.cfg.TPU.MAX_GT
    images = rng.randint(0, 256, (bsz, h, w, 3)).astype(np.uint8)
    boxes = np.zeros((bsz, max_gt, 4), np.float32)
    labels = np.zeros((bsz, max_gt), np.int32)
    for b in range(bsz):
        n = min(rng.randint(3, 13), max_gt)
        side = np.exp(rng.uniform(np.log(16), np.log(0.6 * min(h, w)), n))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        bw, bh = side * np.sqrt(aspect), side / np.sqrt(aspect)
        x1 = rng.uniform(0, w - 1 - bw)
        y1 = rng.uniform(0, h - 1 - bh)
        boxes[b, :n] = np.stack([x1, y1, x1 + bw, y1 + bh], axis=1)
        labels[b, :n] = rng.randint(1, _num_classes(model), n)
    batch = {"images": torch.from_numpy(images),
             "image_sizes": torch.tensor([[float(h), float(w)]] * bsz),
             "gt_boxes": torch.from_numpy(boxes),
             "gt_labels": torch.from_numpy(labels)}
    keys = model.train_batch_keys
    valid = [boxes[b, :int((labels[b] > 0).sum())] for b in range(bsz)]
    if "gt_masks" in keys:
        batch["gt_masks"] = torch.from_numpy(np.stack([
            rasterize_instances(
                [[box_octagon(x1, y1, x2 - x1, y2 - y1)[0]]
                 for x1, y1, x2, y2 in v], v, max_gt) for v in valid]))
    if "gt_keypoints" in keys:
        kps = np.zeros((bsz, max_gt, 17, 3), np.float32)
        for b, v in enumerate(valid):
            for g, (x1, y1, x2, y2) in enumerate(v):
                kps[b, g] = np.reshape(
                    box_keypoints(rng, x1, y1, x2 - x1, y2 - y1)[0], (17, 3))
        batch["gt_keypoints"] = torch.from_numpy(kps)
    return batch


def build(config_file, opts=(), device=None):
    """The config (bfloat16 unless ``opts`` say otherwise), its model on
    ``device`` (None: the card) with weights from seed 0, and the train
    state."""
    from ..config import get_cfg

    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.MODEL.WEIGHT = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return (cfg, *model_and_state(cfg, device))


def model_and_state(cfg, device=None):
    """``cfg``'s model on ``device`` (None: the card) with weights from
    seed 0, and its SGD train state."""
    from ..engine import TrainState
    from ..modeling import build_detection_model
    from ..solver import make_optimizer

    model = build_detection_model(cfg, device=device)
    return model, TrainState(model.module,
                             make_optimizer(cfg, model.module)[0])


def _print_tables(r, top):
    print(f"\n== spans (ms per step; wall {r['wall_ms_per_step']:.2f}) ==")
    print(f"{'host':>9} {'self':>9} {'device':>9}  span")
    for label, s in r["by_span"].items():
        device = s.get("device_busy_ms")
        print(f"{s.get('host_ms', 0.0):9.2f} {s.get('host_self_ms', 0.0):9.2f}"
              f" {'-' if device is None else f'{device:.2f}':>9}  {label}")
    if r.get("device_time") == "not measured":
        print("\ndevice time: not measured (no kernel in the trace)")
        return
    total = sum(r["ms_per_step_by_kernel_class"].values())
    print(f"\ndevice busy {r['device_busy_ms_per_step']:.2f} ms per step, "
          f"idle share {r['device_idle_share']:.3f} of the wall")
    print("\n== device ms per step by kernel class ==")
    for cls, ms in r["ms_per_step_by_kernel_class"].items():
        print(f"{ms:9.3f}  {100 * ms / total:5.1f}%  {cls}")
    print(f"\n== top {top} device kernels (ms per step) ==")
    for name, ms in r["top_kernels_ms"].items():
        print(f"{ms:9.3f}  [{kernel_class(name)}] {name[:120]}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch train-step profile")
    parser.add_argument("--config-file",
                        default="configs/paa/paa_R_50_FPN_1x.yaml")
    parser.add_argument("--batch", type=int, default=None,
                        help="images per step (default: "
                             "SOLVER.IMS_PER_BATCH)")
    parser.add_argument("--hw", type=int, nargs=2, default=(800, 1344))
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", nargs=argparse.REMAINDER,
                        help="KEY VALUE config overrides")
    args = parser.parse_args(argv)

    import torch

    from ..ops import launch_counts

    cfg, model, state = build(args.config_file, args.opts, args.device)
    device = model.device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    hw = tuple(args.hw)
    bsz = args.batch or cfg.SOLVER.IMS_PER_BATCH
    print(f"config: {args.config_file}  overrides: {args.opts}  "
          f"device: {name}  B={bsz} {hw} {cfg.TPU.COMPUTE_DTYPE}")
    batch = synthetic_batch(model, bsz, hw)
    step = model.make_bucket_train_step(hw)
    before = launch_counts()
    ms = step_ms(lambda: step(state, batch), args.steps, device)
    flops = step_flops(step, state, batch)
    result = profile_steps(step, state, batch, device, args.steps, args.top)
    result.update(
        config=args.config_file, opts=list(args.opts), device=name,
        dtype=cfg.TPU.COMPUTE_DTYPE,
        step_ms=ms, step_clock="cuda_events" if device.type == "cuda"
        else "host", img_per_s=bsz / ms * 1e3, flops_per_step=flops,
        tflop_per_s=flops / ms / 1e9,
        launches={k: v - before[k] for k, v in launch_counts().items()})
    peak = BF16_PEAK_FLOPS.get(name)
    if peak and cfg.TPU.COMPUTE_DTYPE == "bfloat16":
        result["share_of_bf16_peak"] = flops / (ms / 1e3) / peak
    print(f"step {ms:.2f} ms ({result['step_clock']} clock), "
          f"{result['img_per_s']:.2f} img/s; {flops / 1e12:.3f} TFLOP/step, "
          f"{result['tflop_per_s']:.2f} TFLOP/s"
          + (f" = {100 * result['share_of_bf16_peak']:.1f}% of the "
             f"{name}'s {peak / 1e12:.0f} TFLOP/s bf16 peak"
             if "share_of_bf16_peak" in result else ""))
    _print_tables(result, args.top)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

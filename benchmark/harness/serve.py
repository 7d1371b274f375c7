"""Serving cells: one client in a closed loop, each call a batch of
uint8 host images through the program's ``make_eval_fn`` entry, its
detections copied back to the host before the next call is sent.

Set-up builds the model, loads the seeded weights, draws the pool of
batches and calls the entry once on each of them (the first call alone
is timed apart). The window then sends the pool's batches in turn for
``--seconds``; the call in flight at the end finishes and counts. With
``--trace 1`` the window is ``trace_calls`` calls under
``torch.profiler`` instead.

Correctness, once the window has closed and the peak memory is read:
the program's head outputs of every pool batch are read through the
same entry (a forward hook on its module), the program is freed, and
the plain reference (float32, TF32 off) computes the head outputs of
the same images from the same weights, in blocks of images; the
reference's post-processing of the program's head outputs then judges
the detections of every call of the window.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.profiler import record_function

from . import checks, program, weights as W
from .tracemath import load_trace
from ..reference import boxes as ref_boxes
from ..reference import model as ref_model
from ..reference import postprocess as ref_post

HEAD_KEYS = ("cls_logits", "box_regression", "iou_pred")


def _host(out):
    with record_function("bench/readback"):
        return {k: v.cpu() for k, v in out.items()}


def run(cell, seed, seconds, trace, device, t0, log):
    cfg, tr = cell.config, cell.traffic
    shapes = reference_shapes(cfg["reference"])
    wts = W.make_weights(shapes, cfg["weights"], seed, device)
    model = program.build_model(cfg, wts, device)
    eval_fn = model.make_eval_fn()
    pool = W.image_pool(tr, seed, device)

    t = time.perf_counter()
    _host(eval_fn(*pool[0]))
    log(f"first call {time.perf_counter() - t:.3f} s")
    for images, sizes in pool[1:]:
        _host(eval_fn(images, sizes))
    captures = {}
    if trace:
        captures["nms_batched"] = capture_nms(eval_fn, pool)
    launches0 = program.launch_counts()
    setup_s = time.perf_counter() - t0

    calls, outputs, latency = [], [], []
    # the K3 roofline reads its ops' input shapes
    with profiler(device, trace, record_shapes=True) as prof:
        w0 = time.perf_counter()
        with record_function("bench/window"):
            while not window_done(trace, w0, seconds, len(calls),
                                  tr["trace_calls"]):
                k = len(calls) % len(pool)
                images, sizes = pool[k]
                sent = time.perf_counter()
                with record_function("bench/call"):
                    out = _host(eval_fn(images, sizes))
                latency.append(time.perf_counter() - sent)
                calls.append(k)
                outputs.append(out)
        window_s = time.perf_counter() - w0
    events = load_trace(prof) if trace else None
    launches = {k: v - launches0[k]
                for k, v in program.launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    images_served = len(calls) * tr["batch"]
    log(f"window {window_s:.3f} s, {len(calls)} calls, "
        f"{images_served} images; launches {launches}")

    # the program's head outputs of each pool batch, through its entry
    heads = []
    hook = model.module.register_forward_hook(
        lambda m, i, o: heads.append({k: o[k].cpu() for k in HEAD_KEYS}))
    for images, sizes in pool:
        _host(eval_fn(images, sizes))
    hook.remove()
    del model, eval_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, detail, failed = judge(cell, wts, pool, heads, calls, outputs,
                                    device)
    return {
        "setup_s": setup_s, "window_s": window_s, "calls": len(calls),
        "images": images_served, "latency_s": latency, "peak": peak,
        "numbers": numbers, "detail": detail, "failed": failed,
        "events": events,
        "captures": captures, "launches": launches,
    }


def reference_shapes(ref):
    """{name: shape} of the reference's state dict (the program's)."""
    with torch.device("meta"):
        m = ref_model.build(ref)
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def profiler(device, trace, record_shapes=False):
    """``torch.profiler`` over the window of a traced run (the card's
    activity with the host's), else nothing."""
    if not trace:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=record_shapes)


def window_done(trace, w0, seconds, n, trace_n):
    """A traced window ends after ``trace_n`` calls or steps; a measured
    one at the first that ends past ``seconds`` (at least one)."""
    if trace:
        return n >= trace_n
    return n > 0 and time.perf_counter() - w0 >= seconds


def capture_nms(eval_fn, pool):
    """The arguments and results of the program's NMS op on one call of
    each pool batch (outside the window), for the K1 bound."""
    from torch.utils._python_dispatch import TorchDispatchMode

    got = []

    class Capture(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if "nms_batched" in str(func):
                got.append(([a.detach().clone() if torch.is_tensor(a)
                             else a for a in args],
                            [o.detach().clone() for o in out]))
            return out

    for images, sizes in pool:
        with Capture():
            eval_fn(images, sizes)
    return got


def reference_anchors(ref, hw, device):
    a = ref["anchors"]
    shapes = ref_model.feature_shapes(hw, a["strides"])
    anchors, counts = ref_boxes.anchors(shapes, a["strides"], a["sizes"])
    return anchors.to(device), counts


def level_slices(counts):
    out, start = [], 0
    for c in counts:
        out.append(slice(start, start + c))
        start += c
    return out


def reference_heads(cell, wts, pool, device, precision):
    """The reference's head outputs of every pool batch (on the host),
    computed in ``precision`` in blocks of images."""
    ref = cell.config["reference"]
    block = cell.traffic["reference_block"]
    with checks.float32_exact():
        with torch.device(device):
            model = ref_model.build(ref, precision)
        model.load_state_dict(wts, strict=True)
        model.eval()
        out = []
        with torch.no_grad():
            for images, sizes in pool:
                parts = []
                for i in range(0, images.shape[0], block):
                    x = ref_model.normalize(
                        images[i:i + block].to(device),
                        sizes[i:i + block].to(device),
                        ref["pixel_mean"], ref["pixel_std"])
                    parts.append({k: v.cpu() for k, v in model(x).items()})
                out.append({k: torch.cat([p[k] for p in parts])
                            for k in HEAD_KEYS})
    return out


def reference_detections(cell, heads, pool, device, dtype=torch.float32):
    """The reference's post-processing of head outputs (the program's,
    or a control's), per pool batch, on the host; computed in ``dtype``
    (the control: bfloat16)."""
    ref = cell.config["reference"]
    anchors, counts = reference_anchors(ref, cell.traffic["hw"], device)
    dets = []
    with checks.float32_exact(), torch.no_grad():
        for (_, sizes), h in zip(pool, heads):
            d = ref_post.detect({k: h[k].to(device).float() for k in h},
                                sizes.to(device), anchors, counts,
                                ref["postprocess"], dtype)
            dets.append({k: v.cpu() for k, v in d.items()})
    return dets


def judge(cell, wts, pool, heads, calls, outputs, device):
    """The numbers compared (each against its limit), the head gap of
    every (output, level), and the number of window calls whose
    detections fail the limits."""
    t = time.perf_counter()
    ref_heads = reference_heads(cell, wts, pool, device, "float32")
    _, counts = reference_anchors(cell.config["reference"],
                                  cell.traffic["hw"], "cpu")
    gap = checks.HeadGap(HEAD_KEYS, len(counts))
    for p, r in zip(heads, ref_heads):
        for key in HEAD_KEYS:
            for li, sl in enumerate(level_slices(counts)):
                gap.add(key, li, p[key][:, sl].to(device),
                        r[key][:, sl].to(device))
    dets = reference_detections(cell, heads, pool, device)
    det, failed = checks.detections_gap(dets, calls, outputs, cell.limits)
    numbers = {"head_gap": gap.worst(), **det}
    detail = {"head_gap_by_level": gap.values(),
              "check_s": time.perf_counter() - t}
    return numbers, detail, failed

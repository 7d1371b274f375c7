"""Serving cells: one client in a closed loop, each call a batch of
uint8 host images through the program's ``make_eval_fn`` entry, its
detections copied back to the host before the next call is sent.

What depends on the model comes from the cell's family
(``families/<family>.py``): the weights' shapes, the pool, what the
check captures and how it judges. Set-up builds the model, loads the
seeded weights, draws the pool of batches and calls the entry once on
each of them (the first call alone is timed apart). The window then
sends the pool's batches in turn for ``--seconds``; the call in flight
at the end finishes and counts. With ``--trace 1`` the window is
``trace_calls`` calls under ``torch.profiler`` instead.

Correctness, once the window has closed and the peak memory is read:
the family's capture records what it compares on one call of every
pool batch through the same entry, the program is freed, and the
family's judge holds that and every window call's output against the
plain reference (PAA: the head outputs of the same images from the
same weights, float32, TF32 off; the reference's post-processing of
the program's head outputs against the detections).
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.profiler import record_function

from . import program, weights as W
from .tracemath import load_trace


def _host(out):
    with record_function("bench/readback"):
        return {k: v.cpu() for k, v in out.items()}


def run(cell, seed, seconds, trace, device, t0, log):
    cfg, tr, fam = cell.config, cell.traffic, cell.family
    wts = W.make_weights(fam.state_shapes(cfg), cfg["weights"], seed,
                         device)
    model = program.build_model(cfg, wts, device)
    eval_fn = model.make_eval_fn()
    pool = fam.serve_pool(cell, seed, device)

    t = time.perf_counter()
    _host(eval_fn(*pool[0]))
    log(f"first call {time.perf_counter() - t:.3f} s")
    for args in pool[1:]:
        _host(eval_fn(*args))
    captures = {}
    if trace:
        captures["nms_batched"] = capture_nms(eval_fn, pool)
    launches0 = program.launch_counts()
    setup_s = time.perf_counter() - t0

    calls, outputs, latency = [], [], []
    # the K3 and K4 rooflines read their ops' input shapes
    with profiler(device, trace, record_shapes=True) as prof:
        w0 = time.perf_counter()
        with record_function("bench/window"):
            while not window_done(trace, w0, seconds, len(calls),
                                  tr["trace_calls"]):
                k = len(calls) % len(pool)
                sent = time.perf_counter()
                with record_function("bench/call"):
                    out = _host(eval_fn(*pool[k]))
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

    # what the check compares of each pool batch, through the entry
    with fam.capture(model) as captured:
        for args in pool:
            _host(eval_fn(*args))
    del model, eval_fn
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers, detail, failed = fam.judge(cell, wts, pool, captured, calls,
                                        outputs, device)
    return {
        "setup_s": setup_s, "window_s": window_s, "calls": len(calls),
        "images": images_served, "latency_s": latency, "peak": peak,
        "numbers": numbers, "detail": detail, "failed": failed,
        "events": events,
        "captures": captures, "launches": launches,
    }


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

    for args in pool:
        with Capture():
            eval_fn(*args)
    return got

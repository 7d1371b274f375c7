"""Training cells: the program's train step (``make_bucket_train_step``:
uint8 host batch, forward, PAA loss, backward, SGD at the config's
schedule) called in a closed loop on the pool's batches in turn.

Set-up builds one train state from the seeded weights and drives it
through its first ``reference_steps`` steps (three; two where the
reference would outlast the window), on different batches of the pool,
through the window's own call; they also warm every shape up. It reads
the losses of each, the first gradient as the optimizer got it (its
momentum trace after one step, less the weight decay) and the change of
the parameters over those steps. The window then continues the same
state. With ``--trace 1`` the window is ``trace_steps`` steps under
``torch.profiler``.

Correctness, once the window has closed and the peak memory is read:
the program is freed, and the plain reference (float32, TF32 off)
takes the same steps from the same weights on the same batches,
in blocks of images.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from . import checks, program, serve, weights as W
from .tracemath import load_trace
from ..reference import model as ref_model
from ..reference import train as ref_train

LOSS_KEYS = ("loss_cls", "loss_reg", "loss_iou_pred", "loss")


def pool_batches(cell, seed, device):
    tr = cell.traffic
    images = W.image_pool(tr, seed, device)
    gts = W.gt_pool(tr, seed, cell.config["reference"]["head"][
        "num_classes"])
    return [{"images": im, "image_sizes": sz, "gt_boxes": b,
             "gt_labels": l} for (im, sz), (b, l) in zip(images, gts)]


def first_steps(step, state, pool, n, weight_decay):
    """``n`` steps on pool batches 0..n-1. Returns the losses of each,
    the first gradient's norm per tensor, the change's norm per tensor
    after the n steps."""
    params = dict(state.module.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()
             if p.requires_grad}
    decay = {id(p): g["weight_decay"] for g in state.optimizer.param_groups
             for p in g["params"]}
    records, grad = [], None
    for i in range(n):
        m = step(state, pool[i])
        records.append({k: float(m[k]) for k in (*LOSS_KEYS, "num_pos")})
        if i == 0:
            grad = {}
            for k in start:
                p = params[k]
                buf = state.optimizer.state[p]["momentum_buffer"]
                grad[k] = float((buf - decay[id(p)] * start[k]).norm())
    change = {k: float((params[k].detach() - start[k]).norm())
              for k in start}
    return records, grad, change


def run(cell, seed, seconds, trace, device, t0, log):
    cfg, tr = cell.config, cell.traffic
    shapes = serve.reference_shapes(cfg["reference"])
    wts = W.make_weights(shapes, cfg["weights"], seed, device)
    model = program.build_model(cfg, wts, device)
    state = program.train_state(model)
    step = model.make_bucket_train_step(tuple(tr["hw"]))
    pool = pool_batches(cell, seed, device)
    n_ref = tr["reference_steps"]
    t = time.perf_counter()
    records, grad, change = first_steps(
        step, state, pool, n_ref, cfg["reference"]["solver"]["weight_decay"])
    log(f"first {n_ref} steps {time.perf_counter() - t:.3f} s; losses "
        f"{[r['loss'] for r in records]}")
    launches0 = program.launch_counts()
    setup_s = time.perf_counter() - t0

    steps, last = 0, None
    with serve.profiler(device, trace) as prof:
        w0 = time.perf_counter()
        with record_function("bench/window"):
            while not serve.window_done(trace, w0, seconds, steps,
                                        tr["trace_steps"]):
                with record_function("bench/step"):
                    last = step(state, pool[(n_ref + steps) % len(pool)])
                steps += 1
            final_loss = float(last["loss"])  # waits for the device
        window_s = time.perf_counter() - w0
    events = load_trace(prof) if trace else None
    launches = {k: v - launches0[k]
                for k, v in program.launch_counts().items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    log(f"window {window_s:.3f} s, {steps} steps, last loss {final_loss}; "
        f"launches {launches}")
    del model, state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref_run = reference_run(cell, wts, pool[:n_ref], device)
    numbers, worst = judge(records, grad, change, ref_run)
    detail = {"losses": records, "reference_losses": ref_run[0], **worst,
              "window_last_loss": final_loss,
              "check_s": time.perf_counter() - t}
    return {
        "setup_s": setup_s, "window_s": window_s, "calls": steps,
        "images": steps * tr["batch"], "peak": peak, "numbers": numbers,
        "detail": detail,
        "failed": 0, "events": events, "captures": {},
        "launches": launches,
    }


def reference_run(cell, wts, batches, device, precision="float32"):
    """The reference's steps: (records, first gradient norms, change
    norms), per tensor by name."""
    ref = cell.config["reference"]
    tr = cell.traffic
    anchors, counts = serve.reference_anchors(ref, tr["hw"], device)
    with checks.float32_exact(), torch.device(device):
        model = ref_model.build(ref, precision)
    model.load_state_dict(wts, strict=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.requires_grad}
    on_dev = [{k: v.to(device) for k, v in b.items()} for b in batches]
    with checks.float32_exact():
        records, first = ref_train.train_steps(
            model, on_dev, anchors, counts, ref, tr["reference_block"])
    params = dict(model.named_parameters())
    grad = {n: float(g.norm()) for n, g in first.items()}
    change = {n: float((params[n].detach() - start[n]).norm())
              for n in start}
    return records, grad, change


def judge(records, grad, change, ref_run):
    """The training numbers of a run against the reference's."""
    ref_records, ref_grad, ref_change = ref_run
    loss_gap = max(checks.rel_gap(p[k], r[k])
                   for p, r in zip(records, ref_records) for k in LOSS_KEYS)
    pos_gaps = [checks.rel_gap(p["num_pos"], r["num_pos"])
                for p, r in zip(records, ref_records)]
    g, g_at, g_med, _ = checks.norm_gaps(grad, ref_grad, ref_grad)
    c, c_at, c_med, _ = checks.norm_gaps(change, ref_change, ref_grad)
    return {"loss_gap": loss_gap, "num_pos_gap": max(pos_gaps),
            "num_pos_gap_first": pos_gaps[0], "grad_gap": g,
            "change_gap": c, "grad_gap_median": g_med,
            "change_gap_median": c_med}, {"grad_gap_at": g_at,
                                          "change_gap_at": c_at}

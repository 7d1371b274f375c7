"""Training cells: the program's train step (``make_bucket_train_step``:
uint8 host batch, forward, the model's loss, backward, SGD at the
config's schedule) called in a closed loop on the pool's batches in
turn. The cell's family (``families/<family>.py``) gives the pool, the
records read from each step and the reference that judges them.

Set-up builds one train state from the seeded weights and drives it
through its first ``reference_steps`` steps (three; two where the
reference would outlast the window), on different batches of the pool,
through the window's own call; they also warm every shape up. It reads
the family's records of each (PAA: the losses and the positives), the
first gradient as the optimizer got it (its momentum trace after one
step, less the weight decay) and the change of the parameters over
those steps. The window then continues the same state. With ``--trace 1`` the window is ``trace_steps`` steps under
``torch.profiler``.

Correctness, once the window has closed and the peak memory is read:
the program is freed, and the family's plain reference (float32, TF32
off) takes the same steps from the same weights on the same batches,
in blocks of images.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import record_function

from . import program, serve, weights as W
from .tracemath import load_trace


def first_steps(step, state, pool, n, keys):
    """``n`` steps on pool batches 0..n-1. Returns the metrics ``keys``
    of each, the first gradient's norm per tensor, the change's norm per
    tensor after the n steps."""
    params = dict(state.module.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()
             if p.requires_grad}
    decay = {id(p): g["weight_decay"] for g in state.optimizer.param_groups
             for p in g["params"]}
    records, grad = [], None
    for i in range(n):
        m = step(state, pool[i])
        records.append({k: float(m[k]) for k in keys})
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
    cfg, tr, fam = cell.config, cell.traffic, cell.family
    wts = W.make_weights(fam.state_shapes(cfg), cfg["weights"], seed,
                         device)
    model = program.build_model(cfg, wts, device)
    state = program.train_state(model)
    step = model.make_bucket_train_step(tuple(tr["hw"]))
    pool = fam.train_pool(cell, seed, device)
    n_ref = tr["reference_steps"]
    t = time.perf_counter()
    records, grad, change = first_steps(step, state, pool, n_ref,
                                        fam.STEP_RECORDS)
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
    ref_run = fam.reference_run(cell, wts, pool[:n_ref], device)
    numbers, worst = fam.train_judge(records, grad, change, ref_run)
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

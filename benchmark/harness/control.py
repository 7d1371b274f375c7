"""The correctness control and the planted faults, read at a cell's own
size: the numbers the check would compute if they stood in the
program's place. The benchmark's own runs never run them.

- ``fp8`` (every cell): the reference itself computed one precision
  below the configuration's, every convolution's input and weight
  rounded to fp8 e4m3 (the network is stated in bfloat16); serving
  takes its detections from the reference's post-processing of its own
  head outputs, computed in bfloat16 (the post-processing is stated in
  float32).
- ``half_batch`` (training): the reference's steps on the first half of
  each batch, the losses the mean over that half.
- ``state_unchanged`` (training): the parameters never move (every
  change norm 0); the first gradient as the reference's.
"""

from __future__ import annotations

import time

import torch

from . import serve, train, weights as W


def serve_readings(cell, seed, device):
    shapes = serve.reference_shapes(cell.config["reference"])
    wts = W.make_weights(shapes, cell.config["weights"], seed, device)
    pool = W.image_pool(cell.traffic, seed, device)
    heads = serve.reference_heads(cell, wts, pool, device, "fp8")
    dets = serve.reference_detections(cell, heads, pool, device,
                                      torch.bfloat16)
    numbers, detail, _ = serve.judge(cell, wts, pool, heads,
                                     list(range(len(pool))), dets, device)
    return {"fp8": {**numbers, **detail}}


def train_readings(cell, seed, device):
    shapes = serve.reference_shapes(cell.config["reference"])
    wts = W.make_weights(shapes, cell.config["weights"], seed, device)
    n = cell.traffic["reference_steps"]
    batches = train.pool_batches(cell, seed, device)[:n]
    ref = train.reference_run(cell, wts, batches, device)
    half = [{k: v[:v.shape[0] // 2] for k, v in b.items()} for b in batches]
    runs = {
        "fp8": train.reference_run(cell, wts, batches, device, "fp8"),
        "half_batch": train.reference_run(cell, wts, half, device),
        "state_unchanged": (ref[0], ref[1], {k: 0.0 for k in ref[2]}),
    }
    return {name: train.judge(*run, ref)[0] for name, run in runs.items()}


def readings(cell, seeds, device, log):
    """{seed: {fault: numbers}} over ``seeds``."""
    fn = {"serve": serve_readings, "train": train_readings}[cell.kind]
    out = {}
    for seed in seeds:
        t = time.perf_counter()
        out[seed] = fn(cell, seed, device)
        log(f"seed {seed}: {out[seed]} ({time.perf_counter() - t:.1f} s)")
    return out

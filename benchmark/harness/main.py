"""One run of one cell: set-up, the measured window, the correctness
check, and the result line.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``checks``: each number compared with its
limit. The same numbers end standard error. Lines before the last give
the card's name, power limit and clocks at both ends of the window,
the kernels' launches and the first call's seconds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from . import cells, checks, serve, train
from .tracemath import TraceView, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "paa_tpu")
RUNNERS = {"serve": serve.run, "train": train.run}
CLOCKS = "clocks.sm,clocks.mem,temperature.gpu,power.draw,power.limit," \
         "clocks_throttle_reasons.active"


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi(device):
    """The card's clocks, power and throttle reasons now (nvidia-smi),
    or "not measured" off the card."""
    if device.type != "cuda":
        return "not measured"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={CLOCKS}", "--format=csv,noheader",
             "-i", str(device.index or 0)], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not measured ({type(e).__name__})"
    return out.stdout.strip()


def percentile(values, q):
    """The nearest-rank q-th percentile."""
    s = sorted(values)
    return s[max(0, min(len(s) - 1, int(-(-q * len(s) // 100)) - 1))]


def end_to_end(cell, r):
    values = {
        "setup_s": r["setup_s"],
        "serve_img_per_s": r["images"] / r["window_s"],
        "train_img_per_s": r["images"] / r["window_s"],
    }
    if "latency_s" in r:
        values["serve_p95_ms"] = 1e3 * percentile(r["latency_s"], 95)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def per_layer(cell, r, device_name):
    view = TraceView(r["events"], r["calls"], 1e6 * r["window_s"], cell,
                     device_name, r["captures"])
    out = {}
    for m in cell.per_layer:
        value = cells.metric_reader(m["name"], cell.root)(view)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out, view


def run_cell(name, seed, seconds, trace, device, t0=None, root=cells.REPO,
             out=sys.stdout, err=sys.stderr):
    """Runs the cell and prints its lines. Returns the exit code."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = cells.load_cell(name, root)

    def log(msg):
        print(f"[{name}] {msg}", file=err, flush=True)

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    clocks_start = nvidia_smi(device)
    r = RUNNERS[cell.kind](cell, seed, seconds, trace, device, t0, log)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=err)
        return 3
    info = {"cell": name, "seed": seed, "card": device_name,
            "clocks_start": clocks_start, "clocks_end": nvidia_smi(device),
            "launches": r["launches"], "numbers": r["numbers"],
            "detail": r["detail"]}
    print(json.dumps(info), file=out, flush=True)
    correct, rows = checks.verdict(r["numbers"], cell.limits)
    result = {"correct": correct, "attempted": r["calls"],
              "failed": r["failed"] if correct else max(r["failed"], 1)}
    device_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": device_name, "count": cell.chips,
                  "memory_peak_bytes": r["peak"]}
    if trace:
        metrics, view = per_layer(cell, r, device_name)
        device_out.update(busy_s=view.busy_us() * 1e-6,
                          window_s=r["window_s"])
        result.update(metrics=metrics, device=device_out,
                      breakdown=breakdown(view))
    else:
        result.update(metrics=end_to_end(cell, r), device=device_out)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for n, v, lim in rows:
        ok = v <= lim
        print(f"check {n} = {v!r} limit {lim!r} "
              f"{'ok' if ok else 'FAIL'}", file=err)
    print(json.dumps(result), file=out, flush=True)
    return 0

"""What the port's benchmark tools share (``tools/bench.py``,
``bench_dcnv2.py``, ``bench_tta.py``, ``bench_loader.py``).

- ``device_or_exit``: each tool runs on the card unless ``--device
  cpu`` is given; with neither a card nor ``--device cpu`` it exits
  non-zero with a message that names the missing CUDA device. It never
  falls back to the CPU.
- ``card_identity`` and ``clocks``: the card's name and power limit,
  and its SM and memory clocks, temperature, power draw and active
  clock throttle reasons, as ``nvidia-smi --query-gpu`` reads them. A
  reading at each end of a timed window tells a slow card (a lower
  clock, a throttle reason) from a slow change. On the CPU every field
  is "not measured".
- ``timed_window``: the first call alone, the rest of the warm-up, then
  N calls queued back to back on the stream with one synchronize at the
  end (``profile_train_step.step_ms``: CUDA-event ms on the card), the
  host clock around the same window, and the clocks at both ends.
- ``lift_cls_bias``: a dense head's cls_logits bias drawn from seed 1
  around the 0.05 score threshold, so that a model with seeded weights
  yields candidates (``chip_smoke.py``'s serving phases,
  ``tools/bench_tta.py``'s model, and ``tools/bench.py`` with
  ``--cls-bias-lift``; without it, bench times the seeded head as
  bench.py does).
"""

import subprocess
import time

import torch

from .profile_train_step import _synchronize, step_ms

NOT_MEASURED = "not measured"
# what ``clocks`` reads, in nvidia-smi's order
CLOCK_FIELDS = ("sm_mhz", "mem_mhz", "temperature_c", "power_draw_w",
                "throttle_reasons")
CLOCK_QUERY = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
               "clocks_throttle_reasons.active")


def device_or_exit(device, prog):
    """``device`` as a torch.device; None means the card. Without a card
    and without an explicit device, exits non-zero (SystemExit with a
    message naming the missing CUDA device)."""
    if device is None and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is available; pass "
                         "--device cpu to run on the CPU")
    return torch.device(device or "cuda")


def _query(device, fields, units=True):
    """One row of ``nvidia-smi --query-gpu=<fields>`` for ``device``'s
    card, as a list of strings."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}",
         "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True)
    return [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]


def card_identity(device):
    """{"name", "power_limit"} of ``device``'s card as nvidia-smi gives
    them (e.g. "NVIDIA H100 80GB HBM3", "700.00 W")."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": NOT_MEASURED}
    name, power_limit = _query(device, "name,power.limit")
    return {"name": name, "power_limit": power_limit}


def _number(text):
    try:
        return float(text)
    except ValueError:  # "[N/A]" and the like
        return text


def clocks(device):
    """The card's SM and memory clocks (MHz), temperature (C), power draw
    (W) and active clock throttle reasons (nvidia-smi's bit mask) now."""
    if device.type != "cuda":
        return {k: NOT_MEASURED for k in CLOCK_FIELDS}
    values = _query(device, CLOCK_QUERY, units=False)
    return {k: (v if k == "throttle_reasons" else _number(v))
            for k, v in zip(CLOCK_FIELDS, values)}


def timed_window(fn, iters, device, warmup=2):
    """Times ``fn()``: the first of ``warmup`` calls alone (first_call_s,
    host clock up to a synchronize), the other warm-up calls, then
    ``iters`` calls back to back with one synchronize at the end.
    Returns {"first_call_s", "ms_per_call" (CUDA events on the card, the
    host clock on the CPU: "clock"), "host_s" (host clock around the
    window, its synchronize included), "clocks": {"start", "end"}}."""
    t0 = time.perf_counter()
    fn()
    _synchronize(device)
    first_call_s = time.perf_counter() - t0
    for _ in range(warmup - 1):
        fn()
    _synchronize(device)
    start = clocks(device)
    t0 = time.perf_counter()
    ms = step_ms(fn, iters, device, warmup=0)
    host_s = time.perf_counter() - t0
    return {"first_call_s": first_call_s, "ms_per_call": ms,
            "clock": "cuda_events" if device.type == "cuda" else "host",
            "host_s": host_s,
            "clocks": {"start": start, "end": clocks(device)}}


def lift_cls_bias(model):
    """``model`` with its dense head's cls_logits bias drawn from seed 1
    in [-3.5, -2.5], around the 0.05 threshold (logit -2.944)."""
    gen = torch.Generator().manual_seed(1)
    bias = model.module.head.cls_logits.bias
    with torch.no_grad():
        bias.copy_(torch.empty(bias.shape).uniform_(-3.5, -2.5,
                                                    generator=gen))
    return model

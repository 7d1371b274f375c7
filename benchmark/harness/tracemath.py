"""The arithmetic that turns a ``torch.profiler`` trace of a measured
window into per-layer numbers: device busy time as a union of
intervals, device time attributed to a host span or op by launch
correlation, the rooflines' bounds and the chip's peaks."""

from __future__ import annotations

import bisect
import json
import math
import os
import tempfile

# NVIDIA's data sheet for the H100 SXM (dense): the tensor cores' bf16
# rate, float32 outside the tensor cores, HBM bandwidth. Shares are
# stated against these at the card's power limit, which the run prints.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

# the K1 bound (greedy NMS): an IoU and its compare, 2 x (min, max, sub,
# add, max), mul, add, sub, div, compare; a label compare
NMS_IOU_OPS, NMS_LABEL_OPS = 15, 1
# bytes read of every candidate (score, valid), of a valid one besides
# (box, label), and written per output slot (idx, score, valid)
NMS_BYTES_ALL, NMS_BYTES_VALID, NMS_BYTES_OUT = 4 + 1, 16 + 4, 4 + 4 + 1

# bytes of an element by the profiler's name of its type
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8}


def peaks(device_name):
    """The peaks of a card by its name, or None for a card not listed."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def union_us(intervals):
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def busy_intervals(intervals):
    """The union of (start, end) intervals as disjoint sorted ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def load_trace(prof):
    """The profile's events as its Chrome trace lists them, read back
    from a file in the temporary directory, which is then removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


class TraceView:
    """A traced window: its events, ``calls`` (requests or steps in it),
    ``window_us`` (its wall time), the cell and what the harness
    captured outside the window (``captures``)."""

    def __init__(self, events, calls, window_us, cell, device_name,
                 captures=None):
        self.events = events
        self.calls = calls
        self.window_us = window_us
        self.cell = cell
        self.device_name = device_name
        self.peaks = peaks(device_name)
        self.captures = captures or {}
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get(
                    "args", {}):
                launch[e["args"]["correlation"]] = e
        # (launch ts, launching thread, device event), by launch time
        self.launched = sorted(
            ((launch[c]["ts"], launch[c].get("tid"), k)
             for k in self.device
             if (c := k.get("args", {}).get("correlation")) in launch),
            key=lambda x: x[0])
        self._launch_ts = [x[0] for x in self.launched]

    def named(self, name, cats=("cpu_op", "user_annotation")):
        """Host events (ops or spans) of this name, in time order."""
        return sorted((e for e in self.events if e.get("name") == name
                       and e.get("cat") in cats and "dur" in e),
                      key=lambda e: e["ts"])

    def launched_in(self, host_event):
        """The device events launched from inside ``host_event``'s
        interval on its thread."""
        a, b = host_event["ts"], host_event["ts"] + host_event["dur"]
        lo = bisect.bisect_left(self._launch_ts, a)
        hi = bisect.bisect_right(self._launch_ts, b)
        tid = host_event.get("tid")
        return [k for _, t, k in self.launched[lo:hi] if t == tid]

    def device_us_in(self, name):
        """Device busy us of the kernels launched inside every
        occurrence of the span or op ``name`` (a union per occurrence),
        and the occurrences; (0, []) where there is none."""
        occ = self.named(name)
        total = 0.0
        for e in occ:
            total += union_us([(k["ts"], k["ts"] + k["dur"])
                               for k in self.launched_in(e)])
        return total, occ

    def busy_us(self):
        return union_us([(k["ts"], k["ts"] + k["dur"])
                         for k in self.device])


def nms_bound_s(boxes, scores, labels, valid, keep_idx, keep_valid,
                max_out, aware, peak):
    """Least seconds for greedy NMS on these inputs: the larger of the
    bytes (every candidate's score and valid flag, a valid one's box and
    label, the outputs) over HBM bandwidth and the operations greedy
    needs (for each live candidate up to the last pick of a row that
    fills ``max_out``, a label compare and, for the same label, an IoU
    against each kept box ranked ahead of it) over the float32 rate."""
    import torch

    bsz, n = scores.shape
    live = (valid & (scores > -5e29)
            & ~(valid & scores.isnan()).any(dim=1, keepdim=True))
    order = torch.where(live, scores, float("-inf")).sort(
        dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=scores.device).expand(bsz, n))
    pairs = ious = 0
    for b in range(bsz):
        kept = keep_idx[b][keep_valid[b]].long()
        kept_rank = rank[b, kept]
        last = kept_rank[-1] if len(kept) == max_out else n
        cand = live[b] & (rank[b] <= last)
        ahead = kept_rank[None, :] < rank[b][cand][:, None]
        pairs += int(ahead.sum())
        if aware:
            ahead &= labels[b][cand][:, None] == labels[b, kept][None, :]
        ious += int(ahead.sum())
    nbytes = (bsz * n * NMS_BYTES_ALL + int(valid.sum()) * NMS_BYTES_VALID
              + bsz * max_out * NMS_BYTES_OUT)
    ops = ious * NMS_IOU_OPS + (pairs * NMS_LABEL_OPS if aware else 0)
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["f32_flops"])


def deform_im2col_bytes(args):
    """Least bytes of one ``paa_tpu_torch::deform_im2col`` op (K4) from
    its recorded arguments (``record_shapes``): x, the offsets and the
    mask (where given) read once, and the columns written once, (B,
    groups, Ho*Wo, kh*kw*C/groups) in x's type, sized as the op's fake
    sizes them."""
    dims, types = args["Input Dims"], args["Input type"]
    kh, kw, stride, padding, dilation, groups = (
        int(v) for v in args["Concrete Inputs"][3:9])
    b, c, h, w = dims[0]
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    read = sum(math.prod(d) * ITEMSIZE[t]
               for d, t in zip(dims[:3], types[:3]) if d)
    cols = b * groups * ho * wo * kh * kw * (c // groups)
    return read + cols * ITEMSIZE[types[0]]


def breakdown(view, top=10):
    """The device ops that took most time, and the longest idle gaps by
    the innermost host span open at the gap's start on the window's
    thread: {"device_ops": [[name, s]], "idle_gaps": [[name, s]]}."""
    ops = {}
    for k in view.device:
        ops[k["name"]] = ops.get(k["name"], 0.0) + k["dur"] * 1e-6
    window = view.named("bench/window")
    if not window:
        return {"device_ops": sorted(ops.items(), key=lambda kv: -kv[1])[
            :top], "idle_gaps": []}
    w = window[0]
    a, b, tid = w["ts"], w["ts"] + w["dur"], w["tid"]
    busy = busy_intervals([(k["ts"], k["ts"] + k["dur"])
                           for k in view.device])
    gaps, t = [], a
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    host = sorted((e for e in view.events
                   if e.get("cat") in ("cpu_op", "user_annotation")
                   and e.get("tid") == tid and "dur" in e and e is not w),
                  key=lambda h: (h["ts"], -h["dur"]))
    by, stack, i = {}, [], 0
    # host events of one thread nest: sweep them with a stack
    for s, e in gaps:
        while i < len(host) and host[i]["ts"] <= s:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= \
                    host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= s:
            stack.pop()
        if e > s:
            label = stack[-1]["name"] if stack else "bench/window"
            by[label] = by.get(label, 0.0) + (e - s) * 1e-6
    return {"device_ops": [list(kv) for kv in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [list(kv) for kv in sorted(
                by.items(), key=lambda kv: -kv[1])[:top]]}

"""The program's own spans in a traced window: the device's idle gaps
and the host spans they open in, and the stage of the forward that
each backward op differentiates.

A gap is an interval of the window in which the card runs no kernel,
memcpy or memset (as ``tracemath.breakdown`` finds them); it belongs to
a span when it opens inside it. A backward op is one of the autograd
engine's ``autograd::engine::evaluate_function: <node>`` ops; the
profiler links it to the forward op that recorded its node by a
``fwdbwd`` flow event, whose start ("s") sits on the forward op's
thread at its start and whose end ("f") inside the backward op. The
forward op's stage is the stage span (``detector/body``, ...) open
around that start on its thread.
"""

from __future__ import annotations

import bisect

from .tracemath import busy_intervals, union_us

WINDOW = "bench/window"
SYNC_PREFIX = "sync/"
STAGES = ("detector/body", "detector/fpn", "detector/head")
BACKWARD_OP = "autograd::engine::evaluate_function: "
SPAN_CATS = ("user_annotation",)


def window(view):
    """The window's span, or None."""
    found = view.named(WINDOW, cats=SPAN_CATS)
    return found[0] if found else None


def idle_gaps(view):
    """The device's idle gaps (start, end) inside the window, in time
    order; [] without a window or any device event."""
    w = window(view)
    if w is None or not view.device:
        return []
    a, b = w["ts"], w["ts"] + w["dur"]
    gaps, t = [], a
    for s, e in busy_intervals([(k["ts"], k["ts"] + k["dur"])
                                for k in view.device]):
        if s > t:
            gaps.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        gaps.append((t, b))
    return [(s, e) for s, e in gaps if e > s]


def idle_us_opening_in(gaps, intervals):
    """The length of the gaps whose start falls inside one of the
    (start, end) host intervals, the end left out."""
    merged = busy_intervals(intervals)
    starts = [a for a, _ in merged]
    total = 0.0
    for s, e in gaps:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < merged[i][1]:
            total += e - s
    return total


def spans_on_window_thread(view, match):
    """(start, end) of the spans on the window's thread whose name
    ``match`` accepts; [] without a window."""
    w = window(view)
    if w is None:
        return []
    return [(e["ts"], e["ts"] + e["dur"]) for e in view.events
            if e.get("cat") in SPAN_CATS and "dur" in e
            and e.get("tid") == w.get("tid") and match(e.get("name", ""))]


def idle_ms_per_call(view, match):
    """Idle ms per call or step in the gaps that open inside a span on
    the window's thread whose name ``match`` accepts; None where there
    is no such span, no device event or no call."""
    spans = spans_on_window_thread(view, match)
    if not spans or not view.device or view.calls == 0:
        return None
    return idle_us_opening_in(idle_gaps(view), spans) / 1e3 / view.calls


def device_ms_per_call(view, name):
    """Device busy ms per call or step of the kernels launched inside
    the span ``name`` (``TraceView.device_us_in``); None where there is
    no such span, no device time or no call."""
    busy_us, spans = view.device_us_in(name)
    if not spans or busy_us <= 0 or view.calls == 0:
        return None
    return busy_us / 1e3 / view.calls


def _innermost(intervals, starts, t):
    """The innermost of the nested host events (sorted by start, starts
    their starts) whose interval holds ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        e = intervals[i]
        if t <= e["ts"] + e["dur"]:
            return e
        i -= 1
    return None


def _by_thread(events):
    out = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        out.setdefault(e.get("tid"), []).append(e)
    return {tid: (evs, [e["ts"] for e in evs]) for tid, evs in out.items()}


def backward_ops_by_stage(view, stages=STAGES):
    """{stage: [backward op]} for the stages with at least one: the
    backward ops whose forward op, by the profiler's forward-backward
    flow, started inside a span of that stage on its own thread."""
    stage_spans = _by_thread(
        e for e in view.events if e.get("cat") in SPAN_CATS
        and e.get("name") in stages and "dur" in e)
    backward = _by_thread(
        e for e in view.events if e.get("cat") == "cpu_op" and "dur" in e
        and e.get("name", "").startswith(BACKWARD_OP))
    flows = {"s": {}, "f": {}}
    for e in view.events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in flows:
            flows[e["ph"]][e.get("id")] = e
    out = {}
    for fid, s in flows["s"].items():
        f = flows["f"].get(fid)
        if f is None or s.get("tid") not in stage_spans or \
                f.get("tid") not in backward:
            continue
        stage = _innermost(*stage_spans[s.get("tid")], s["ts"])
        op = _innermost(*backward[f.get("tid")], f["ts"])
        if stage is not None and op is not None:
            out.setdefault(stage["name"], []).append(op)
    return out


def launched_by(view, ops):
    """The device events launched inside any of the host ``ops``, each
    once."""
    seen = {}
    for op in ops:
        for k in view.launched_in(op):
            seen[id(k)] = k
    return list(seen.values())


def backward_device_ms_per_step(view, stage):
    """Device busy ms per step of the kernels launched by the backward
    ops of ``stage``'s forward ops; None where none is linked or none
    launched device work."""
    ops = backward_ops_by_stage(view).get(stage)
    if not ops or view.calls == 0:
        return None
    busy = union_us([(k["ts"], k["ts"] + k["dur"])
                     for k in launched_by(view, ops)])
    return busy / 1e3 / view.calls if busy > 0 else None


def backward_idle_ms_per_step(view, stages=STAGES):
    """Idle ms per step in the gaps that open while the autograd engine
    runs a backward op of one of ``stages``' forward ops; None where
    none is linked or there is no device event."""
    ops = [op for found in backward_ops_by_stage(view, stages).values()
           for op in found]
    if not ops or not view.device or view.calls == 0:
        return None
    return idle_us_opening_in(
        idle_gaps(view),
        [(op["ts"], op["ts"] + op["dur"]) for op in ops]) / 1e3 / view.calls

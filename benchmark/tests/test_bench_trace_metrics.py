"""The readers of the program's stage, DCN and host-read spans
(``harness/spans.py``) on synthetic traces: device time inside a span,
idle gaps by the span they open in, and backward ops put down to the
stage of their forward op through the profiler's ``fwdbwd`` flows."""

import pytest

from benchmark.harness import cells, spans, tracemath

H100 = "NVIDIA H100 80GB HBM3"
MAIN, AUTOGRAD = 1, 2
BWD = spans.BACKWARD_OP

SERVE_SPANS = ("serve.body_ms", "serve.head_ms", "serve.postprocess_ms",
               "serve.dcn_forward_ms")
NEW = (*SERVE_SPANS, "serve.postprocess_idle_ms", "serve.sync_idle_ms",
       "train.sync_idle_ms", "train.body_backward_ms",
       "train.head_backward_ms", "train.backward_idle_ms")


def _kernel(ts, dur, corr, name="k"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=MAIN):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _span(name, ts, dur, tid=MAIN):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def _op(name, ts, dur, tid=MAIN):
    return {"cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {}}


def _flow(fid, fwd_ts, bwd_ts, fwd_tid=MAIN, bwd_tid=AUTOGRAD):
    return [{"ph": "s", "id": fid, "tid": fwd_tid, "ts": fwd_ts,
             "cat": "fwdbwd", "name": "fwdbwd"},
            {"ph": "f", "id": fid, "tid": bwd_tid, "ts": bwd_ts,
             "cat": "fwdbwd", "name": "fwdbwd", "bp": "e"}]


def _view(events, calls=1):
    return tracemath.TraceView(events, calls, 1000.0, None, H100)


def _read(name, view):
    return cells.metric_reader(name)(view)


def test_device_time_inside_the_stage_spans():
    events = [
        _span("bench/window", 0, 1000),
        _span("detector/body", 0, 100), _launch(10, 1), _launch(20, 2),
        _span("deform_conv2d/forward", 15, 4), _launch(18, 3),
        _span("detector/head", 100, 100), _launch(110, 4),
        _span("detector/postprocess", 200, 100), _launch(210, 5),
        _kernel(300, 40, 1), _kernel(340, 60, 2), _kernel(400, 30, 3),
        _kernel(430, 20, 4), _kernel(450, 10, 5),
        _launch(600, 6, tid=AUTOGRAD),  # another thread: not the body's
        _kernel(600, 50, 6),
    ]
    view = _view(events, calls=2)
    # the DCN's kernel is the body's too: its span nests in the body's
    assert _read("serve.body_ms", view) == pytest.approx(130 / 1e3 / 2)
    assert _read("serve.dcn_forward_ms", view) == pytest.approx(30 / 2e3)
    assert _read("serve.head_ms", view) == pytest.approx(20 / 2e3)
    assert _read("serve.postprocess_ms", view) == pytest.approx(10 / 2e3)


def test_a_gap_counts_where_it_opens():
    """Kernels at 0-100, 150-200 and 300-400 of a window of 0-500; the
    host waits in sync/select_tier from 90 to 120 (the gap at 100 opens
    inside it) and in sync/h2d_copy from 150 to 200 (the gap at 200
    opens at its end, just after it: not counted)."""
    events = [
        _span("bench/window", 0, 500),
        _span("detector/postprocess", 50, 300),
        _span("sync/select_tier", 90, 30),
        _span("sync/h2d_copy", 150, 50),
        _span("sync/other_thread", 390, 50, tid=AUTOGRAD),
        _kernel(0, 100, 1), _kernel(150, 50, 2), _kernel(300, 100, 3),
    ]
    view = _view(events, calls=2)
    assert spans.idle_gaps(view) == [(100, 150), (200, 300), (400, 500)]
    # 100-150 opens in the tier read; 200-300 in the post-processing
    # alone; the gap at 400 opens after the post-processing and, on the
    # window's thread, in no sync span
    assert _read("serve.sync_idle_ms", view) == pytest.approx(50 / 2e3)
    assert _read("train.sync_idle_ms", view) == pytest.approx(50 / 2e3)
    assert _read("serve.postprocess_idle_ms", view) == pytest.approx(
        150 / 2e3)
    moved = [dict(e, ts=100) if e["name"] == "sync/h2d_copy" else e
             for e in events]  # now from 100 to 150: holds the same gap
    assert _read("serve.sync_idle_ms", _view(moved, calls=2)) == \
        pytest.approx(50 / 2e3)


def test_gaps_follow_the_breakdown_inside_the_window():
    events = [_span("bench/window", 100, 400), _kernel(0, 150, 1),
              _kernel(300, 50, 2), _kernel(600, 10, 3)]
    view = _view(events)
    assert spans.idle_gaps(view) == [(150, 300), (350, 500)]
    total = sum(s for _, s in tracemath.breakdown(view)["idle_gaps"])
    assert total == pytest.approx(300e-6)


def test_backward_ops_go_to_their_forward_ops_stage():
    """Forward ops in the body and the head on the main thread; their
    backward ops on the autograd engine's thread, linked by flows. A
    backward op recomputes a forward inside itself (the DCN's and K3's
    backward): the nested ops' own flows start on the autograd thread,
    outside every stage, and their kernels count once, in the outer
    op's stage."""
    conv_b = BWD + "ConvolutionBackward0"
    events = [
        _span("bench/window", 0, 2000),
        _span("train_step/forward", 0, 400),
        _span("detector/body", 0, 100), _op("aten::convolution", 10, 20),
        _op("DeformConv2dFunction", 40, 20),
        _span("detector/fpn", 100, 100), _op("aten::convolution", 110, 20),
        _span("detector/head", 200, 100), _op("GroupNormReLU", 210, 20),
        _op("aten::mul", 350, 10),  # the loss: no stage
        _span("train_step/backward", 500, 1000),
        # the autograd thread, in reverse order
        _op(BWD + "MulBackward0", 500, 50, tid=AUTOGRAD),
        _op(BWD + "GroupNormReLUBackward", 600, 100, tid=AUTOGRAD),
        _op(conv_b, 700, 100, tid=AUTOGRAD),
        _op(BWD + "DeformConv2dFunctionBackward", 800, 300, tid=AUTOGRAD),
        _op(BWD + "MulBackward0", 850, 50, tid=AUTOGRAD),  # nested
        _op(conv_b, 1100, 250, tid=AUTOGRAD),
        *_flow(1, 350, 502), *_flow(2, 210, 602), *_flow(3, 110, 702),
        *_flow(4, 40, 802), *_flow(5, 820, 852, fwd_tid=AUTOGRAD),
        *_flow(6, 10, 1102),
        _launch(510, 1, AUTOGRAD), _launch(610, 2, AUTOGRAD),
        _launch(710, 3, AUTOGRAD), _launch(810, 4, AUTOGRAD),
        _launch(860, 5, AUTOGRAD), _launch(1110, 6, AUTOGRAD),
        # kernels, each ending where the next starts but for the gaps
        # 1000-1050 (opens in the DCN's backward op), 1300-1400 (the
        # body's conv backward) and 1450-2000 (after every backward op)
        _kernel(510, 90, 1), _kernel(600, 100, 2), _kernel(700, 100, 3),
        _kernel(800, 100, 4), _kernel(900, 100, 5), _kernel(1050, 250, 6),
        _kernel(1400, 50, 1),
    ]
    view = _view(events, calls=2)
    by_stage = spans.backward_ops_by_stage(view)
    assert {s: [op["ts"] for op in ops] for s, ops in by_stage.items()} \
        == {"detector/body": [800, 1100], "detector/fpn": [700],
            "detector/head": [600]}
    # the body: the DCN's 100 + its nested op's 100, and the conv's 250
    assert _read("train.body_backward_ms", view) == pytest.approx(
        450 / 2e3)
    assert _read("train.head_backward_ms", view) == pytest.approx(
        100 / 2e3)
    assert _read("train.backward_idle_ms", view) == pytest.approx(
        (50 + 100) / 2e3)
    bucket = dict(tracemath.breakdown(view)["idle_gaps"])
    assert _read("train.backward_idle_ms", view) * 2e-3 <= \
        bucket["train_step/backward"]


def test_a_trace_without_the_spans_reads_none():
    bare = [_span("bench/window", 0, 100), _launch(1, 1), _kernel(1, 50, 1),
            _op(BWD + "ConvolutionBackward0", 60, 10, tid=AUTOGRAD)]
    for view in (_view([]), _view(bare)):
        for name in NEW:
            assert _read(name, view) is None, name
    # spans there but no device work (a CPU trace): still nothing to read
    cpu = [_span("bench/window", 0, 100), _span("detector/body", 0, 10),
           _span("detector/postprocess", 10, 10),
           _span("sync/h2d_copy", 0, 5)]
    for name in NEW:
        assert _read(name, _view(cpu)) is None, name

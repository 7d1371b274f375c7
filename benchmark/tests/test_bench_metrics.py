"""The metric arithmetic on synthetic traces and shapes: unions of
intervals, device time by launch correlation, the K1 and K3 bounds, the
readers of every per-layer metric, the idle gaps and the FLOP count."""

import math

import pytest
import torch

from benchmark.families import paa
from benchmark.harness import cells, tracemath
from benchmark.tests import tiny

H100 = "NVIDIA H100 80GB HBM3"


def test_union_and_busy_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert tracemath.union_us(iv) == 4.0
    assert tracemath.busy_intervals(iv) == [[0, 3], [5, 6], [10, 10]]
    assert tracemath.union_us([]) == 0.0


def _kernel(name, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=1):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": tid, "args": {"correlation": corr}}


def _host(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


class _Cell:
    def __init__(self, traffic, config=None):
        self.traffic, self.config, self.family = traffic, config, paa


def _view(events, calls=2, window_us=1000.0, captures=None, name=H100,
          traffic=None, config=None):
    return tracemath.TraceView(events, calls, window_us,
                               _Cell(traffic or {}, config), name, captures)


def test_device_time_by_correlation_and_thread():
    gn = "paa_tpu_torch::group_norm_relu"
    events = [
        _host(gn, 100, 50), _host(gn, 300, 50),
        _launch(110, 1), _launch(120, 2), _launch(310, 3),
        _launch(130, 4, tid=2),  # another thread inside the interval
        _launch(200, 5),  # outside both
        _kernel("gn_relu", 400, 30, 1), _kernel("gn_relu", 420, 30, 2),
        _kernel("gn_relu", 500, 10, 3), _kernel("other", 600, 99, 4),
        _kernel("other", 700, 99, 5),
    ]
    view = _view(events)
    busy, occ = view.device_us_in(gn)
    assert len(occ) == 2 and busy == 50.0 + 10.0
    assert view.device_us_in("absent") == (0.0, [])
    assert view.busy_us() == 50 + 10 + 99 + 99


def test_k3_reader_counts_input_and_output_once():
    read = cells.metric_reader("serve.k3_roofline")
    gn = "paa_tpu_torch::group_norm_relu"
    dims = [[2, 256, 100, 168], [256], [256], [], [], []]
    types = ["c10::BFloat16", "float", "float", "Scalar", "Scalar", "Scalar"]
    events = [_host(gn, 0, 10, **{"Input Dims": dims, "Input type": types}),
              _launch(1, 7), _kernel("gn_relu", 20, 50.0, 7)]
    got = read(_view(events))
    nbytes = 2 * (2 * 256 * 100 * 168) * 2 + 2 * 256 * 4
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 50e-6)
    assert read(_view([])) is None  # nothing to read: no value, not 0
    assert read(_view(events, name="cpu")) is None


K4 = "paa_tpu_torch::deform_im2col"


def _k4_args(mask=True):
    """A stride-2 grouped deformable conv's recorded arguments: x (2, 64,
    20, 34) bf16, float32 offsets and mask at 10 x 17, 3x3, 32 groups."""
    dims = [[2, 64, 20, 34], [2, 18, 10, 17], [2, 9, 10, 17] if mask
            else [], [], [], [], [], [], [], []]
    types = ["c10::BFloat16", "float", "float" if mask else ""] + \
        ["Scalar"] * 7
    concrete = ["", "", "", "3", "3", "2", "1", "1", "32", "1"]
    return {"Input Dims": dims, "Input type": types,
            "Concrete Inputs": concrete}


def test_k4_reader_counts_inputs_and_columns_once():
    """x, offsets and mask read once and the columns written once, over
    the device time of every kernel launched inside the op (the
    channels-last copy of x and the sampling)."""
    read = cells.metric_reader("serve.k4_roofline")
    cols = 2 * 32 * (10 * 17) * 9 * 2  # B, groups, Ho*Wo, K*C/groups
    x, off, mask = 2 * 64 * 20 * 34 * 2, 2 * 18 * 170 * 4, 2 * 9 * 170 * 4
    assert tracemath.deform_im2col_bytes(_k4_args()) == \
        x + off + mask + cols * 2
    assert tracemath.deform_im2col_bytes(_k4_args(mask=False)) == \
        x + off + cols * 2
    events = [_host(K4, 0, 10, **_k4_args()), _host(K4, 100, 10,
                                                    **_k4_args(False)),
              _launch(1, 7), _launch(2, 8), _launch(101, 9),
              _kernel("copy_channels_last", 20, 30.0, 7),
              _kernel("im2col_kernel", 50, 40.0, 8),
              _kernel("im2col_kernel", 200, 30.0, 9)]
    got = read(_view(events))
    nbytes = 2 * (x + off + cols * 2) + mask
    assert got == pytest.approx(100 * nbytes / 3.35e12 / 100e-6)
    assert read(_view([])) is None  # no op ran: no value, not 0
    assert read(_view(events, name="cpu")) is None


@pytest.mark.parametrize("with_mask", [True, False])
def test_k4_bytes_from_the_ops_own_record(with_mask):
    """The op's arguments as the profiler records them give the bytes of
    its real inputs and of the columns it returns."""
    from torch.profiler import ProfilerActivity, profile

    from paa_tpu_torch.ops.deform_sampling import deform_im2col

    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 11, 13, generator=g).bfloat16()
    off = torch.randn(2, 18, 6, 7, generator=g)
    mask = torch.rand(2, 9, 6, 7, generator=g) if with_mask else None
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        cols = deform_im2col(x, off, mask, 3, 3, 2, 1, 1, 2, 1)
    events = tracemath.load_trace(prof)
    op = [e for e in events if e.get("name") == K4
          and e.get("cat") == "cpu_op"]
    want = sum(t.numel() * t.element_size() for t in (x, off, mask, cols)
               if t is not None)
    assert len(op) == 1
    assert tracemath.deform_im2col_bytes(op[0]["args"]) == want


def test_nms_bound_counts_greedy_work():
    """Two rows: one box kept alone; three overlapping boxes of one label
    where the first suppresses the second and keeps the third."""
    boxes = torch.tensor([[[0, 0, 9, 9], [0, 0, 9, 9], [50, 50, 59, 59]],
                          [[0, 0, 9, 9], [0, 0, 0, 0], [0, 0, 0, 0]]],
                         dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8, 0.7], [0.5, -1.0, -1.0]])
    labels = torch.tensor([[1, 1, 1], [2, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([[True, True, True], [True, False, False]])
    keep_idx = torch.tensor([[0, 2, 0], [0, 0, 0]], dtype=torch.int32)
    keep_valid = torch.tensor([[True, True, False], [True, False, False]])
    peak = tracemath.PEAKS["H100"]
    s = tracemath.nms_bound_s(boxes, scores, labels, valid, keep_idx,
                              keep_valid, 3, True, peak)
    # row 0: candidate 1 and 2 each against pick 0, candidate 2 against
    # pick 0 only (pick 2 is itself): 2 IoUs; row 1: none
    ops = 2 * tracemath.NMS_IOU_OPS + 2 * tracemath.NMS_LABEL_OPS
    nbytes = (6 * tracemath.NMS_BYTES_ALL + 4 * tracemath.NMS_BYTES_VALID
              + 2 * 3 * tracemath.NMS_BYTES_OUT)
    assert s == max(nbytes / peak["hbm_bytes_per_s"],
                    ops / peak["f32_flops"])


def test_k1_reader_and_its_captures():
    read = cells.metric_reader("serve.k1_roofline")
    boxes = torch.tensor([[[0, 0, 9, 9], [50, 50, 59, 59]]],
                         dtype=torch.float32)
    args = [boxes, torch.tensor([[0.9, 0.7]]),
            torch.tensor([[1, 1]], dtype=torch.int32),
            torch.tensor([[True, True]]), 0.6, 2, True]
    out = [torch.tensor([[0, 1]], dtype=torch.int32),
           torch.tensor([[0.9, 0.7]]), torch.tensor([[True, True]])]
    op = "paa_tpu_torch::nms_batched"
    events = [_host(op, 0, 10), _launch(1, 3), _kernel("nms", 50, 20.0, 3),
              _host(op, 100, 10), _launch(101, 4),
              _kernel("nms", 150, 30.0, 4)]
    view = _view(events, captures={"nms_batched": [(args, out)]})
    one = tracemath.nms_bound_s(*args[:4], out[0], out[2], 2, True,
                                tracemath.PEAKS["H100"])
    assert read(view) == pytest.approx(100 * 2 * one / 50e-6)
    assert read(_view(events)) is None


def test_memcpy_idle_and_span_readers():
    events = [
        _kernel("Memcpy HtoD (Pageable -> Device)", 0, 300.0, 1,
                cat="gpu_memcpy"),
        _kernel("Memcpy DtoH (Device -> Pageable)", 400, 100.0, 2,
                cat="gpu_memcpy"),
        _kernel("conv", 300, 100.0, 3),
        _host("train_step/input", 0, 2000.0, cat="user_annotation"),
        _host("train_step/input", 5000, 1000.0, cat="user_annotation"),
        _host("paa_loss/assignment", 3000, 500.0, cat="user_annotation"),
    ]
    view = _view(events, calls=2, window_us=1000.0)
    assert cells.metric_reader("serve.h2d_ms")(view) == 0.15
    idle = 100 * (1 - 500 / 1000)
    for name in ("serve.device_idle_share", "train.device_idle_share"):
        assert cells.metric_reader(name)(view) == pytest.approx(idle)
    assert cells.metric_reader("train.input_ms")(view) == 1.5
    assert cells.metric_reader("train.assignment_ms")(view) == 0.25
    for name in ("serve.h2d_ms", "serve.device_idle_share",
                 "train.input_ms", "train.gn_backward_ms",
                 "train.dcn_backward_ms"):
        assert cells.metric_reader(name)(_view([])) is None


def test_backward_span_readers():
    events = [_host("group_norm_relu/backward", 0, 100, tid=9,
                    cat="user_annotation"),
              _launch(10, 1, tid=9), _launch(20, 2, tid=9),
              _kernel("k", 200, 40.0, 1), _kernel("k", 220, 40.0, 2)]
    view = _view(events, calls=2)
    assert cells.metric_reader("train.gn_backward_ms")(view) == \
        pytest.approx(60 / 1e3 / 2)
    assert cells.metric_reader("train.dcn_backward_ms")(view) is None


def test_idle_gaps_by_host_span():
    events = [
        _host("bench/window", 0, 100, cat="user_annotation"),
        _host("bench/call", 0, 60, cat="user_annotation"),
        _host("aten::copy_", 40, 20),
        _kernel("a", 10, 20, 1), _kernel("b", 70, 10, 2),
    ]
    got = tracemath.breakdown(_view(events))
    assert [n for n, _ in got["device_ops"]] == ["a", "b"]
    assert [s for _, s in got["device_ops"]] == pytest.approx([20e-6, 10e-6])
    gaps = dict(got["idle_gaps"])
    # a gap goes to the innermost span open where it starts: 0-10 and
    # 30-70 to bench/call, 80-100 to the window
    assert gaps == pytest.approx({"bench/call": 50e-6,
                                  "bench/window": 20e-6})


def _flops(conf, batch, hw, backward=False):
    return paa.flops(_Cell({"batch": batch, "hw": list(hw)}, conf),
                     backward)


def test_reference_flops_scale_and_count_convs():
    conf = tiny.narrow_config("paa_r50_1x")
    ref = conf["reference"]
    one = _flops(conf, 1, (64, 96))
    assert _flops(conf, 2, (64, 96)) == 2 * one
    both = _flops(conf, 1, (64, 96), backward=True)
    assert 2 * one < both < 3 * one  # the frozen stem computes no grads
    # the stem's 7x7/2 conv alone: 2 * Cout * Cin * 49 * Ho * Wo
    stem = 2 * ref["body"]["stem_out"] * 3 * 49 * 32 * 48
    assert one > stem


def test_mfu_readers():
    conf = tiny.narrow_config("paa_r50_1x")
    tr = {"batch": 2, "hw": [64, 96]}
    view = _view([], calls=4, window_us=2e6, traffic=tr, config=conf)
    flops = _flops(conf, 2, (64, 96))
    assert cells.metric_reader("serve.mfu")(view) == pytest.approx(
        100 * flops * 4 / 2.0 / 989e12)
    train = _flops(conf, 2, (64, 96), backward=True)
    assert cells.metric_reader("train.mfu")(view) == pytest.approx(
        100 * train * 4 / 2.0 / 989e12)
    assert math.isfinite(cells.metric_reader("serve.mfu")(view))

"""The Mask R-CNN family on the CPU: a narrow serving cell of it run end
to end through the harness comes out ``correct`` under the real cell's
limits, and wrong where the program is broken under the timed path; the
fp8 control fails at least one limit; its six per-layer readers on a
synthetic trace; and neither the family nor its reference imports JAX
or the program."""

from __future__ import annotations

import ast
import copy
import io
import json
import math
import os

import pytest
import torch

from benchmark.families import mask_rcnn as fam
from benchmark.harness import cells, main, tracemath
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELL = "mask_rcnn_r50_fpn_1x.serve_b8"
FORBIDDEN = {"jax", "jaxlib", "flax", "paa_tpu", "paa_tpu_torch"}


def narrow_config(dtype="float32"):
    """The Mask R-CNN configuration at test widths: 16/32-channel body
    stages (8 per group), a 64-channel FPN, RPN and mask head, a 64-wide
    box MLP, 5 classes with background, fewer proposals (200 a level
    before NMS, 100 after, 100 an image) and 20 detections an image,
    computed in ``dtype``."""
    conf = copy.deepcopy(cells.read_json(os.path.join(
        cells.HERE, "configs", "mask_rcnn_r50_fpn_1x.json")))
    conf["name"] = "mask_rcnn_narrow"
    ref = conf["reference"]
    narrow = {  # program key: (value, reference section, field)
        "MODEL.RESNETS.STEM_OUT_CHANNELS": (16, "body", "stem_out"),
        "MODEL.RESNETS.RES2_OUT_CHANNELS": (32, "body", "res2_out"),
        "MODEL.RESNETS.WIDTH_PER_GROUP": (8, "body", "width_per_group"),
        "MODEL.RESNETS.BACKBONE_OUT_CHANNELS": (64, "fpn", "out_channels"),
        "MODEL.ROI_BOX_HEAD.NUM_CLASSES": (5, "box_head", "num_classes"),
        "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM": (64, "box_head", "mlp_dim"),
        "MODEL.ROI_MASK_HEAD.CONV_LAYERS": ((64,) * 4, "mask_head",
                                            "conv_layers"),
        "MODEL.RPN.PRE_NMS_TOP_N_TEST": (200, "rpn", "pre_nms_top_n"),
        "MODEL.RPN.POST_NMS_TOP_N_TEST": (100, "rpn", "post_nms_top_n"),
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST": (100, "rpn",
                                              "fpn_post_nms_top_n"),
        "MODEL.ROI_HEADS.DETECTIONS_PER_IMG": (20, "box_head",
                                               "detections_per_img"),
    }
    for key, (value, sec, field) in narrow.items():
        conf["cfg"][key] = str(value) if isinstance(value, tuple) else value
        ref[sec][field] = list(value) if isinstance(value, tuple) else value
    conf["cfg"]["TPU.COMPUTE_DTYPE"] = dtype
    fc_in = {"fc6": 64 * 7 * 7, "fc7": 64}
    for rule in conf["weights"]:
        for name, fan_in in fc_in.items():
            if rule["match"] == rf"^box_head\.{name}\.weight$":
                bound = math.sqrt(3.0 / fan_in)
                rule.update(low=-bound, high=bound)
    return conf


def narrow_traffic(batch=2, pool=2):
    return dict(tiny.narrow_traffic("serve", batch, pool),
                reference_block=1)


def _real_limits():
    return cells.read_json(os.path.join(cells.HERE, "limits",
                                        f"{CELL}.json"))


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path, [("n.mrcnn", narrow_config(),
                                      narrow_traffic())], _real_limits())


def _run(root, trace=False, seed=2**31 + 7):
    out, err = io.StringIO(), io.StringIO()
    rc = main.run_cell("n.mrcnn", seed, 0.3, trace, CPU, root=root,
                       out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_narrow_serving_cell_is_correct(root, trace):
    rc, info, result = _run(root, trace)
    assert rc == 0 and result["correct"], result["checks"]
    checks = {n: c["value"] for n, c in result["checks"].items()}
    assert set(checks) == set(_real_limits())
    assert checks["proposal_mismatch"] == 0
    assert checks["det_mismatch"] == 0
    assert checks["mask_prob_gap"] == 0.0
    # every stage at float32 against the float32 reference
    for name in ("rpn_gap", "box_gap", "mask_gap"):
        assert checks[name] < 1e-3, (name, checks[name])
    # the cls bias lift: candidates above the threshold, and detections
    assert info["detail"]["candidates_per_image"] > 20
    assert info["detail"]["detections_per_image"] > 5
    # two pooler calls a call: 100 proposals and 20 detections an image
    assert info["launches"]["roi_align"] == 2 * result["attempted"]
    assert info["launches"]["roi_align_rois"] == \
        2 * (100 + 20) * result["attempted"]
    if trace:
        for name in ("serve.proposals_ms", "serve.roi_align_ms",
                     "serve.box_head_ms", "serve.box_postprocess_ms",
                     "serve.mask_head_ms"):
            # no device on the CPU: the span readers read nothing
            assert name not in result["metrics"]
        assert "breakdown" in result
    else:
        assert {"serve_img_per_s", "setup_s"} <= set(result["metrics"])


def test_the_cell_reports_throughput_and_its_layers():
    """The real cell: serve_img_per_s and setup_s end to end (no p95 with
    one closed-loop client), the generic whole-call readers and the six
    two-stage ones."""
    cell = cells.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {"serve_img_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "serve.mfu", "serve.device_idle_share", "serve.body_ms",
        "serve.proposals_ms", "serve.roi_align_ms", "serve.box_head_ms",
        "serve.box_postprocess_ms", "serve.mask_head_ms",
        "serve.two_stage_idle_ms"}
    assert cell.family.__name__ == "bench_family_mask_rcnn"


def test_a_broken_stage_is_incorrect(root, monkeypatch):
    """Proposals shifted by a pixel under the timed path: the proposals
    differ from the reference's on the program's own RPN outputs."""
    from paa_tpu_torch.modeling import two_stage

    plain = two_stage.select_proposals

    def shifted(*args, **kwargs):
        boxes, scores, valid = plain(*args, **kwargs)
        return boxes + 1.0, scores, valid

    monkeypatch.setattr(two_stage, "select_proposals", shifted)
    rc, _, result = _run(root)
    assert rc == 0 and not result["correct"]
    assert result["checks"]["proposal_mismatch"]["value"] > 0


def test_altered_masks_are_incorrect(root, monkeypatch):
    """Every call's masks squared after the mask head: the masks no
    longer match the sigmoid of the logits the hooks saw."""
    from paa_tpu_torch.modeling import two_stage

    detect = two_stage.TwoStageModel.detect

    def squared(self, images, sizes):
        det = detect(self, images, sizes)
        det["masks"] = det["masks"] ** 2
        return det

    monkeypatch.setattr(two_stage.TwoStageModel, "detect", squared)
    rc, _, result = _run(root)
    assert rc == 0 and not result["correct"] and result["failed"] > 0
    assert result["checks"]["mask_prob_gap"]["value"] > 1e-3


def test_fp8_control_fails_a_limit(root):
    cell = cells.load_cell("n.mrcnn", root)
    got = fam.control(cell, 2**31 + 11, CPU)["fp8"]
    limits = _real_limits()
    assert any(got[n] > lim for n, lim in limits.items()), got
    assert got["mask_prob_gap"] > limits["mask_prob_gap"]


def test_flops_count_the_heads_at_their_rois():
    """The body, FPN and RPN head over the batch, the box head at 1,000
    rois an image and the mask head at 100: about 535 GFLOP an image at
    800x1344."""
    cell = cells.load_cell(CELL)
    per_image = fam.flops(cell) / cell.traffic["batch"]
    ch, mlp = 256, 1024
    box = 1000 * 2 * (ch * 49 * mlp + mlp * mlp + mlp * 81 * 5)
    mask = 100 * 2 * (4 * 14 * 14 * ch * ch * 9 + 14 * 14 * ch * ch * 4
                      + 28 * 28 * ch * 80)
    cell_narrow = copy.copy(cell)
    cell_narrow.traffic = dict(cell.traffic, batch=1)
    assert fam.flops(cell_narrow) == pytest.approx(per_image, rel=1e-12)
    assert 500e9 < per_image < 570e9
    assert per_image > box + mask


H100 = "NVIDIA H100 80GB HBM3"
MAIN = 1


def _kernel(ts, dur, corr):
    return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 1, "tid": MAIN, "args": {"correlation": corr}}


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "tid": MAIN, "args": {}}


def test_the_six_readers_on_a_synthetic_trace():
    """Two calls 500 us apart, each with kernels launched in the body and
    in each two-stage span, ROIAlign's spans inside the box and mask
    heads, and device idle gaps that open in the body (42 us), the
    proposals (11 us), the box post-processing (20 us) and after the
    mask head (outside every span)."""
    events = [_span("bench/window", 0, 1000)]
    corr = 0
    for c in (0, 500):
        def k(launch, start, end):
            nonlocal corr
            corr += 1
            return [_launch(c + launch, corr),
                    _kernel(c + start, end - start, corr)]

        events += [
            _span("detector/body", c, 100), *k(5, 10, 60),
            _span("two_stage/rpn_head", c + 100, 20), *k(101, 102, 124),
            _span("two_stage/proposals", c + 122, 10), *k(123, 124, 129),
            _span("two_stage/box_head", c + 135, 65),
            _span("roi_align/forward", c + 135, 20), *k(136, 140, 165),
            *k(160, 165, 202),
            _span("two_stage/box_postprocess", c + 200, 20),
            *k(201, 202, 212),
            _span("two_stage/mask_head", c + 220, 258),
            _span("roi_align/forward", c + 220, 10), *k(221, 232, 240),
            *k(235, 240, 480)]
    view = tracemath.TraceView(events, 2, 1000.0, None, H100)

    def read(name, v=view):
        return cells.metric_reader(name)(v)

    assert read("serve.proposals_ms") == pytest.approx(5e-3)
    assert read("serve.roi_align_ms") == pytest.approx((25 + 8) * 1e-3)
    assert read("serve.box_head_ms") == pytest.approx((25 + 37) * 1e-3)
    assert read("serve.box_postprocess_ms") == pytest.approx(10e-3)
    assert read("serve.mask_head_ms") == pytest.approx((8 + 240) * 1e-3)
    assert read("serve.two_stage_idle_ms") == pytest.approx(
        (11 + 20) * 1e-3)
    # a trace without the two-stage spans (PAA's): they read nothing
    bare = tracemath.TraceView(events[:4], 1, 1000.0, None, H100)
    for name in ("serve.proposals_ms", "serve.roi_align_ms",
                 "serve.box_head_ms", "serve.box_postprocess_ms",
                 "serve.mask_head_ms", "serve.two_stage_idle_ms"):
        assert read(name, bare) is None


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["families/mask_rcnn.py",
                                  "reference/mask_rcnn.py"])
def test_imports_neither_jax_nor_the_program(path):
    names = set(_imports(os.path.join(cells.HERE, path)))
    assert not names & FORBIDDEN, names
    if path.startswith("reference"):
        assert "benchmark" not in names  # relative imports alone

"""The port's stage, DCN and host-read spans on the CPU, under
``torch.profiler`` at a slim PAA-R50 (32 FPN channels, an eighth of
R-50's widths, float32) and 2 x 64 x 96 uint8 batches:

- one ``make_eval_fn`` call opens ``detector/body``, ``detector/fpn``,
  ``detector/head`` and ``detector/postprocess`` once each, in order,
  one ``sync/h2d_copy`` and one ``sync/select_tier`` per FPN level,
  each around its host read;
- a train step opens the three stage spans inside
  ``train_step/forward`` and ``sync/h2d_copy`` inside
  ``train_step/input``; the GMM opens one ``sync/gmm_converged`` per
  convergence read;
- a ``DeformConv`` forward opens ``deform_conv2d/forward``;
- a narrow Mask R-CNN call opens ``two_stage/rpn_head``,
  ``two_stage/proposals``, ``two_stage/box_head``,
  ``two_stage/box_postprocess`` and ``two_stage/mask_head`` once each, in
  order, ``roi_align/forward`` inside the box and mask heads, and
  ``launch_counts()`` counts ROIAlign's two calls and their rois;
- every backward op of a conv links to the forward op of its stage by
  the benchmark's link (the profiler's ``fwdbwd`` flow events,
  ``benchmark/harness/spans.py``): a torch upgrade that drops the link
  fails here;
- ``do_train`` with TPU.PROFILE_DIR set writes a Chrome trace of its
  window with the step's and the stages' spans.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.engine.trainer import do_train
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.layers import Conv
from paa_tpu_torch.ops import gmm
from paa_tpu_torch.ops.dcn import DeformConv
from paa_tpu_torch.solver import make_optimizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import spans as bench_spans  # noqa: E402
from benchmark.harness.tracemath import TraceView, load_trace  # noqa: E402

HW = (64, 96)
OVERRIDES = ["MODEL.PAA_ON", True,
             "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
             "MODEL.RETINANET.USE_C5", False,
             "MODEL.PAA.PRE_NMS_TOP_N", 50,
             "TEST.DETECTIONS_PER_IMG", 10,
             "TPU.MAX_GT", 6,
             "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
             "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
             "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
             "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
             "TPU.COMPUTE_DTYPE", "float32"]
STAGES = ["detector/body", "detector/fpn", "detector/head"]
SCALAR_READ = "aten::_local_scalar_dense"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(extra=()):
    cfg = get_cfg()
    cfg.merge_from_list(OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    gt_boxes = np.zeros((2, 6, 4), np.float32)
    gt_boxes[:, :2] = [[10, 10, 50, 40], [30, 20, 90, 60]]
    gt_labels = np.zeros((2, 6), np.int32)
    gt_labels[:, :2] = [3, 7]
    return {"images": rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8),
            "image_sizes": np.asarray([[64.0, 96.0], [60.0, 90.0]],
                                      np.float32),
            "gt_boxes": gt_boxes, "gt_labels": gt_labels}


def _traced(fn):
    """The Chrome trace's events of one ``fn()`` under the profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return load_trace(prof)


def _spans(events, prefix=""):
    """The spans whose name starts with ``prefix``, in time order."""
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda e: e["ts"])


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _count_inside(events, name, span):
    return sum(1 for e in events if e.get("name") == name
               and e.get("cat") == "cpu_op" and _inside(e, span))


@pytest.fixture(scope="module")
def model():
    return build_detection_model(_cfg(), device="cpu", seed=0)


@pytest.fixture(scope="module")
def eval_trace(model):
    eval_fn = model.make_eval_fn()
    b = _batch()
    eval_fn(b["images"], b["image_sizes"])
    return _traced(lambda: eval_fn(b["images"], b["image_sizes"]))


@pytest.fixture(scope="module")
def train_trace(model):
    optimizer, _ = make_optimizer(model.cfg, model.module)
    state = TrainState(model.module, optimizer)
    step = model.make_bucket_train_step(HW)
    step(state, _batch(1))
    # conv outputs of each stage that autograd records: their
    # ConvolutionBackward0 ops are the ones the link must find
    recorded = {s: 0 for s in STAGES}
    stage_of = {"detector/body": model.module.backbone.resnet,
                "detector/fpn": model.module.backbone.fpn,
                "detector/head": model.module.head}

    def counter(stage):
        def hook(module, inputs, out):
            recorded[stage] += int(out.requires_grad)
        return hook

    hooks = [m.register_forward_hook(counter(s))
             for s, root in stage_of.items() for m in root.modules()
             if isinstance(m, Conv)]
    try:
        events = _traced(lambda: step(state, _batch(2)))
    finally:
        for h in hooks:
            h.remove()
    return events, recorded


def test_eval_call_opens_the_stages_once_each_in_order(eval_trace):
    names = [e["name"] for e in _spans(eval_trace, "detector/")]
    assert names == [*STAGES, "detector/postprocess"]


def test_eval_call_opens_a_tier_read_per_level_and_one_copy(model,
                                                            eval_trace):
    _, counts = model.anchors_for(HW)
    tiers = _spans(eval_trace, "sync/select_tier")
    assert len(tiers) == len(counts) == 5
    post = _spans(eval_trace, "detector/postprocess")[0]
    # each around its own host read of the level's largest count
    assert all(_inside(t, post) for t in tiers)
    assert [_count_inside(eval_trace, SCALAR_READ, t) for t in tiers] == \
        [1] * 5
    copies = _spans(eval_trace, "sync/h2d_copy")
    body = _spans(eval_trace, "detector/body")[0]
    assert len(copies) == 1 and copies[0]["ts"] + copies[0]["dur"] <= \
        body["ts"]
    assert {e["name"] for e in _spans(eval_trace, "sync/")} == {
        "sync/h2d_copy", "sync/select_tier"}


def test_train_step_opens_the_stages_inside_its_forward(train_trace):
    events, _ = train_trace
    forward = _spans(events, "train_step/forward")
    assert len(forward) == 1
    stages = _spans(events, "detector/")
    assert [e["name"] for e in stages] == STAGES
    assert all(_inside(s, forward[0]) for s in stages)
    copies = _spans(events, "sync/h2d_copy")
    (inp,) = _spans(events, "train_step/input")
    assert len(copies) == 1 and _inside(copies[0], inp)


@pytest.mark.parametrize("tol,reads", [(0.0, 9), (1e-3, None)])
def test_gmm_opens_one_span_per_convergence_read(tol, reads):
    """tol 0 never converges: a read every CHECK_EVERY iterations of
    100, 9 in all; at sklearn's tol the fit stops at its first read that
    finds every row converged. Every host read of the fit is one span."""
    g = torch.Generator().manual_seed(0)
    values = torch.cat([torch.rand(6, 20, generator=g),
                        2 + torch.rand(6, 20, generator=g)], dim=1)
    valid = torch.rand(6, 40, generator=g) > 0.2
    events = _traced(lambda: gmm.gmm_fit_predict(values, valid, tol=tol))
    got = _spans(events, gmm.SPAN_SYNC_CONVERGED)
    all_reads = sum(1 for e in events if e.get("name") == SCALAR_READ)
    assert len(got) == all_reads >= 1
    assert [_count_inside(events, SCALAR_READ, s) for s in got] == \
        [1] * len(got)
    if reads is not None:
        assert len(got) == reads == (100 - 1) // gmm.CHECK_EVERY


def test_train_step_gmm_reads_are_its_host_reads(train_trace):
    events, _ = train_trace
    got = _spans(events, gmm.SPAN_SYNC_CONVERGED)
    (assign,) = _spans(events, "paa_loss/assignment")
    assert got and all(_inside(s, assign) for s in got)
    reads = [e for e in events if e.get("name") == SCALAR_READ]
    assert len(reads) == len(got)
    assert all(any(_inside(r, s) for s in got) for r in reads)


MASK_RCNN = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
             "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
             "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
             "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
             "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 5,
             "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 32,
             "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (32, 32, 32, 32),
             "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
             "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
             "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 40,
             "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 10,
             "TPU.COMPUTE_DTYPE", "float32"]
TWO_STAGE = ["two_stage/rpn_head", "two_stage/proposals",
             "two_stage/box_head", "two_stage/box_postprocess",
             "two_stage/mask_head"]


def test_mask_rcnn_call_opens_the_two_stage_spans_and_counts_rois():
    from paa_tpu_torch.ops import launch_counts

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs",
                                     "e2e_mask_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list(MASK_RCNN)
    cfg.freeze()
    eval_fn = build_detection_model(cfg, device="cpu").make_eval_fn()
    b = _batch()
    before = launch_counts()
    events = _traced(lambda: eval_fn(b["images"], b["image_sizes"]))
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    assert [e["name"] for e in _spans(events, "two_stage/")] == TWO_STAGE
    pools = _spans(events, "roi_align/forward")
    heads = {e["name"]: e for e in _spans(events, "two_stage/")}
    assert len(pools) == 2
    assert _inside(pools[0], heads["two_stage/box_head"])
    assert _inside(pools[1], heads["two_stage/mask_head"])
    # 40 proposals and 10 detections an image, two images
    assert counts["roi_align"] == 2
    assert counts["roi_align_rois"] == 2 * 40 + 2 * 10
    assert counts["nms_batched"] == counts["nms_global"] == 0  # plain


@pytest.mark.parametrize("grad", [False, True])
def test_deform_conv_forward_opens_its_span(grad):
    torch.manual_seed(0)
    conv = DeformConv(8, 8, deformable_groups=2)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_(0.0, 0.1)
    x = torch.randn(2, 8, 12, 16, requires_grad=grad)

    def run():
        with torch.set_grad_enabled(grad):
            out = conv(x)
        if grad:
            out.sum().backward()

    events = _traced(run)
    assert len(_spans(events, "deform_conv2d/forward")) == 1
    assert len(_spans(events, "deform_conv2d/backward")) == int(grad)


def test_backward_ops_link_to_their_stage(train_trace):
    """The link the backward metrics use: every ConvolutionBackward0 op
    of the step goes to the stage whose conv recorded its node, as many
    to each stage as the stage has convs whose output autograd
    recorded (the frozen stem and res2 record none)."""
    events, recorded = train_trace
    view = TraceView(events, 1, 1.0, None, "cpu")
    linked = bench_spans.backward_ops_by_stage(view)
    conv_bwd = bench_spans.BACKWARD_OP + "ConvolutionBackward0"
    by_stage = {s: sum(op["name"] == conv_bwd for op in linked.get(s, []))
                for s in STAGES}
    assert by_stage == recorded
    assert all(n > 0 for n in recorded.values())
    total = sum(1 for e in events if e.get("name") == conv_bwd)
    assert sum(by_stage.values()) == total
    # every op linked to a stage is one of the engine's backward ops
    assert all(op["name"].startswith(bench_spans.BACKWARD_OP)
               for ops in linked.values() for op in ops)


def test_do_train_writes_the_profile_window(tmp_path):
    cfg = _cfg(["SOLVER.MAX_ITER", 3, "TPU.PROFILE_DIR", str(tmp_path),
                "TPU.PROFILE_START", 1, "TPU.PROFILE_STEPS", 1])
    model = build_detection_model(cfg, device="cpu", seed=0)
    optimizer, _ = make_optimizer(cfg, model.module)
    state = TrainState(model.module, optimizer)
    do_train(cfg, model, state, [_batch(s) for s in range(3)])
    assert state.step == 3
    (name,) = os.listdir(tmp_path)
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / name) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    # one traced step of the three: steps [1, 2)
    forward = _spans(events, "train_step/forward")
    assert len(forward) == 1
    assert [e["name"] for e in _spans(events, "detector/")] == STAGES
    assert all(_inside(s, forward[0]) for s in _spans(events, "detector/"))

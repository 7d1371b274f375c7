"""Mask R-CNN R-50-FPN of the port against the benchmark's plain
reference (benchmark/reference/mask_rcnn.py), stage by stage, on the
CPU at a narrow size: a 16/32-channel body, 64 FPN channels, a 64-wide
box MLP, 5 classes, 200/100/100 proposals and 20 detections an image,
float32, two 64 x 96 uint8 images, one set of weights from the
benchmark's ``weights.make_weights`` loaded into both sides.

The program runs through ``make_eval_fn``; the benchmark family's hooks
record what its RPN head, box head and mask head take and give, and each
stage of the reference runs on the program's own input. Tolerances,
each with its reason:

- RPN outputs within 1e-5 of each output's largest magnitude: float32
  convolutions of the same weights, the FPN's upsample written two ways;
- proposals exact (valid slots and their boxes): the same float32
  decode, clip and greedy NMS order on the same RPN outputs;
- box-head logits and deltas within 1e-4 of the largest magnitude: the
  program places ROIAlign's samples as the JAX package rounds them
  (float64, once), the reference as the legacy kernel does (float32),
  an ulp apart at most, which moves a pooled value by ~1e-5;
- detections from the program's box outputs: valid and labels exact,
  boxes and scores equal (the same float32 softmax, decode and NMS);
- mask logits within 1e-4 of the largest magnitude (ROIAlign as above);
- the masks served: the sigmoid of the program's logits at each
  detection's class, exact.
"""

import copy
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.families import mask_rcnn as fam  # noqa: E402
from benchmark.harness import program, weights as W  # noqa: E402
from benchmark.reference import mask_rcnn as ref_mrcnn  # noqa: E402
from benchmark.reference.model import normalize  # noqa: E402
from benchmark.tests.test_bench_mask_rcnn import narrow_config  # noqa: E402

CPU = torch.device("cpu")
HW = (64, 96)
SIZES = torch.tensor([[64.0, 96.0], [60.0, 90.0]])
SEED = 2**31 + 23


@pytest.fixture(autouse=True, scope="module")
def _threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _images(seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (2, *HW, 3), generator=gen, dtype=torch.uint8)
    return W.content_mask(x, (60, 90))


def _served(conf, images, seed=SEED):
    """The program's detections of ``images`` through make_eval_fn, what
    its heads took and gave, the reference (float32, the same weights)
    and its own float32 features of the images."""
    wts = W.make_weights(fam.state_shapes(conf), conf["weights"], seed, CPU)
    model = program.build_model(conf, wts, CPU)
    with fam.capture(model) as captured:
        out = model.make_eval_fn()(images, SIZES)
    ref = conf["reference"]
    reference = ref_mrcnn.build(ref)
    reference.load_state_dict(wts, strict=True)
    with torch.no_grad():
        feats = reference.backbone(normalize(
            images, SIZES, ref["pixel_mean"], ref["pixel_std"]))
    return out, captured[0], reference, feats


@pytest.fixture(scope="module")
def served():
    conf = narrow_config()
    return (conf["reference"], *_served(conf, _images()))


def _close(got, want, rel):
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.abs().max()), err


def test_rpn_outputs_match_the_reference(served):
    ref, _, cap, reference, feats = served
    with torch.no_grad():
        want = reference.rpn_head(feats)
    for key in fam.RPN_KEYS:
        assert cap["rpn"][key].shape == want[key].shape
        _close(cap["rpn"][key], want[key], 1e-5)


def test_proposals_match_the_reference_exactly(served):
    ref, _, cap, _, _ = served
    anchors, counts = ref_mrcnn.anchors(ref["rpn"], HW)
    boxes, _, valid = ref_mrcnn.select_proposals(cap["rpn"], SIZES,
                                                 anchors, counts,
                                                 ref["rpn"])
    props = cap["proposals"].reshape(boxes.shape)
    assert int(valid.sum()) > 0
    assert torch.equal(props[valid], boxes[valid])


def test_box_head_matches_the_reference_at_the_programs_proposals(served):
    ref, _, cap, reference, feats = served
    k = cap["proposals"].shape[0] // 2
    with torch.no_grad():
        cls, deltas = reference.box_head(
            feats, cap["proposals"], torch.arange(2).repeat_interleave(k))
    _close(cap["box_cls"], cls, 1e-4)
    _close(cap["box_deltas"], deltas, 1e-4)


def test_detections_match_the_reference_post_processing(served):
    ref, out, cap, _, _ = served
    anchors, counts = ref_mrcnn.anchors(ref["rpn"], HW)
    _, _, valid = ref_mrcnn.select_proposals(cap["rpn"], SIZES, anchors,
                                             counts, ref["rpn"])
    props = cap["proposals"].reshape(2, -1, 4)
    k = props.shape[1]
    want = ref_mrcnn.box_postprocess(
        cap["box_cls"].reshape(2, k, -1),
        cap["box_deltas"].reshape(2, k, -1, 4), props, valid, SIZES,
        ref["box_head"])
    assert torch.equal(out["valid"], want["valid"])
    assert torch.equal(out["labels"], want["labels"])
    v = want["valid"]
    assert torch.equal(out["boxes"][v], want["boxes"][v])
    assert torch.equal(out["scores"], want["scores"])


def test_mask_head_matches_the_reference_at_the_programs_boxes(served):
    ref, out, cap, reference, feats = served
    d = out["boxes"].shape[1]
    assert torch.equal(cap["det_rois"], out["boxes"].reshape(-1, 4))
    with torch.no_grad():
        logits = reference.mask_head(feats, cap["det_rois"],
                                     torch.arange(2).repeat_interleave(d))
    assert cap["mask_logits"].shape == logits.shape == (2 * d, 4, 28, 28)
    _close(cap["mask_logits"], logits, 1e-4)
    probs = ref_mrcnn.mask_probs(cap["mask_logits"],
                                 out["labels"].reshape(-1))
    assert torch.equal(out["masks"].reshape(probs.shape), probs)


def test_the_cls_bias_lift_lets_detections_pass():
    """At the published 81 classes, with the configuration's weights
    but a zero cls bias, every foreground class scores about 1/81, under
    the 0.05 threshold: few candidates. The configuration's lift,
    a per-class bias drawn in [-4, 4], leaves several classes above the
    threshold at each roi, and the full 20 detections an image."""
    conf = narrow_config()
    conf["cfg"]["MODEL.ROI_BOX_HEAD.NUM_CLASSES"] = 81
    conf["reference"]["box_head"]["num_classes"] = 81
    unlifted = copy.deepcopy(conf)
    unlifted["weights"] = [r for r in conf["weights"]
                           if r["match"] != r"^box_head\.cls_score\.bias$"]
    found = []
    for c in (unlifted, conf):
        out, cap, _, _ = _served(c, _images(2))
        k = cap["proposals"].shape[0] // 2
        cand = ref_mrcnn.box_candidates(
            cap["box_cls"].reshape(2, k, -1),
            cap["box_deltas"].reshape(2, k, -1, 4),
            cap["proposals"].reshape(2, k, 4),
            torch.ones(2, k, dtype=torch.bool), SIZES,
            c["reference"]["box_head"])[3]
        found.append((int(cand.sum()), int(out["valid"].sum()), k))
    (none, _, k), (lifted, valid, _) = found
    assert lifted >= 2 * 2 * k and valid == 2 * 20
    assert none * 10 < lifted

"""Keypoint R-CNN in the PyTorch port against the JAX package, on the CPU:
the keypoint structures (flip, resize, heatmap bins), the cv2-free cubic
resize and the heatmap decode, the keypoint head, its loss and
gradient, one and three train steps of a narrow Keypoint R-CNN, the
loader's ``gt_keypoints``, the OKS evaluator, the eval path to the bbox
and keypoints tables, and ``load_jax_params`` over the whole model. The
narrow config is tests/test_torch_port_two_stage_train.py's (R-50-FPN,
64 channels, MLP 64, 2 x 64 x 96, 64 rois per image) with 2 classes and
keypoint CONV_LAYERS (32, 32), float32.

Tolerances, each with its reason:
- integer outputs equal: heatmap bins and validity, flips, sampled
  anchors and rois, labels, GT indices, num_pos;
- the cubic resize equals ``cv2.resize(INTER_CUBIC)`` bit for bit (the
  same float32 products summed in cv2's order), so the decoded
  keypoints' argmax positions, and so x and y, equal the JAX package's;
  the softmax scores within 1e-5 relative (float32 exps of torch's
  vectorized exp and numpy's differ by an ulp, and up to ~10^5 of them
  are summed in another order); an exact tie of two peaks takes the first in
  row-major order on both sides (gap 0, pinned);
- the keypoint head within 1e-4 of its largest magnitude (convolutions
  of another summation order; the bilinear x2, border rows included,
  within the same); its 4x4 deconv kernel is asymmetric, so a kernel
  carried across unflipped shows;
- the keypoint loss within 1e-6 relative, its gradient within 1e-6 of
  its largest magnitude;
- whole steps: as tests/test_torch_port_two_stage_train.py (losses
  within 1e-4 relative in the first step, 1e-3 after), with loss_kp
  under the same limits; the keypoint deconv's bias gradient is 0
  exactly (each map's softmax cross-entropy gradient sums to 0 over its
  bins), so both packages' are rounding, held within 1e-6 of the
  deconv kernel's largest gradient;
- the OKS evaluator: all 10 metrics within 1e-6 (the same float64
  algorithm);
- the eval path: the bbox and keypoints tables within 1e-6.
"""

import json
import os
import pickle
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import reference_layout as rl
from paa_tpu.data import loader as jloader
from paa_tpu.data import transforms as jtransforms
from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine.inference import inference as jax_inference
from paa_tpu.evaluation import coco_eval as jeval
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import roi_keypoint_head as jax_kp_head
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu.structures import keypoints as jkps
from paa_tpu_torch.data import loader, transforms
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.evaluation import coco_eval
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.roi_keypoint_head import (
    KeypointHead, keypoint_loss)
from paa_tpu_torch.structures import keypoints as kps
from paa_tpu_torch.tools import synth_catalog, train_net
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (
    HW, STEPS, TRAIN, assert_gradients_and_update_match, assert_step_matches,
    cfgs, later_step_tolerances, roi_box_loss_with_samples,
    rpn_loss_with_masks, run_steps, two_stage_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
KEYPOINT = ["MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", (32, 32),
            "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 2]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the structures --------------------------------------------------------

def test_constants_match_jax():
    assert kps.PERSON_KEYPOINT_NAMES == jkps.PERSON_KEYPOINT_NAMES
    np.testing.assert_array_equal(kps.FLIP_INDS, jkps.FLIP_INDS)
    np.testing.assert_array_equal(kps.OKS_SIGMAS, jkps.OKS_SIGMAS)
    assert sorted(kps.FLIP_INDS) == list(range(17))
    assert (kps.FLIP_INDS[kps.FLIP_INDS] == np.arange(17)).all()


def _keypoint_set(rng, n=5):
    out = np.zeros((n, 17, 3), np.float32)
    out[..., :2] = rng.uniform(-5, 120, (n, 17, 2)).round(2)
    out[..., 2] = rng.choice([0, 1, 2], (n, 17))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_flip_and_resize_match_jax(seed):
    rng = np.random.RandomState(seed)
    pts = _keypoint_set(rng)
    for width in (96, 131):
        got = kps.flip_keypoints(pts, width)
        np.testing.assert_array_equal(got, jkps.flip_keypoints(pts, width))
        assert (got[pts[:, kps.FLIP_INDS, 2] == 0] == 0).all()
    np.testing.assert_array_equal(kps.resize_keypoints(pts, 1.37, 0.61),
                                  jkps.resize_keypoints(pts, 1.37, 0.61))


@pytest.mark.parametrize("draws", [(0.2, 0.1), (0.7, 0.9)])
def test_train_transform_keypoints_match_jax(draws):
    """A resize to another size and a flip (draw 0.1 < 0.5), then a
    resize without one."""
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
    boxes = np.asarray([[4, 6, 60, 50], [30, 10, 90, 63]], np.float32)
    pts = _keypoint_set(rng, 2)
    args = ((48, 72), 128, (102.9, 115.9, 123.6), (1.0, 1.0, 1.0))
    got = transforms.TrainTransform(*args, defer_normalize=True)(
        image, boxes.copy(), draws=draws, keypoints=pts)
    want = jtransforms.TrainTransform(*args, defer_normalize=True)(
        image, boxes.copy(), keypoints=pts, draws=draws)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# one trace for every example
_jax_heatmap_56 = jax.jit(lambda p, r: jkps.keypoints_to_heatmap(p, r, 56))

# no subnormal coordinates: XLA on the CPU flushes them to 0 (a point at
# -1e-45 takes bin 0 in the JAX package, -1 in the port, as in torch)
_coord = st.floats(-3.0, 40.0, allow_nan=False, allow_subnormal=False,
                   width=32)


@settings(max_examples=150, deadline=None)
@given(x1=st.floats(0, 10, allow_subnormal=False, width=32),
       y1=st.floats(0, 10, allow_subnormal=False, width=32),
       w=st.floats(0.5, 30, width=32), h=st.floats(0.5, 30, width=32),
       xs=st.lists(_coord, min_size=17, max_size=17),
       ys=st.lists(_coord, min_size=17, max_size=17),
       vis=st.lists(st.integers(0, 2), min_size=17, max_size=17),
       edges=st.lists(st.sampled_from(["x2", "y2", "both", "x1", "none"]),
                      min_size=17, max_size=17))
def test_keypoints_to_heatmap_matches_jax(x1, y1, w, h, xs, ys, vis, edges):
    """Points anywhere about the roi, some exactly on its left, right and
    bottom edges (the right and bottom snap into the last bin)."""
    roi = np.asarray([[x1, y1, np.float32(x1 + w), np.float32(y1 + h)]],
                     np.float32)
    pts = np.stack([xs, ys, vis], 1).astype(np.float32)[None]
    for k, e in enumerate(edges):
        if e in ("x2", "both"):
            pts[0, k, 0] = roi[0, 2]
        if e in ("y2", "both"):
            pts[0, k, 1] = roi[0, 3]
        if e == "x1":
            pts[0, k, 0] = roi[0, 0]
    lin, valid = kps.keypoints_to_heatmap(_t(pts), _t(roi), 56)
    jlin, jvalid = _jax_heatmap_56(jnp.asarray(pts), jnp.asarray(roi))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))


def test_keypoints_on_the_far_edges_take_the_last_bin():
    roi = np.asarray([[10.0, 20.0, 38.0, 48.0]], np.float32)
    pts = np.asarray([[[38.0, 30.0, 2], [20.0, 48.0, 1], [38.0, 48.0, 2],
                       [10.0, 20.0, 2], [38.01, 30.0, 2], [9.99, 30, 2],
                       [20.0, 30.0, 0]]], np.float32)
    lin, valid = kps.keypoints_to_heatmap(_t(pts), _t(roi), 56)
    assert valid.tolist() == [[1, 1, 1, 1, 0, 0, 0]]
    assert lin[0, :4].tolist() == [20 * 56 + 55, 55 * 56 + 20, 56 * 56 - 1, 0]


# ---- the cv2-free cubic resize and the heatmap decode -----------------------

@settings(max_examples=120, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300),
       channels=st.integers(1, 17), seed=st.integers(0, 1000))
def test_resize_cubic_equals_cv2(h, w, channels, seed):
    """Bit for bit at the keypoint head's 17 channels and every count but
    1, 3 and 4, where cv2 5.0 takes other code: within 1e-5 of the
    largest magnitude there."""
    m = np.random.RandomState(seed).normal(0, 3, (56, 56, channels)).astype(
        np.float32)
    want = cv2.resize(m, (w, h), interpolation=cv2.INTER_CUBIC)
    got = kps.resize_cubic(_t(m).permute(2, 0, 1), h, w).permute(1, 2, 0)
    if channels in (1, 3, 4):
        np.testing.assert_allclose(got.numpy(), want.reshape(h, w, channels),
                                   rtol=0, atol=1e-5 * np.abs(m).max())
    else:
        np.testing.assert_array_equal(got.numpy(),
                                      want.reshape(h, w, channels))


def _rois(rng, n):
    """Boxes of fractional sizes, 1 px, under 1 px and a few large."""
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    wh = np.exp(rng.uniform(np.log(0.3), np.log(400), (n, 2)))
    wh[:4] = [[1.0, 1.0], [0.4, 2.5], [1.0, 37.3], [56.0, 56.0]]
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_heatmaps_to_keypoints_matches_jax(seed):
    rng = np.random.RandomState(seed)
    rois = _rois(rng, 24)
    maps = rng.normal(0, 2, (24, 56, 56, 17)).astype(np.float32)
    maps[5, :, :, 3] = -np.inf  # a keypoint without a finite logit
    got = kps.heatmaps_to_keypoints(_t(maps).permute(0, 3, 1, 2), rois)
    want = jkps.heatmaps_to_keypoints(maps, rois)
    assert got.shape == want.shape == (24, 17, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-5, atol=0)
    assert got[5, 3, 2] == 0


def test_heatmap_tie_takes_the_first_peak_on_both_sides():
    """Two equal peaks (gap 0 after the resize): both packages take the
    first in row-major order."""
    maps = np.full((1, 56, 56, 1), -4.0, np.float32)
    maps[0, 10, 40, 0] = maps[0, 30, 5, 0] = 6.0
    rois = np.asarray([[0.0, 0.0, 56.0, 56.0]], np.float32)
    got = kps.heatmaps_to_keypoints(_t(maps).permute(0, 3, 1, 2), rois)
    want = jkps.heatmaps_to_keypoints(maps, rois)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert got[0, 0, :2].tolist() == [40.5, 10.5]


# ---- the keypoint head and its loss -----------------------------------------

def _features(rng, channels=16):
    hws = [(16, 24), (8, 12), (4, 6), (2, 3)]
    return [rng.normal(size=(2, h, w, channels)).astype(np.float32)
            for h, w in hws]


def test_keypoint_head_forward_matches_jax():
    rng = np.random.RandomState(5)
    feats = _features(rng)
    rois = np.asarray([[4, 6, 50, 40], [10, 2, 90, 60], [0, 0, 30, 63],
                       [30, 20, 34, 25], [0, 0, 95, 63]], np.float32)
    bidx = np.asarray([0, 1, 1, 0, 1], np.int32)
    jhead = jax_kp_head.KeypointHead(num_keypoints=5, conv_channels=(16, 8))
    jf = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), jf, jnp.asarray(rois),
        jnp.asarray(bidx)))["params"]
    params = _seeded_params(shapes, rng)
    kernel = params["kps_score_lowres"]["kernel"]
    assert kernel.shape == (4, 4, 8, 5)
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    want = np.asarray(jhead.apply({"params": params}, jf, jnp.asarray(rois),
                                  jnp.asarray(bidx)))
    head = KeypointHead(5, in_channels=16, conv_layers=(16, 8))
    load_jax_params(head, params)
    with torch.no_grad():
        got = head([_t(f).permute(0, 3, 1, 2) for f in feats], _t(rois),
                   _t(bidx).long())
    assert got.shape == (5, 5, 56, 56) and want.shape == (5, 56, 56, 5)
    got = got.permute(0, 2, 3, 1).numpy()
    tol = 1e-4 * np.abs(want).max()
    # the bilinear x2's border rows and columns, then the whole map
    for edge in (np.s_[:, [0, -1]], np.s_[:, :, [0, -1]]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=tol)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _loss_case(r=20, k=17, s=56):
    rng = np.random.RandomState(8)
    rois = _rois(rng, r)
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 4)
    pts = np.zeros((r, k, 3), np.float32)
    pts[..., 0] = rng.uniform(rois[:, :1] - 5, rois[:, 2:3] + 5, (r, k))
    pts[..., 1] = rng.uniform(rois[:, 1:2] - 5, rois[:, 3:4] + 5, (r, k))
    pts[..., 2] = rng.choice([0, 1, 2], (r, k))
    pts[::3, 0, 0] = rois[::3, 2]  # on the right edge
    positive = rng.rand(r) < 0.7
    logits = rng.normal(0, 2, (r, s, s, k)).astype(np.float32)
    return logits, rois, pts, positive


def test_keypoint_loss_and_gradient_match_jax():
    logits, rois, pts, positive = _loss_case()

    def jloss(lg):
        return jax_kp_head.keypoint_loss(
            lg, jnp.asarray(rois), jnp.asarray(pts),
            jnp.asarray(positive))["loss_kp"]

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = _t(logits).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = keypoint_loss(tl, _t(rois), _t(pts), _t(positive))["loss_kp"]
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    w = np.asarray(wgrad)
    np.testing.assert_allclose(tl.grad.permute(0, 2, 3, 1).numpy(), w,
                               rtol=0, atol=1e-6 * np.abs(w).max())
    lin, valid = kps.keypoints_to_heatmap(_t(pts), _t(rois), 56)
    assert int((valid.numpy() * positive[:, None]).sum()) > 30


def test_keypoint_loss_without_a_valid_point_is_zero():
    logits, rois, pts, positive = _loss_case(r=4)
    got = keypoint_loss(_t(logits).permute(0, 3, 1, 2), _t(rois), _t(pts),
                        torch.zeros(4, dtype=torch.bool))["loss_kp"]
    assert float(got) == 0.0


# ---- whole Keypoint R-CNN train steps ---------------------------------------

def keypoint_batch(seed):
    """two_stage_batch with 2 classes and 17 keypoints in each GT box (a
    third unlabelled, some on the box's right and bottom edges)."""
    batch = two_stage_batch(seed, num_classes=2)
    rng = np.random.RandomState(seed + 200)
    pts = np.zeros((*batch["gt_labels"].shape, 17, 3), np.float32)
    for b, i in zip(*np.nonzero(batch["gt_labels"])):
        x1, y1, x2, y2 = batch["gt_boxes"][b, i]
        pts[b, i, :, 0] = rng.uniform(x1, x2, 17)
        pts[b, i, :, 1] = rng.uniform(y1, y2, 17)
        pts[b, i, :, 2] = rng.choice([0, 1, 2], 17)
        pts[b, i, 0, 0], pts[b, i, 1, 1] = x2, y2
    batch["gt_keypoints"] = pts
    return batch


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = cfgs(CONFIG, KEYPOINT)
    batch = keypoint_batch(2)
    return batch, *run_steps(jcfg, cfg, batch, STEPS, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples)))


def test_first_keypoint_step_matches_jax(runs):
    batch, model, out = runs
    assert_step_matches(out[0]["port"], out[0]["jax"], batch,
                        losses=("loss_kp", "loss"))
    assert_step_matches(out[0]["port"], out[0]["jax"], batch)
    # the deconv's bias gradient is the sum of each map's softmax
    # cross-entropy gradient over its bins: 0
    deconv = "keypoint_head.kps_score_lowres."
    assert_gradients_and_update_match(
        model, out[0], zero={deconv + "bias": deconv + "weight"})
    assert model.module.keypoint_head.kps_score_lowres.weight.grad.abs(
    ).sum() > 0
    assert float(out[0]["port"]["metrics"]["loss_kp"]) > 0


def test_three_keypoint_steps_match_jax(runs):
    batch, _, out = runs
    for i, step in enumerate(out):
        assert_step_matches(step["port"], step["jax"], batch,
                            losses=("loss_kp", "loss"),
                            **later_step_tolerances(i))
    assert len({float(s["port"]["metrics"]["loss_kp"]) for s in out}) == \
        STEPS


def test_load_jax_params_reaches_every_parameter():
    """Every port tensor of the narrow Keypoint R-CNN is written from the
    JAX tree (the load is strict both ways) and none keeps its init."""
    jcfg, cfg = cfgs(CONFIG, KEYPOINT)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(4))
    model = build_detection_model(cfg, device="cpu")
    init = {k: v.clone() for k, v in model.module.state_dict().items()}
    load_jax_params(model.module, params)
    same = [k for k, v in model.module.state_dict().items()
            if torch.equal(v, init[k])]
    assert same == [] and any(k.startswith("keypoint_head.") for k in init)


# ---- the loader, the OKS evaluator and the eval path ------------------------

def test_loader_gt_keypoints_match_jax(tmp_path):
    """Keypoint R-CNN's train stream: 3 batches of 2 of a synthetic
    person-keypoint COCO with sizes and flips drawn per sample; every key,
    'gt_keypoints' (B, MAX_GT, 17, 3) float32 included, equals the JAX
    package's, and some sample was flipped."""
    ann_file, img_dir = synth_coco(str(tmp_path / "coco"), 6, seed=3,
                                   sizes=((96, 64), (64, 96)),
                                   person_keypoints=True)
    jcfg, cfg = cfgs(CONFIG, KEYPOINT + [
        "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 96,
        "TPU.TRAIN_BUCKETS", ((96, 96),), "SOLVER.IMS_PER_BATCH", 2,
        "SOLVER.MAX_ITER", 3, "TPU.MAX_GT", 16])
    data = COCODataset(ann_file, img_dir, True, with_keypoints=True)
    jdata = JCOCODataset(ann_file, img_dir, True, with_keypoints=True)
    for r, jr in zip(data.records, jdata.records):
        np.testing.assert_array_equal(r.keypoints, jr.keypoints)
    got = list(loader.make_data_loader(cfg, data, is_train=True, seed=5))
    want = list(jloader.make_data_loader(jcfg, jdata, is_train=True, seed=5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and "gt_keypoints" in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["gt_keypoints"].shape == (2, 16, 17, 3)
        n = (g["gt_labels"] > 0).sum(1)
        for b in range(2):
            assert g["gt_keypoints"][b, :n[b], :, 2].any()
            assert not g["gt_keypoints"][b, n[b]:].any()
    # the stream flips some samples and not others (flip draw < 0.5)
    flips = [loader.make_data_loader(cfg, data, is_train=True, seed=5
                                     )._draws(0, i)[1] < 0.5
             for i in range(6)]
    assert any(flips) and not all(flips)


def _oks_case(seed, n_images=5):
    """Person GTs with keypoints (one with none visible, one with
    num_keypoints 0, one crowd) and detections with keypoints near them
    or at random, on images of medium and large GTs."""
    rng = np.random.RandomState(seed)
    gt, dets = {}, {}
    aid = 0
    for img in range(1, n_images + 1):
        anns, boxes, scores, points = [], [], [], []
        for g in range(rng.randint(1, 5)):
            aid += 1
            x, y = rng.uniform(0, 200, 2)
            w, h = rng.uniform(30, 250, 2)
            pts = np.zeros((17, 3))
            pts[:, 0] = rng.uniform(x, x + w, 17)
            pts[:, 1] = rng.uniform(y, y + h, 17)
            pts[:, 2] = rng.choice([0, 1, 2], 17)
            pts[pts[:, 2] == 0, :2] = 0
            if aid == 2:
                pts[:] = 0  # no visible keypoint: the expanded-box branch
            num = int((pts[:, 2] > 0).sum())
            ann = dict(id=aid, image_id=img, category_id=1, bbox=[x, y, w, h],
                       area=float(w * h * 0.7), iscrowd=int(aid == 7),
                       keypoints=pts.reshape(-1).tolist(),
                       num_keypoints=0 if aid == 5 else num)
            anns.append(ann)
            for _ in range(rng.randint(0, 3)):
                noise = rng.normal(0, rng.choice([1, 5, 30]), (17, 2))
                p = np.concatenate([pts[:, :2] + noise,
                                    rng.uniform(0, 1, (17, 1))], 1)
                if aid == 2:
                    p[:, :2] = rng.uniform(x - w, x + 2 * w, (17, 2))
                points.append(p)
                boxes.append([x, y, w, h])
                scores.append(rng.uniform(0.05, 1))
        for _ in range(rng.randint(0, 3)):  # false positives
            p = np.concatenate([rng.uniform(0, 400, (17, 2)),
                                rng.uniform(0, 1, (17, 1))], 1)
            points.append(p)
            boxes.append([0, 0, 10, 10])
            scores.append(rng.uniform(0.05, 1))
        gt[img] = anns
        dets[img] = dict(boxes_xywh=np.asarray(boxes).reshape(-1, 4),
                         scores=np.asarray(scores),
                         category_ids=np.ones(len(scores), np.int64),
                         keypoints=np.asarray(points).reshape(-1, 17, 3))
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oks_evaluator_matches_jax(seed):
    gt, dets = _oks_case(seed)
    ids = sorted(gt)
    for img, anns in gt.items():
        d = dets[img]
        np.testing.assert_allclose(
            coco_eval.oks_iou(d["keypoints"], anns),
            jeval._oks_iou(d["keypoints"], anns), rtol=1e-12, atol=0)
    got = coco_eval.COCOEvaluator(gt, [1], ids, "keypoints").evaluate(dets)
    want = jeval.COCOEvaluator(gt, [1], ids, "keypoints").evaluate(dets)
    assert list(got) == list(want) and len(got) == 10
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["AP"] > 0


KP_EVAL = TRAIN + KEYPOINT + [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "TPU.TEST_BUCKETS", ((96, 96),), "TEST.IMS_PER_BATCH", 2,
    "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
]


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """5 person-keypoint images, 3 batches of 2 (the last padded), whose
    ground truth is the port's own three best detections of each image
    on a first pass, each with that detection's keypoints moved by a
    pixel or two (a third of them unlabelled); both packages then
    evaluate on it."""
    root = str(tmp_path_factory.mktemp("port_keypoint_eval"))
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=((96, 64), (64, 96)),
                                   person_keypoints=True)
    jcfg, cfg = cfgs(CONFIG, KP_EVAL[len(TRAIN):])
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), (96, 96)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu", seed=1)
    load_jax_params(model.module, params)
    captured = {}
    import paa_tpu_torch.engine.inference as port_inference
    plain = port_inference.heatmaps_to_keypoints

    def capture(maps, rois):
        out = plain(maps, rois)
        captured.setdefault("keypoints", []).append(out)
        return out

    first = os.path.join(root, "first")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_inference, "heatmaps_to_keypoints", capture)
        inference(cfg, model, COCODataset(ann_file, img_dir, False),
                  output_folder=first)
    with open(ann_file) as f:
        data = json.load(f)
    with open(os.path.join(first, "bbox.json")) as f:
        dets = json.load(f)
    rng = np.random.RandomState(9)
    data["annotations"] = []
    for img in data["images"]:
        mine = sorted((d for d in dets if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:3]
        for d in mine:
            x, y, w, h = d["bbox"]
            pts = np.zeros((17, 3))
            pts[:, 0] = rng.uniform(x, x + w, 17)
            pts[:, 1] = rng.uniform(y, y + h, 17)
            pts[:, 2] = rng.choice([0, 2, 2], 17)
            pts[pts[:, 2] == 0, :2] = 0
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img["id"],
                bbox=d["bbox"], area=w * h, category_id=1, iscrowd=0,
                keypoints=pts.reshape(-1).tolist(),
                num_keypoints=int((pts[:, 2] > 0).sum())))
    ann_file = os.path.join(root, "top3.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    want = jax_inference(jcfg, jmodel, {"params": params},
                         JCOCODataset(ann_file, img_dir, False))
    got = inference(cfg, model, COCODataset(ann_file, img_dir, False))
    return got, want, captured


def test_inference_bbox_and_keypoints_tables_match_jax(eval_case):
    got, want, captured = eval_case
    assert list(got) == list(want)
    assert sum(k.startswith("keypoints/") for k in got) == 10
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.3 < got["AP"] <= 1.0 and got["keypoints/AR"] >= 0.0
    decoded = np.concatenate(captured["keypoints"])
    assert decoded.shape[1:] == (17, 3) and len(decoded) >= 5
    assert np.isfinite(decoded).all()


# ---- the CLIs ---------------------------------------------------------------

CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools", "synth_catalog.py")
SLIM_BODY = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
             "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
             "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
             "MODEL.RESNETS.RES2_OUT_CHANNELS", 32]
CLI = KEYPOINT + SLIM_BODY + [
    "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64, "SOLVER.BASE_LR", 0.001,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 20,
    "INPUT.MIN_SIZE_TRAIN", (96,), "INPUT.MAX_SIZE_TRAIN", 128,
    "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 128,
    "TPU.TRAIN_BUCKETS", ((128, 128),), "TPU.TEST_BUCKETS", ((128, 128),),
    "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 4, "TPU.MAX_GT", 20,
    "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
    "PATHS_CATALOG", CATALOG, "DATASETS.TRAIN", ("keypoints_synth_coco_4",),
    "DATASETS.TEST", ("keypoints_synth_coco_4",)]
BBOX = sorted(["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
               "AR100", "ARs", "ARm", "ARl"])
OKS = sorted(["AP", "AP50", "AP75", "APm", "APl", "AR", "AR50", "AR75",
              "ARm", "ARl"])


def _opts(*pairs):
    return [str(v) for v in pairs]


def _keypoint_results(folder):
    with open(folder / "coco_results.json") as f:
        results = json.load(f)
    assert sorted(k for k in results if "/" not in k) == BBOX
    assert sorted(k[10:] for k in results if k.startswith("keypoints/")) \
        == OKS
    return results


def test_synth_catalog_serves_the_keypoint_dataset_names(tmp_path,
                                                         monkeypatch):
    """The config's own DATASETS (keypoints_coco_2017_*) resolve to a
    32-image synthetic person-keypoint COCO: one category, 17 keypoints
    and num_keypoints per box, the images of synth_coco_32."""
    monkeypatch.setattr(synth_catalog.DatasetCatalog, "DATA_DIR",
                        str(tmp_path))
    args = synth_catalog.DatasetCatalog.get("keypoints_coco_2017_val")["args"]
    with open(args["ann_file"]) as f:
        data = json.load(f)
    assert data["categories"] == [{"id": 1, "name": "person"}]
    assert len(data["images"]) == 32
    for a in data["annotations"]:
        pts = np.asarray(a["keypoints"]).reshape(17, 3)
        x, y, w, h = a["bbox"]
        seen = pts[:, 2] > 0
        assert a["num_keypoints"] == seen.sum() and a["category_id"] == 1
        assert (pts[seen, 0] >= x).all() and (pts[seen, 0] <= x + w).all()
        assert (pts[seen, 1] >= y).all() and (pts[seen, 1] <= y + h).all()
        assert not pts[~seen].any()
    plain = synth_catalog.DatasetCatalog.get("synth_coco_32")["args"]
    with open(plain["ann_file"]) as f:
        boxes = [a["bbox"] for a in json.load(f)["annotations"]]
    assert boxes == [a["bbox"] for a in data["annotations"]]


def test_train_net_keypoint_rcnn_two_iterations_then_test(tmp_path,
                                                          monkeypatch):
    """Two iterations from the config's catalog R-50 pickle on a
    synthetic person-keypoint COCO (finite box and keypoint losses),
    then its test pass to the bbox and keypoints tables."""
    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.config.paths_catalog import ModelCatalog

    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(SLIM_BODY)
    body = {k: v for k, v in rl.seeded_state_dict(rl.layout(cfg), 11).items()
            if k.startswith("backbone.body.")}
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": rl.c2_imagenet_blobs(body, seed=12)}, f,
                    protocol=2)
    out = tmp_path / "out"
    seen = {}
    rc = train_net.main(
        ["--config-file", CONFIG, "--device", "cpu",
         *_opts(*CLI, "SOLVER.MAX_ITER", 2, "OUTPUT_DIR", out)],
        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0 and sorted(seen) == [1, 2]
    for m in seen.values():
        assert np.isfinite(list(m.values())).all() and m["num_pos"] > 0
        assert m["loss_kp"] > 0
    ckpt = torch.load(out / "model_final", weights_only=True)
    assert "keypoint_head.kps_score_lowres.weight" in ckpt["model"]
    _keypoint_results(out / "inference" / "keypoints_synth_coco_4")


def test_test_net_keypoint_rcnn_prints_bbox_and_keypoints(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--config-file", CONFIG, "--device", "cpu",
         *_opts(*CLI, "OUTPUT_DIR", out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path / "synth")})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    text = proc.stdout + proc.stderr
    assert "Task: bbox" in text and "Task: keypoints" in text
    assert "Keypoint heatmaps on the host" in text
    results = _keypoint_results(out / "inference" / "keypoints_synth_coco_4")
    assert all(np.isfinite(list(results.values())))

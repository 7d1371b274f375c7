"""Mask R-CNN in the PyTorch port against the JAX package, on the CPU:
the cv2-free polygon fill and paste, the RLE helpers, the mask head, its
targets and loss, the narrow Mask R-CNN's train steps, its eval path to
the bbox and segm tables, and the loader's ``gt_masks``. The narrow
config is tests/test_torch_port_two_stage_train.py's (R-50-FPN, 64
channels, 5 classes, 2 x 64 x 96, 64 rois per image) with 64-channel
mask convs, float32.

Tolerances, each with its reason:
- the polygon fill equals ``cv2.fillPoly`` bit for bit (a hypothesis
  sweep of polygons inside and across the image's edges), so
  ``rasterize_instances`` and the RLEs equal the JAX package's;
- the pasted bitmask equals the JAX package's except at pixels whose
  cv2 INTER_LINEAR value lies within 1e-6 of the 0.5 threshold (cv2's
  vectorized sums round a few ulps apart from the port's numpy ones);
  the count of those pixels is reported;
- the mask head within 1e-4 of its largest magnitude (convolutions of
  another summation order); its deconv kernel is random, so a kernel
  that lands unflipped shows;
- mask targets from the same inputs equal except where the JAX
  package's bilinear crop lies within 1e-6 of 0.5 (counted); the mask
  loss within 1e-6 relative and its gradient within 1e-6 of its largest
  magnitude;
- whole steps: as tests/test_torch_port_two_stage_train.py, with the
  mask loss within 1e-4 relative (1e-3 after the first update) and the
  mask targets equal except where the
  JAX package's crop lies within 1e-3 of 0.5 (the sampled proposals,
  which the crops sample, agree to 1e-4 px; counted);
- the eval path: the bbox and segm AP tables within 1e-6.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data import loader as jloader
from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine.inference import inference as jax_inference
from paa_tpu.evaluation import mask_rle as jrle
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import roi_mask_head as jax_mask_head
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu.ops import roi_align as jax_roi
from paa_tpu.structures import masks as jmasks
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data import loader
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.evaluation import mask_rle
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.roi_mask_head import (
    MaskHead, crop_gt_masks_for_rois, mask_loss)
from paa_tpu_torch.structures import masks
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (
    HW, STEPS, TRAIN, assert_gradients_and_update_match, assert_step_matches,
    cfgs, later_step_tolerances, roi_box_loss_with_samples,
    rpn_loss_with_masks, run_steps, two_stage_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
MASK = ["MODEL.ROI_MASK_HEAD.CONV_LAYERS", (64, 64, 64, 64)]
M = 112  # the loader's box-normalized mask size


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the host side: fill, rasterize, paste, RLE ----------------------------

_point = st.tuples(st.integers(-12, 52), st.integers(-12, 52))


@settings(max_examples=300, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       polygons=st.lists(st.lists(_point, min_size=3, max_size=9),
                         min_size=1, max_size=3))
def test_fill_poly_equals_cv2(h, w, polygons):
    pts = [np.asarray(p, np.int32) for p in polygons]
    want = np.zeros((h, w), np.uint8)
    cv2.fillPoly(want, pts, 1)
    got = masks.fill_poly(np.zeros((h, w), np.uint8), pts)
    np.testing.assert_array_equal(got, want)


def _instances(seed, n=6):
    """COCO polygons (one or two per instance, some of fewer than three
    points) and the instances' boxes, some polygons past their box."""
    rng = np.random.RandomState(seed)
    polys, boxes = [], []
    for i in range(n):
        x, y = rng.uniform(0, 300, 2)
        w, h = rng.uniform(3, 200, 2)
        parts = []
        for _ in range(rng.randint(1, 3)):
            k = rng.randint(3, 12)
            parts.append(np.stack([rng.uniform(x - 2, x + w + 2, k),
                                   rng.uniform(y - 2, y + h + 2, k)], 1
                                  ).reshape(-1).round(2).tolist())
        if i == 0:
            parts.append([x, y, x + 1, y + 1])  # two points: skipped
        polys.append(parts)
        boxes.append([x, y, x + w, y + h])
    return polys, np.asarray(boxes, np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_and_bitmask_match_jax(seed):
    polys, boxes = _instances(seed)
    got = masks.rasterize_instances(polys, boxes, 8)
    want = jmasks.rasterize_instances(polys, boxes, 8)
    assert got.shape == (8, M, M) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got[:6].any(axis=(1, 2)).all() and not got[6:].any()
    for p in polys:
        np.testing.assert_array_equal(masks.polygons_to_bitmask(p, 480, 640),
                                      jmasks.polygons_to_bitmask(p, 480, 640))


def test_paste_matches_jax_up_to_the_threshold():
    """Boxes inside the image and across its edges (a detection box is
    clipped to the image before its rescale, so none lies wholly
    outside); 28x28 probabilities in [0, 1] and a box of 14 px (the
    exact 2x downscale)."""
    rng = np.random.RandomState(3)
    boundary, pasted = 0, 0
    for i in range(150):
        prob = rng.uniform(0, 1, (28, 28)).astype(np.float32)
        if i % 3 == 0:  # plateaus: values near 0.5 over whole regions
            prob = np.round(prob * 4) / 4
        x1, y1 = rng.uniform(-5, 230, 2)
        w, h = (13.0, 13.0) if i % 10 == 0 else rng.uniform(6, 250, 2)
        box = [x1, y1, x1 + w, y1 + h]
        got = masks.paste_mask_in_image(prob, box, 240, 320)
        want = jmasks.paste_mask_in_image(prob, box, 240, 320)
        xb1, yb1, xb2, yb2 = (int(round(v)) for v in box)
        raw = cv2.resize(prob, (max(xb2 - xb1 + 1, 1), max(yb2 - yb1 + 1, 1)),
                         interpolation=cv2.INTER_LINEAR)
        near = np.zeros((240, 320), bool)
        xs1, ys1 = max(xb1, 0), max(yb1, 0)
        xs2, ys2 = min(xb2 + 1, 320), min(yb2 + 1, 240)
        near[ys1:ys2, xs1:xs2] = np.abs(
            raw[ys1 - yb1:ys2 - yb1, xs1 - xb1:xs2 - xb1] - 0.5) <= 1e-6
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got[~near], want[~near])
        boundary += int((got != want).sum())
        pasted += int(want.sum())
        raw_port = masks.paste_mask_in_image(prob, box, 240, 320,
                                             threshold=None)
        np.testing.assert_allclose(raw_port[ys1:ys2, xs1:xs2],
                                   raw[ys1 - yb1:ys2 - yb1,
                                       xs1 - xb1:xs2 - xb1], atol=2e-7)
    assert pasted > 10000
    print(f"paste: {boundary} of {pasted} pixels differ, all within 1e-6 "
          f"of the threshold")


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_rle_matches_jax(seed):
    rng = np.random.RandomState(seed)
    bms = [rng.rand(37, 53) < p for p in (0.0, 0.3, 0.7, 1.0)]
    bms.append(np.zeros((0, 5), bool))
    rles = [mask_rle.encode(b) for b in bms]
    for b, r in zip(bms, rles):
        assert r == jrle.encode(b)
        np.testing.assert_array_equal(mask_rle.decode(r), jrle.decode(r))
        np.testing.assert_array_equal(mask_rle.decode(r), b)
        assert mask_rle.area(r) == jrle.area(r) == int(b.sum())
    crowd = np.asarray([0, 1, 0, 0])
    np.testing.assert_array_equal(mask_rle.iou(rles[:4], rles[:4], crowd),
                                  jrle.iou(rles[:4], rles[:4], crowd))
    polys, _ = _instances(seed)
    for p in polys:
        assert mask_rle.polygons_to_rle(p, 400, 500) == \
            jrle.polygons_to_rle(p, 400, 500)
    given_rle = {"size": [4, 5], "counts": [3, 6, 11]}
    assert mask_rle.polygons_to_rle(given_rle, 4, 5) == \
        jrle.polygons_to_rle(given_rle, 4, 5)


# ---- the mask head, its targets and loss -----------------------------------

def _features(rng, channels=16):
    hws = [(16, 24), (8, 12), (4, 6), (2, 3)]
    return [rng.normal(size=(2, h, w, channels)).astype(np.float32)
            for h, w in hws]


def test_mask_head_forward_matches_jax():
    rng = np.random.RandomState(5)
    feats = _features(rng)
    rois = np.asarray([[4, 6, 50, 40], [10, 2, 90, 60], [0, 0, 30, 63],
                       [30, 20, 34, 25]], np.float32)
    bidx = np.asarray([0, 1, 1, 0], np.int32)
    jhead = jax_mask_head.MaskHead(num_classes=4, conv_layers=(16, 16))
    jf = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), jf, jnp.asarray(rois),
        jnp.asarray(bidx)))["params"]
    params = _seeded_params(shapes, rng)
    kernel = params["conv5_mask"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    want = np.asarray(jhead.apply({"params": params}, jf, jnp.asarray(rois),
                                  jnp.asarray(bidx)))
    head = MaskHead(4, in_channels=16, conv_layers=(16, 16))
    load_jax_params(head, params)
    with torch.no_grad():
        got = head([_t(f).permute(0, 3, 1, 2) for f in feats], _t(rois),
                   _t(bidx).long())
    assert got.shape == (4, 4, 28, 28) and want.shape == (4, 28, 28, 4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4 * np.abs(want).max())


def _jax_crops(gt_masks, gt_boxes, rois, out_size=28):
    """The JAX package's bilinear crops before its 0.5 threshold
    (paa_tpu/modeling/roi_mask_head.py:120-150)."""
    m = gt_masks.shape[-1]
    gx1, gy1 = gt_boxes[:, 0], gt_boxes[:, 1]
    gw = jnp.maximum(gt_boxes[:, 2] - gx1 + 1.0, 1.0)
    gh = jnp.maximum(gt_boxes[:, 3] - gy1 + 1.0, 1.0)
    mask_rois = jnp.stack([(rois[:, 0] - gx1) / gw * m,
                           (rois[:, 1] - gy1) / gh * m,
                           (rois[:, 2] - gx1) / gw * m,
                           (rois[:, 3] - gy1) / gh * m], axis=1)

    def one(feat, roi):
        return jax_roi.roi_align(feat[None, :, :, None], roi[None],
                                 jnp.zeros((1,), jnp.int32),
                                 (out_size, out_size), 1.0, 2)[0, :, :, 0]

    return jax.vmap(one)(gt_masks.astype(jnp.float32), mask_rois)


def _mask_case(r=24):
    polys, boxes = _instances(6, n=r)
    gt_masks = masks.rasterize_instances(polys, boxes, r)
    rng = np.random.RandomState(7)
    rois = boxes + rng.normal(0, 8, boxes.shape).astype(np.float32)
    rois[:, 2:] = np.maximum(rois[:, 2:], rois[:, :2] + 1)
    rois[::5] = boxes[::5]  # some rois are their GT's box
    labels = rng.randint(-1, 5, r).astype(np.int32)
    valid = rng.rand(r) < 0.9
    return gt_masks, boxes, rois, labels, valid


def test_mask_targets_match_jax_up_to_the_threshold():
    gt_masks, boxes, rois, _, _ = _mask_case()
    want_raw = np.asarray(_jax_crops(*map(jnp.asarray,
                                          (gt_masks, boxes, rois))))
    want = np.asarray(jax_mask_head.crop_gt_masks_for_rois(
        *map(jnp.asarray, (gt_masks.astype(np.float32), boxes, rois))))
    np.testing.assert_array_equal(want, (want_raw > 0.5).astype(np.float32))
    got = crop_gt_masks_for_rois(_t(gt_masks).float(), _t(boxes), _t(rois))
    assert got.shape == want.shape == (24, 28, 28)
    near = np.abs(want_raw - 0.5) <= 1e-6
    np.testing.assert_array_equal(got.numpy()[~near], want[~near])
    assert 0.2 < want.mean() < 0.9
    print(f"mask targets: {int((got.numpy() != want).sum())} of "
          f"{want.size} differ, {int(near.sum())} within 1e-6 of 0.5")


def test_mask_loss_and_gradient_match_jax():
    gt_masks, boxes, rois, labels, valid = _mask_case()
    targets = np.asarray(jax_mask_head.crop_gt_masks_for_rois(
        *map(jnp.asarray, (gt_masks.astype(np.float32), boxes, rois))))
    logits = np.random.RandomState(8).normal(0, 2, (24, 28, 28, 4)).astype(
        np.float32)

    def jloss(lg):
        return jax_mask_head.mask_loss(lg, jnp.asarray(labels),
                                       jnp.asarray(targets),
                                       jnp.asarray(valid))["loss_mask"]

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = _t(logits).permute(0, 3, 1, 2).contiguous().requires_grad_()
    got = mask_loss(tl, _t(labels), _t(targets), _t(valid))["loss_mask"]
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    w = np.asarray(wgrad)
    np.testing.assert_allclose(tl.grad.permute(0, 2, 3, 1).numpy(), w,
                               rtol=0, atol=1e-6 * np.abs(w).max())
    assert ((labels > 0) & valid).sum() > 5


# ---- whole Mask R-CNN train steps ------------------------------------------

def crop_gt_masks_raw(gt_masks, matched_gt_boxes, rois, out_size=28):
    """The JAX package's crop without its threshold (``mask_loss_raw``
    applies it), so that its raw values come out of the step."""
    return _jax_crops(gt_masks, matched_gt_boxes, rois, out_size)


_jax_mask_loss = jax_mask_head.mask_loss


def mask_loss_raw(mask_logits, roi_labels, raw, roi_valid):
    """The JAX package's mask_loss on its thresholded targets, with the
    raw crops and the targets beside."""
    targets = (raw > 0.5).astype(jnp.float32)
    out = _jax_mask_loss(mask_logits, roi_labels, targets, roi_valid)
    return {**out, "mask_raw": raw, "mask_targets": targets}


def mask_batch(seed):
    """two_stage_batch with each GT's box-normalized bitmask from
    polygons about its box."""
    batch = two_stage_batch(seed)
    rng = np.random.RandomState(seed + 100)
    gt_masks = np.zeros((*batch["gt_labels"].shape, M, M), np.uint8)
    for b, i in zip(*np.nonzero(batch["gt_labels"])):
        x1, y1, x2, y2 = batch["gt_boxes"][b, i]
        k = rng.randint(4, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(0.5, 1.0, k)
        cx, cy, hw, hh = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, \
            (y2 - y1) / 2
        poly = np.stack([cx + hw * rad * np.cos(ang),
                         cy + hh * rad * np.sin(ang)], 1).reshape(-1)
        gt_masks[b, i] = masks.box_normalized_mask([poly.tolist()],
                                                   (x1, y1, x2, y2))
    batch["gt_masks"] = gt_masks
    return batch


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = cfgs(CONFIG, MASK)
    batch = mask_batch(2)
    return batch, *run_steps(jcfg, cfg, batch, STEPS, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples),
        (jax_mask_head, "crop_gt_masks_for_rois", crop_gt_masks_raw),
        (jax_mask_head, "mask_loss", mask_loss_raw)))


def _assert_mask_step_matches(step, batch, i):
    got, want = step["port"]["metrics"], step["jax"]["metrics"]
    assert_step_matches(step["port"], step["jax"], batch,
                        losses=("loss_mask",), **later_step_tolerances(i))
    raw = want["mask_raw"]
    targets = got["mask_targets"].reshape(raw.shape)
    near = np.abs(raw - 0.5) <= 1e-3
    np.testing.assert_array_equal(targets[~near],
                                  want["mask_targets"][~near])
    return int((targets != want["mask_targets"]).sum()), int(near.sum())


def test_first_mask_step_matches_jax(runs):
    batch, model, out = runs
    differ, near = _assert_mask_step_matches(out[0], batch, 0)
    assert_step_matches(out[0]["port"], out[0]["jax"], batch)
    assert_gradients_and_update_match(model, out[0])
    assert model.module.mask_head.conv5_mask.weight.grad.abs().sum() > 0
    print(f"mask targets: {differ} pixels differ, {near} within 1e-3 of 0.5")


def test_three_mask_steps_match_jax(runs):
    batch, _, out = runs
    for i, step in enumerate(out):
        _assert_mask_step_matches(step, batch, i)
        assert_step_matches(step["port"], step["jax"], batch,
                            **later_step_tolerances(i))
    assert len({float(s["port"]["metrics"]["loss_mask"]) for s in out}) == \
        STEPS


# ---- the eval path and the loader ------------------------------------------

EVAL = TRAIN + MASK + [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "TPU.TEST_BUCKETS", ((96, 96),), "TEST.IMS_PER_BATCH", 2,
    "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
]


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """5 images, 3 batches of 2 (the last padded), whose ground truth is
    the port's own three best detections of each image on a first pass,
    each with the polygon of a diamond in its box; both packages then
    evaluate on it."""
    root = str(tmp_path_factory.mktemp("port_mask_eval"))
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=((96, 64), (64, 96)))
    jcfg, cfg = cfgs(CONFIG, EVAL[len(TRAIN):])
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), (96, 96)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu", seed=1)
    load_jax_params(model.module, params)
    first = os.path.join(root, "first")
    inference(cfg, model, COCODataset(ann_file, img_dir, False),
              output_folder=first)
    with open(ann_file) as f:
        data = json.load(f)
    with open(os.path.join(first, "bbox.json")) as f:
        dets = json.load(f)
    data["annotations"] = []
    for img in data["images"]:
        mine = sorted((d for d in dets if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:3]
        for d in mine:
            x, y, w, h = d["bbox"]
            diamond = [x + w / 2, y, x + w, y + h / 2, x + w / 2, y + h, x,
                       y + h / 2]
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img["id"],
                bbox=d["bbox"], area=w * h / 2, segmentation=[diamond],
                category_id=d["category_id"], iscrowd=0))
    ann_file = os.path.join(root, "top3.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    want = jax_inference(jcfg, jmodel, {"params": params},
                         JCOCODataset(ann_file, img_dir, False))
    got = inference(cfg, model, COCODataset(ann_file, img_dir, False))
    return got, want


def test_inference_bbox_and_segm_tables_match_jax(eval_case):
    got, want = eval_case
    assert list(got) == list(want)
    assert sum(k.startswith("segm/") for k in got) == 12
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.3 < got["AP"] <= 1.0 and got["segm/AP"] > 0.0


def test_loader_gt_masks_match_jax(tmp_path):
    """Mask R-CNN's train stream: 3 batches of 2 of a synthetic COCO
    with polygons, flips and sizes drawn per sample; every key,
    'gt_masks' (B, MAX_GT, 112, 112) uint8 included, equals the JAX
    package's."""
    ann_file, img_dir = synth_coco(str(tmp_path / "coco"), 6, seed=3,
                                   sizes=((96, 64), (64, 96)))
    jcfg, cfg = cfgs(CONFIG, MASK + [
        "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 96,
        "TPU.TRAIN_BUCKETS", ((96, 96),), "SOLVER.IMS_PER_BATCH", 2,
        "SOLVER.MAX_ITER", 3, "TPU.MAX_GT", 16])
    got = list(loader.make_data_loader(
        cfg, COCODataset(ann_file, img_dir, True, with_masks=True),
        is_train=True, seed=5))
    want = list(jloader.make_data_loader(
        jcfg, JCOCODataset(ann_file, img_dir, True, with_masks=True),
        is_train=True, seed=5))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) and "gt_masks" in g
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["gt_masks"].shape == (2, 16, M, M)
        n = (g["gt_labels"] > 0).sum(1)
        for b in range(2):
            assert g["gt_masks"][b, :n[b]].any(axis=(1, 2)).all()
            assert not g["gt_masks"][b, n[b]:].any()

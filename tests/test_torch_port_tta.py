"""Test-time augmentation in the PyTorch port (paa_tpu_torch/engine/
bbox_aug.py) against the JAX package's (paa_tpu/engine/bbox_aug.py), on
the CPU, float32, with the narrow PAA-R50 of
tests/test_torch_port_model.py (its params carried across by
``load_jax_params``).

- The host numpy helpers (``np_greedy_ml_nms``, ``bbox_vote``,
  ``soft_bbox_vote``, ``build_aug_list``, ``_ceil32``) equal the JAX
  package's on seeded clusters of boxes and on the X-152 dcnv2 config's
  26 augmentations; each augmentation's padded raw batch equals the JAX
  package's resize (cv2), flip and bucket (1824 x 3008 at scale 1800 for
  a 480 x 640 image).
- ``TTAEngine.detect_batch`` on 2 images with a reduced list (the
  identity, two scales with their scale ranges, every augmentation also
  flipped) for each MERGE_TYPE with VOTE, and without VOTE: the merged
  labels and counts equal, boxes and scores within 1e-3 (as
  tests/test_torch_port_model.py holds the detections of this model:
  the convolutions sum in different orders).
- ``inference`` with TEST.BBOX_AUG.ENABLED over a synthetic PPM COCO:
  the AP table within 1e-6 of the JAX package's ``inference_tta``, and
  the same files as without TTA; under a process group of two ranks it
  raises.
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine import bbox_aug as jaug
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine import bbox_aug as aug
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import OVERRIDES, _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X152 = os.path.join(ROOT, "configs", "paa",
                    "paa_dcnv2_X_152_32x8d_FPN_2x.yaml")
TTA = OVERRIDES + [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.H_FLIP", True,
    "TEST.BBOX_AUG.SCALE_H_FLIP", True, "TEST.BBOX_AUG.SCALES", (48, 80),
    "TEST.BBOX_AUG.SCALE_RANGES", ((0, 48), (24, 10000)),
    "TEST.BBOX_AUG.VOTE", True, "TEST.IMS_PER_BATCH", 2,
    "TPU.COMPUTE_DTYPE", "float32",
]
# name: (VOTE, MERGE_TYPE)
MERGES = {"vote": (True, "vote"), "soft-vote": (True, "soft-vote"),
          "nms": (True, "nms"), "no_vote": (False, "vote")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(extra=()):
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(TTA + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def models():
    """The JAX engine (one per module: its jitted programs are cached by
    padded shape) and the port's model, from the same params."""
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), (64, 96)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu", seed=1)
    load_jax_params(model.module, params)
    variables = {"params": params}
    return jaug.TTAEngine(jcfg, jmodel, variables), jmodel, variables, model


# ---- the host helpers ----------------------------------------------------

def _clusters(seed, n_centers=6, per=8):
    """Boxes scattered around a few centres (IoU from ~0.3 to 1 within a
    cluster), scores in (0.05, 1), labels of 3 classes."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 300, (n_centers, 2))
    sides = rng.uniform(16, 120, (n_centers, 2))
    boxes = []
    for c, s in zip(centres, sides):
        jitter = rng.normal(0, 0.15, (per, 4)) * np.concatenate([s, s])
        xy = c - s / 2
        boxes.append(np.concatenate([xy, xy + s])[None] + jitter)
    boxes = np.concatenate(boxes).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
    labels = rng.randint(1, 4, len(boxes)).astype(np.int64)
    return boxes, scores, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_helpers_match_jax(seed):
    boxes, scores, labels = _clusters(seed)
    for th, n in ((0.5, 100), (0.6, 5), (0.3, 20)):
        np.testing.assert_array_equal(
            aug.np_greedy_ml_nms(boxes, scores, labels, th, n),
            jaug.np_greedy_ml_nms(boxes, scores, labels, th, n))
    for th in (0.66, 0.4):
        for got, want in zip(aug.bbox_vote(boxes, scores, th),
                             jaug.bbox_vote(boxes, scores, th)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(aug.soft_bbox_vote(boxes, scores, th, 0.05),
                             jaug.soft_bbox_vote(boxes, scores, th, 0.05)):
            np.testing.assert_array_equal(got, want)
    for n in (0, 1):  # no cluster to vote over
        assert aug.bbox_vote(boxes[:n], scores[:n], 0.66)[0].shape == (0, 4)
    assert [aug._ceil32(v) for v in (1, 32, 33, 1800, 3000)] == \
        [jaug._ceil32(v) for v in (1, 32, 33, 1800, 3000)]


def test_x152_aug_list_and_batches_match_jax():
    """The X-152 dcnv2 config's own TEST.BBOX_AUG: 26 augmentations (the
    identity, its flip, 12 scales each with its flip), and for a 480 x
    640 image the JAX package's resize (cv2), flip and bucket."""
    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(X152)
        cfg.freeze()
        cfgs.append(cfg)
    augs = aug.build_aug_list(cfgs[1])
    assert augs == jaug.build_aug_list(cfgs[0]) and len(augs) == 26
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    shapes = []
    for scale, max_size, hflip, _ in augs:
        got, sizes = aug.aug_batch([image], scale, max_size, hflip)
        oh, ow = jaug.get_resize_size((640, 480), scale, max_size)
        want = cv2.resize(image, (ow, oh), interpolation=cv2.INTER_LINEAR)
        if hflip:
            want = want[:, ::-1]
        bh = max(jaug._ceil32(min(scale, max_size)), jaug._ceil32(oh))
        bw = max(jaug._ceil32(max_size), jaug._ceil32(ow))
        assert got.shape == (1, bh, bw, 3) and sizes == [(oh, ow)]
        np.testing.assert_array_equal(got[0, :oh, :ow], want)
        assert not got[0, oh:].any() and not got[0, :, ow:].any()
        shapes.append(got.shape[1:3])
    assert max(shapes, key=lambda s: s[0] * s[1]) == (1824, 3008)


# ---- the engine ------------------------------------------------------------

def _raw_images():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8),
            rng.randint(0, 256, (90, 60, 3)).astype(np.uint8)]


@pytest.mark.parametrize("merge", sorted(MERGES))
def test_detect_batch_matches_jax(models, merge):
    jengine, _, _, model = models
    vote, merge_type = MERGES[merge]
    extra = ["TEST.BBOX_AUG.VOTE", vote,
             "TEST.BBOX_AUG.MERGE_TYPE", merge_type]
    jcfg, cfg = _cfgs(extra)
    jengine.cfg, jengine.vote = jcfg, vote
    images = _raw_images()
    want = jengine.detect_batch(images)
    got = aug.TTAEngine(cfg, model).detect_batch(images)
    assert len(got) == len(want) == 2
    for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
        assert len(gl) == len(wl) > 0
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-3)


# ---- the dataset path ------------------------------------------------------

@pytest.fixture(scope="module")
def tta_eval(models, tmp_path_factory):
    """5 PPM images of 96 x 64 and 64 x 96 whose ground truth is the
    port's own three best TTA detections of each image on a first pass;
    then both packages evaluate on it with TTA (soft-vote)."""
    jengine, jmodel, variables, model = models
    jcfg, cfg = _cfgs(["TEST.BBOX_AUG.MERGE_TYPE", "soft-vote"])
    root = str(tmp_path_factory.mktemp("port_tta"))
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=((96, 64), (64, 96)))
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
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img["id"],
                bbox=d["bbox"], area=d["bbox"][2] * d["bbox"][3],
                category_id=d["category_id"], iscrowd=0))
    ann_file = os.path.join(root, "top3.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    want = jaug.inference_tta(jcfg, jmodel, variables,
                              JCOCODataset(ann_file, img_dir, False))
    out = os.path.join(root, "port")
    got = inference(cfg, model, COCODataset(ann_file, img_dir, False),
                    output_folder=out)
    return got, want, out, cfg, ann_file, img_dir


def test_inference_tta_ap_table_matches_jax(tta_eval):
    got, want, out, *_ = tta_eval
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.3 < got["AP"] <= 1.0
    with open(os.path.join(out, "coco_results.json")) as f:
        assert json.load(f) == got
    with open(os.path.join(out, "bbox.json")) as f:
        dets = json.load(f)
    assert {d["image_id"] for d in dets} == set(range(1, 6))


def test_inference_tta_raises_under_several_ranks(tta_eval, monkeypatch):
    from paa_tpu_torch.utils import comm

    _, _, _, cfg, ann_file, img_dir = tta_eval
    monkeypatch.setattr(comm, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="one process"):
        inference(cfg, None, COCODataset(ann_file, img_dir, False))

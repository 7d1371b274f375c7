"""The evaluation slice of the PyTorch port against the JAX package's, on
the CPU: the native COCO matcher against its numpy version, the COCO
evaluator on random detections, the report helpers, and the whole eval
path (dataset -> bucketed loader -> make_eval_fn -> COCO AP) of a narrow
PAA-R50 on a small synthetic COCO with COCO's sparse category ids, the
JAX package running with its own params and the port with the same
params carried across by ``load_jax_params``. Then the port's
``test_net`` CLI, dry-run on that dataset.

Tolerances: the evaluators run the same float64 algorithm, so their
metrics agree within 1e-12. Through the models, the AP table agrees
within 1e-6 and the labels and keep counts are equal; boxes within 1e-3
and scores within 1e-3, as tests/test_torch_port_model.py holds the
detections of the same narrow model."""

import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine.inference import inference as jax_inference
from paa_tpu.evaluation import coco_eval as jeval
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import COCO_CATEGORY_IDS, synth_coco
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.evaluation import _native, coco_eval
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import OVERRIDES, _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the narrow model of tests/test_torch_port_model.py, fed by the loader
# at one bucket (one JAX compile), batches of 2 (so the JAX package's
# eval takes no device mesh on the 8 CPU test devices) and a padded tail
EVAL = OVERRIDES + [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "TPU.TEST_BUCKETS", ((96, 96),), "TEST.IMS_PER_BATCH", 2,
    "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
]
SIZES = ((96, 64), (64, 96))  # (w, h), as tiny_coco80 of test_reproduce_ap


# ---- the native matcher and the evaluator --------------------------------

def _iou_numpy(dts, gts, iscrowd):
    ious = np.zeros((len(dts), len(gts)))
    for j, (gx, gy, gw, gh) in enumerate(gts):
        x1 = np.maximum(dts[:, 0], gx)
        y1 = np.maximum(dts[:, 1], gy)
        x2 = np.minimum(dts[:, 0] + dts[:, 2], gx + gw)
        y2 = np.minimum(dts[:, 1] + dts[:, 3], gy + gh)
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        da = dts[:, 2] * dts[:, 3]
        ious[:, j] = inter / (da if iscrowd[j] else da + gw * gh - inter)
    return ious


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_iou_matches_numpy(seed):
    rng = np.random.RandomState(seed)
    dts = np.concatenate([rng.uniform(0, 50, (12, 2)),
                          rng.uniform(1, 30, (12, 2))], 1)
    gts = np.concatenate([rng.uniform(0, 50, (5, 2)),
                          rng.uniform(1, 30, (5, 2))], 1)
    crowd = rng.rand(5) < 0.3
    np.testing.assert_allclose(_native.bbox_iou_xywh(dts, gts, crowd),
                               _iou_numpy(dts, gts, crowd), rtol=1e-12)
    assert _native.bbox_iou_xywh(dts, gts[:0], crowd[:0]).shape == (12, 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matcher_matches_numpy(seed):
    """dtm and dt_ig of csrc/cocoeval.cpp equal ``_match_img_py``, with
    crowd, ignored and out-of-range entries and IoUs on the thresholds."""
    rng = np.random.RandomState(seed)
    n_dt, n_gt = rng.randint(0, 15), rng.randint(0, 8)
    ious = rng.uniform(0, 1, (n_dt, n_gt))
    ious[rng.rand(n_dt, n_gt) < 0.2] = 0.75  # exactly on a threshold
    g_ig = np.sort(rng.rand(n_gt) < 0.3)  # non-ignored first
    g_crowd = g_ig & (rng.rand(n_gt) < 0.5)
    oor = rng.rand(n_dt) < 0.2
    want = coco_eval._match_img_py(ious, g_ig, g_crowd, oor)
    got = _native.evaluate_img(ious, g_ig, g_crowd, oor, coco_eval.IOU_THRS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _gt_and_detections(seed, n_images=6):
    """COCO ground truth over sparse category ids (with crowd and
    ignored boxes of every area range) and detections jittered from it,
    plus false positives."""
    rng = np.random.RandomState(seed)
    cats = list(COCO_CATEGORY_IDS[:7])
    gt, dets, ann_id = {}, {}, 1
    for img in range(1, n_images + 1):
        anns = []
        for _ in range(rng.randint(0, 9)):
            side = np.exp(rng.uniform(np.log(8), np.log(200)))
            box = [float(v) for v in (*rng.uniform(0, 300, 2), side,
                                      side * rng.uniform(0.5, 2))]
            anns.append(dict(id=ann_id, image_id=img, bbox=box,
                             area=box[2] * box[3],
                             category_id=int(rng.choice(cats)),
                             iscrowd=int(rng.rand() < 0.1),
                             ignore=int(rng.rand() < 0.05)))
            ann_id += 1
        gt[img] = anns
        boxes, scores, cids = [], [], []
        for a in anns:
            if rng.rand() < 0.8:
                b = np.asarray(a["bbox"]) * rng.normal(1, 0.08, 4)
                boxes.append(b)
                scores.append(rng.rand())
                cids.append(a["category_id"] if rng.rand() < 0.9
                            else int(rng.choice(cats)))
        for _ in range(rng.randint(0, 6)):
            boxes.append([*rng.uniform(0, 300, 2), *rng.uniform(5, 100, 2)])
            scores.append(rng.rand())
            cids.append(int(rng.choice(cats)))
        dets[img] = dict(boxes_xywh=np.asarray(boxes).reshape(-1, 4),
                         scores=np.asarray(scores),
                         category_ids=np.asarray(cids, np.int64))
    return gt, cats, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    gt, cats, dets = _gt_and_detections(seed)
    ids = sorted(gt)
    got = coco_eval.COCOEvaluator(gt, cats, ids).evaluate(dets)
    want = jeval.COCOEvaluator(gt, cats, ids).evaluate(dets)
    assert list(got) == list(want) == list(coco_eval.METRICS)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])
    assert got["AP"] > 0


def test_coco_evaluator_without_detections_matches_jax():
    gt, cats, _ = _gt_and_detections(4)
    ids = sorted(gt) + [77]  # an image of no GT and no detection
    got = coco_eval.COCOEvaluator(gt, cats, ids).evaluate({})
    assert got == jeval.COCOEvaluator(gt, cats, ids).evaluate({})


def test_format_and_check_expected_results_match_jax(caplog):
    results = {k: 0.1 * i for i, k in enumerate(coco_eval.METRICS)}
    assert coco_eval.format_results(results) == jeval.format_results(
        results)
    ok = [("bbox", "AP", 0.0, 0.01), ("segm", "AP", 0.3, 0.01)]
    coco_eval.check_expected_results(results, ok, 4,
                                     logging.getLogger("test"))
    with pytest.raises(AssertionError, match="AP50"):
        coco_eval.check_expected_results(
            results, [("bbox", "AP50", 0.5, 0.01)], 4)


# ---- the whole eval path -------------------------------------------------

def _models():
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(EVAL)
    jcfg.freeze()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), (96, 96)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    cfg = get_cfg()
    cfg.merge_from_list(EVAL)
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu", seed=1)
    load_jax_params(model.module, params)
    return jcfg, jmodel, {"params": params}, cfg, model


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """5 images of tiny_coco80's sizes (3 batches of 2, the last padded)
    whose ground truth is the port's own three best detections of each
    image on a first pass, so that the AP is far from 0; both packages
    then evaluate on it."""
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("port_eval"))
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=SIZES)
    jcfg, jmodel, variables, cfg, model = _models()
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
    out = {}
    for name, run in (
            ("jax", lambda o: jax_inference(
                jcfg, jmodel, variables,
                JCOCODataset(ann_file, img_dir, False), output_folder=o)),
            ("port", lambda o: inference(
                cfg, model, COCODataset(ann_file, img_dir, False),
                output_folder=o))):
        folder = os.path.join(root, name)
        results = run(folder)
        with open(os.path.join(folder, "bbox.json")) as f:
            out[name] = (results, json.load(f))
    return out, ann_file, img_dir, data


def test_inference_ap_table_matches_jax(eval_case):
    out, *_ = eval_case
    got, want = out["port"][0], out["jax"][0]
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert 0.3 < got["AP"] < 1.0


def test_inference_detections_match_jax(eval_case):
    """Per image: the same number of detections, the same category ids
    in score order, boxes and scores within 1e-3; no padding image."""
    out, _, _, data = eval_case
    ids = [img["id"] for img in data["images"]]
    dets = {name: out[name][1] for name in out}
    assert {d["image_id"] for d in dets["port"]} == set(ids)
    for img_id in ids:
        got, want = ([d for d in dets[name] if d["image_id"] == img_id]
                     for name in ("port", "jax"))
        assert len(got) == len(want) > 0
        assert [d["category_id"] for d in got] == \
            [d["category_id"] for d in want]
        np.testing.assert_allclose([d["bbox"] for d in got],
                                   [d["bbox"] for d in want], atol=1e-3)
        np.testing.assert_allclose([d["score"] for d in got],
                                   [d["score"] for d in want], atol=1e-3)


def test_inference_raises_on_what_is_not_ported(eval_case):
    """Test-time augmentation (TEST.BBOX_AUG) runs for the dense
    detectors only, as in the JAX package, whose TTA engine reads a
    dense head's post-processing (here Faster R-CNN: no dense head)."""
    _, ann_file, img_dir, _ = eval_case
    cfg = get_cfg()
    cfg.merge_from_list(EVAL + ["TEST.BBOX_AUG.ENABLED", True,
                                "MODEL.PAA_ON", False])
    with pytest.raises(NotImplementedError, match="dense detectors"):
        inference(cfg, None, COCODataset(ann_file, img_dir, False))


def test_test_net_cli_dry_run(eval_case, tmp_path):
    """``python -m paa_tpu_torch.tools.test_net`` on the CPU through a
    catalog file, from a checkpoint of the port: exit 0 and the results
    in OUTPUT_DIR/inference/<dataset>/."""
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.solver import make_optimizer
    from paa_tpu_torch.utils.checkpoint import Checkpointer

    _, ann_file, img_dir, _ = eval_case
    catalog = tmp_path / "catalog.py"
    catalog.write_text(
        "class DatasetCatalog:\n"
        "    @staticmethod\n"
        "    def get(name):\n"
        "        return dict(factory='COCODataset', args=dict(\n"
        f"            root={img_dir!r}, ann_file={ann_file!r}))\n")
    *_, cfg, model = _models()
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    Checkpointer(str(tmp_path)).save("model_0000005", state, iteration=5)
    opts = [str(v) for v in EVAL]
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--device", "cpu", "--ckpt", str(tmp_path / "model_0000005"),
         "PATHS_CATALOG", str(catalog), "DATASETS.TEST", "('tiny',)",
         "OUTPUT_DIR", str(tmp_path / "out"), *opts],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "AP: " in proc.stdout
    with open(tmp_path / "out" / "inference" / "tiny" / "coco_results.json"
              ) as f:
        results = json.load(f)
    assert list(results) == list(coco_eval.METRICS)
    assert results["AP"] > 0.3  # the carried-across weights were loaded

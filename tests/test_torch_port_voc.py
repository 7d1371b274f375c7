"""Pascal VOC in the PyTorch port against the JAX package, on the CPU:
the VOC evaluation (``evaluation/voc_eval.py``) on tests/test_voc_eval.py's
cases and a hypothesis sweep, ``PascalVOCDataset`` and the VOC factory of
``build_dataset`` on synthetic VOC trees (``data/synth.py::synth_voc``:
binary PPM bytes under VOC's ``.jpg`` names, difficult objects, one image
whose every object is difficult), both loaders, the whole VOC eval path
of a narrow C4 Faster R-CNN from the dataset to the mAP, and two train
steps on the train + val ``ConcatDataset``.

The model is configs/pascal_voc/e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc.yaml
(21 classes, its RPN's 6,000 / 300 test proposals and 128-512 anchors)
at test_torch_port_c4.py's narrow body, float32, 64 x 96 inputs, with the
JAX params carried across by ``load_jax_params`` (``c4_params``), and
ROI_HEADS.SCORE_THRESH 0: the seeded classifier's scores sit near 1/21,
below the config's 0.05.

Tolerances, each with its reason:
- the AP arrays of the evaluation equal, NaNs in the same places (the
  same numpy code on the same inputs);
- records, difficult flags, decoded images and loader batches equal;
- the eval path: per image the same labels in score order, boxes within
  1e-3 px and scores within 1e-4 (as test_torch_port_c4.py's detect);
  each class's AP within 1e-6, and equal when both packages evaluate
  the same detections;
- train steps (with 32-128 anchors, which fit in the 64 x 96 images):
  as tests/test_torch_port_two_stage_train.py (losses within
  1e-4 relative in the first step, 1e-3 in the second; gradients within
  1e-3 of each tensor's largest magnitude and updated parameters within
  1e-6 in the first).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data import build as jbuild
from paa_tpu.data.concat import ConcatDataset as JConcatDataset
from paa_tpu.data import loader as jloader
from paa_tpu.data import voc as jvoc
from paa_tpu.engine import inference as jinference
from paa_tpu.evaluation import voc_eval as jvoc_eval
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data import loader, voc
from paa_tpu_torch.data.build import build_dataset
from paa_tpu_torch.data.concat import ConcatDataset
from paa_tpu_torch.data.synth import synth_voc, voc_ground_truth
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.engine.inference import compute_on_dataset, inference
from paa_tpu_torch.evaluation import voc_eval
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_c4 import NARROW, c4_params
from test_torch_port_train import _applied_gradients, _to_np
from test_torch_port_two_stage_train import (
    SEED, TRAIN, assert_gradients_and_update_match, assert_step_matches,
    later_step_tolerances, replay_draws, roi_box_loss_with_samples,
    rpn_loss_with_masks)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "pascal_voc",
                      "e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc.yaml")
SYNTH_CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools",
                             "synth_catalog.py")
HW = (64, 96)
# landscape VOC sizes: every image lands in the one 64 x 96 bucket
SIZES = ((500, 375), (500, 333), (500, 400))
EVAL = NARROW + [
    "MODEL.ROI_HEADS.SCORE_THRESH", 0.0,
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96,
    "TPU.TEST_BUCKETS", (HW,), "TPU.TRAIN_BUCKETS", (HW,),
    "TEST.IMS_PER_BATCH", 4, "SOLVER.IMS_PER_BATCH", 2, "TPU.MAX_GT", 8,
    "DATALOADER.NUM_WORKERS", 2,
]


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
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(EVAL + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


# ---- the evaluation --------------------------------------------------------

def mk(boxes, labels, scores=None, difficult=None):
    d = dict(boxes=np.asarray(boxes, np.float64).reshape(-1, 4),
             labels=np.asarray(labels, np.int64))
    if scores is not None:
        d["scores"] = np.asarray(scores, np.float64)
    d["difficult"] = (np.zeros(len(d["labels"]), bool) if difficult is None
                      else np.asarray(difficult, bool))
    return d


# tests/test_voc_eval.py's cases: (gts, preds, use_07_metric, the map or
# an AP the JAX test expects)
CASES = {
    "perfect": ([mk([[0, 0, 50, 50], [100, 100, 150, 150]], [1, 2])],
                [mk([[0, 0, 50, 50], [100, 100, 150, 150]], [1, 2],
                    [0.9, 0.8])], True, ("map", 1.0)),
    "false_positive": ([mk([[0, 0, 50, 50]], [1])],
                       [mk([[200, 200, 220, 220], [0, 0, 50, 50]], [1, 1],
                           [0.95, 0.9])], False, (1, 0.5)),
    "difficult": ([mk([[0, 0, 50, 50]], [1], difficult=[True])],
                  [mk([[0, 0, 50, 50]], [1], [0.9])], True, (1, np.nan)),
    "double_detection": ([mk([[0, 0, 50, 50]], [1])],
                         [mk([[0, 0, 50, 50], [1, 1, 51, 51]], [1, 1],
                             [0.9, 0.8])], False, (1, 1.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_detection_voc_cases_match_jax(name):
    gts, preds, use_07, (key, value) = CASES[name]
    got = voc_eval.eval_detection_voc(gts, preds, use_07_metric=use_07)
    want = jvoc_eval.eval_detection_voc(gts, preds, use_07_metric=use_07)
    np.testing.assert_array_equal(got["ap"], want["ap"])
    assert got["map"] == want["map"] or (np.isnan(got["map"])
                                         and np.isnan(want["map"]))
    np.testing.assert_allclose(got["map"] if key == "map" else
                               got["ap"][key], value)


def test_calc_voc_ap_11_point_matches_jax():
    prec = [None, np.array([1.0, 0.5])]
    rec = [None, np.array([0.5, 0.5])]
    for use_07 in (True, False):
        got = voc_eval.calc_voc_ap(prec, rec, use_07_metric=use_07)
        np.testing.assert_array_equal(
            got, jvoc_eval.calc_voc_ap(prec, rec, use_07_metric=use_07))
    np.testing.assert_allclose(
        voc_eval.calc_voc_ap(prec, rec, use_07_metric=True)[1], 6 / 11)


def _random_images(seed, n_images, n_classes=4):
    """GTs and predictions of ``n_images``: boxes near each other so that
    IoUs cross 0.5 both ways, integer and fractional coordinates, some
    GTs difficult, some classes with no GT or no prediction."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for _ in range(n_images):
        g, p = rng.randint(0, 6, 2)
        gb = rng.uniform(0, 60, (g, 2))
        gb = np.concatenate([gb, gb + rng.uniform(2, 40, (g, 2))], 1)
        src = gb[rng.randint(0, max(g, 1), p)] if g else \
            np.tile([10.0, 10.0, 30.0, 30.0], (p, 1))
        pb = src + rng.normal(0, 4, (p, 4))
        if rng.rand() < 0.5:
            pb = np.round(pb)
        gts.append(dict(boxes=gb, labels=rng.randint(1, n_classes, g),
                        difficult=rng.rand(g) < 0.25))
        preds.append(dict(boxes=pb, labels=rng.randint(1, n_classes, p),
                          scores=np.round(rng.uniform(0, 1, p), 1)))
    return gts, preds


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_images=st.integers(1, 6),
       use_07=st.booleans(), iou=st.sampled_from([0.3, 0.5, 0.7]))
def test_eval_detection_voc_sweep_matches_jax(seed, n_images, use_07, iou):
    """Random images (ties in the scores, rounded boxes, difficult GTs):
    the AP arrays equal, NaNs in the same places."""
    gts, preds = _random_images(seed, n_images)
    got = voc_eval.eval_detection_voc(gts, preds, iou, use_07)
    want = jvoc_eval.eval_detection_voc(gts, preds, iou, use_07)
    np.testing.assert_array_equal(got["ap"], want["ap"])


# ---- the dataset, the factory and the loaders ----------------------------

@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """16 images of VOC's sizes, image 1 with only difficult objects."""
    return synth_voc(str(tmp_path_factory.mktemp("voc") / "VOC2007"), 16)


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_dataset_matches_jax(voc_root, use_difficult):
    got = voc.PascalVOCDataset(voc_root, "test", use_difficult)
    want = jvoc.PascalVOCDataset(voc_root, "test", use_difficult)
    assert voc.CLASSES == jvoc.CLASSES and len(voc.CLASSES) == 21
    assert len(got) == len(want) == 16 and got.ids == want.ids
    for i, (g, w) in enumerate(zip(got.records, want.records)):
        assert (g.id, g.file_name, g.width, g.height) == \
            (w.id, w.file_name, w.width, w.height)
        for key in ("boxes", "labels"):
            a, b = getattr(g, key), getattr(w, key)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got._difficult[i], want._difficult[i])
        assert got.get_img_info(i) == want.get_img_info(i)
        # P6 bytes under a .jpg name: numpy here, cv2.imread there
        with open(got.image_path(i), "rb") as f:
            assert f.read(2) == b"P6"
        np.testing.assert_array_equal(got.load_image(i), want.load_image(i))
    assert len(got.records[1].labels) == (3 if use_difficult else 0)
    assert sum(d.sum() for d in got._difficult.values()) > \
        (3 if use_difficult else 0) - 1
    assert got.map_class_id_to_class_name(12) == "dog"


def test_build_dataset_builds_voc_through_the_catalog(tmp_path,
                                                      monkeypatch):
    """The VOC factory through the synthetic paths catalog, which serves
    the reference's ``voc_2007_*`` names: the eval dataset keeps its
    difficult objects, the training one drops them and concatenates
    train and val, as the JAX package's ``build_dataset``."""
    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path))
    jcfg, cfg = _cfgs(["PATHS_CATALOG", SYNTH_CATALOG])
    test = build_dataset(cfg, ("voc_2007_test",), is_train=False)
    jtest = jbuild.build_dataset(jcfg, ("voc_2007_test",), is_train=False)
    assert isinstance(test, voc.PascalVOCDataset) and test.keep_difficult
    assert len(test) == len(jtest) == 16
    train = build_dataset(cfg, cfg.DATASETS.TRAIN, is_train=True)
    jtrain = jbuild.build_dataset(jcfg, jcfg.DATASETS.TRAIN, is_train=True)
    assert isinstance(train, ConcatDataset)
    assert [type(d) for d in train.datasets] == [voc.PascalVOCDataset] * 2
    assert not any(d.keep_difficult for d in train.datasets)
    assert len(train) == len(jtrain) == 16
    for g, w in zip(train.records, jtrain.records):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_array_equal(g.boxes, w.boxes)
    assert len(build_dataset(cfg, ("voc_2007_val", "voc_2007_test"),
                             is_train=False)) == 2


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def landscape_root(tmp_path_factory):
    """8 landscape images (one bucket at 64 x 96), image 1 all
    difficult: the eval path's and the train steps' tree."""
    return synth_voc(str(tmp_path_factory.mktemp("voc_land") / "VOC2007"),
                     8, seed=3, sizes=SIZES)


def test_loaders_match_jax(landscape_root):
    """The eval loader over the test split (difficult objects kept, the
    tail padded) and three batches of the train stream over train + val,
    both packages' loaders on both packages' datasets."""
    jcfg, cfg = _cfgs(["SOLVER.MAX_ITER", 3])
    got = list(loader.make_data_loader(
        cfg, voc.PascalVOCDataset(landscape_root, "test", True),
        is_train=False))
    want = list(jloader.make_data_loader(
        jcfg, jvoc.PascalVOCDataset(landscape_root, "test", True),
        is_train=False))
    _assert_batches_equal(got, want)
    assert [b["images"].shape[1:3] for b in got] == [HW, HW]
    got = list(loader.make_data_loader(cfg, _train_set(landscape_root),
                                       is_train=True, seed=5))
    want = list(jloader.make_data_loader(jcfg, _train_set(landscape_root,
                                                          jvoc),
                                         is_train=True, seed=5))
    assert len(got) == 3
    _assert_batches_equal(got, want)


def _train_set(root, module=voc):
    concat = ConcatDataset if module is voc else JConcatDataset
    return concat([module.PascalVOCDataset(root, split, False)
                   for split in ("train", "val")])


def test_inference_names_the_voc_path(voc_root):
    """``inference`` evaluates COCO-format datasets, as the JAX
    package's; a VOC dataset raises, naming the path that evaluates
    it."""
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="do_voc_evaluation"):
        inference(cfg, None, voc.PascalVOCDataset(voc_root, "test", True))


# ---- the whole eval path --------------------------------------------------

def _c4_models(jcfg, cfg, hw=HW):
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), hw))["params"]
    params = c4_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return jmodel, params, model


@pytest.fixture(scope="module")
def voc_eval_case(landscape_root, tmp_path_factory):
    """Both packages from the dataset to the mAP: each package's
    dataset and loader, ``compute_on_dataset``, the boxes back to xyxy
    (``predictions_from_xywh``), ``do_voc_evaluation``; the ground truth
    the port's three best detections of each image on a first pass
    (``voc_ground_truth``), so that the mAP is far from 0."""
    import shutil

    root = str(tmp_path_factory.mktemp("voc_eval") / "VOC2007")
    shutil.copytree(landscape_root, root)
    jcfg, cfg = _cfgs()
    jmodel, params, model = _c4_models(jcfg, cfg)

    def port_pass():
        ds = voc.PascalVOCDataset(root, "test", True)
        preds, *_ = compute_on_dataset(
            model, loader.make_data_loader(cfg, ds, is_train=False))
        return ds, voc_eval.predictions_from_xywh(preds)

    ds, first = port_pass()
    voc_ground_truth(ds, first)
    ds, port = port_pass()
    jds = jvoc.PascalVOCDataset(root, "test", True)
    jpreds, *_ = jinference.compute_on_dataset(
        jmodel, {"params": params},
        jloader.make_data_loader(jcfg, jds, is_train=False))
    jax_preds = voc_eval.predictions_from_xywh(jpreds)
    return {"port": (ds, port, voc_eval.do_voc_evaluation(ds, port)),
            "jax": (jds, jax_preds,
                    jvoc_eval.do_voc_evaluation(jds, jax_preds))}


def test_voc_eval_path_detections_match_jax(voc_eval_case):
    ds, got, _ = voc_eval_case["port"]
    _, want, _ = voc_eval_case["jax"]
    assert sorted(got) == sorted(want) == list(range(len(ds)))
    for idx in got:
        g, w = got[idx], want[idx]
        assert len(g["labels"]) == len(w["labels"]) > 3
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=1e-4)


def test_voc_eval_path_map_matches_jax(voc_eval_case, tmp_path, caplog):
    """The per-class AP (VOC-07 11-point) within 1e-6 on each package's
    own detections, equal on the same detections; the table written
    and logged."""
    import logging

    ds, port, got = voc_eval_case["port"]
    jds, jax_preds, want = voc_eval_case["jax"]
    assert got["ap"].shape == (21,) and np.isnan(got["ap"][0])
    np.testing.assert_allclose(got["ap"], want["ap"], rtol=0, atol=1e-6)
    assert np.isnan(got["ap"]).sum() == np.isnan(want["ap"]).sum()
    assert 0.3 < got["map"] <= 1.0
    same = voc_eval.do_voc_evaluation(
        ds, jax_preds, str(tmp_path), logging.getLogger("voc"))
    np.testing.assert_array_equal(same["ap"], want["ap"])
    text = (tmp_path / "result.txt").read_text()
    assert text.startswith("mAP: ") and len(text.splitlines()) == 21
    assert "dog" in text


# ---- train steps on train + val -------------------------------------------

def _run_steps(jcfg, cfg, batch, hw, steps):
    """test_torch_port_two_stage_train.py's ``run_steps`` at the batch's
    bucket ``hw`` with ``c4_params``."""
    jmodel, params, model = _c4_models(jcfg, cfg, hw)
    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    step = model.make_bucket_train_step(hw, draws=replay_draws(SEED),
                                        return_aux=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_two_stage, "rpn_loss", rpn_loss_with_masks)
        mp.setattr(jax_two_stage, "roi_box_loss", roi_box_loss_with_samples)
        jstep = jax.jit(jmodel.make_bucket_train_step(
            hw, param_label_tree=labels))
        for i in range(steps):
            metrics = {k: v.numpy() for k, v in step(state, batch).items()}
            grads = {n: p.grad.clone() for n, p in
                     model.module.named_parameters() if p.requires_grad}
            jparams = jstate.params
            jstate, jmetrics = jstep(jstate, jbatch)
            out.append({
                "jax": {"metrics": jax.tree.map(np.asarray, jmetrics),
                        "params": _to_np(jstate.params)},
                "port": {"metrics": metrics, "grads": grads,
                         "params": {n: p.detach().clone() for n, p in
                                    model.module.named_parameters()}}})
            if i == 0:
                out[0]["jax"]["grads"] = _applied_gradients(
                    jstate.opt_state, jparams, labels, jcfg)
    return model, out


# the train steps take 32-128 anchors: at 64 x 96 every one of the config's
# 128-512 anchors lies outside the image, where RPN.STRADDLE_THRESH 0
# ignores it, and no anchor is positive
TRAIN_HW = HW
TRAIN_SIZE = ["MODEL.RPN.ANCHOR_SIZES", (32, 64, 128)]


@pytest.fixture(scope="module")
def voc_train_runs(landscape_root):
    """The train stream's first batch over train + val that holds the
    image without a non-difficult object (no GT at all), equal in both
    packages' loaders, then two steps of each package on it."""
    jcfg, cfg = _cfgs(TRAIN + TRAIN_SIZE + ["SOLVER.MAX_ITER", 4])
    keys = ("images", "image_sizes", "gt_boxes", "gt_labels")
    for got, want in zip(
            loader.make_data_loader(cfg, _train_set(landscape_root), True),
            jloader.make_data_loader(jcfg, _train_set(landscape_root, jvoc),
                                     True)):
        _assert_batches_equal([got], [want])
        if (got["gt_labels"] == 0).all(axis=1).any():
            break
    else:
        pytest.fail("no batch holds the image without a GT")
    batch = {k: got[k] for k in keys}
    assert batch["images"].shape[1:3] == TRAIN_HW
    return batch, *_run_steps(jcfg, cfg, batch, TRAIN_HW, 2)


def test_voc_train_steps_match_jax(voc_train_runs):
    batch, model, out = voc_train_runs
    assert (batch["gt_labels"] > 0).any(axis=1).any()
    for i, step in enumerate(out):
        assert_step_matches(step["port"], step["jax"], batch,
                            **later_step_tolerances(i))
    assert_gradients_and_update_match(model, out[0], min_tensors=50)
    losses = [float(s["port"]["metrics"]["loss"]) for s in out]
    assert all(np.isfinite(losses)) and losses[0] != losses[1]

"""The C4 two-stage models in the PyTorch port against the JAX package, on
the CPU: e2e_faster_rcnn_R_50_C4_1x and e2e_mask_rcnn_R_50_C4_1x at a
narrow body (RES2_OUT_CHANNELS 32, WIDTH_PER_GROUP 8, stem 16: C4 128
channels; the RPN's shared conv and res5's output stay at the JAX
package's fixed 1,024 and 2,048), 5 classes, C4 mask predictor 32 wide,
2 x 64 x 96 input, float32, the JAX params carried across by
``load_jax_params``: the build (one stride-16 level, 15 anchors per
location), the res5 box head with its features, the C4 mask
predictor, ``detect`` of both models whole, one and three train steps
of each, and both CLIs.

Tolerances, each with its reason:
- integer outputs equal: anchors, valid, labels, sampled anchors and
  rois, GT indices, num_pos;
- the res5 head's outputs and features and the mask predictor within
  1e-4 of each tensor's largest magnitude (convolutions in another
  summation order), its 2x2 deconv kernel asymmetric, so a kernel
  carried across unflipped shows;
- detections: boxes within 1e-3 px, scores within 1e-4, the masks of
  each detection within 1e-4 (as tests/test_torch_port_two_stage.py);
- whole steps: as tests/test_torch_port_two_stage_train.py (losses
  within 1e-4 relative in the first step, 1e-3 after, gradients within
  1e-3 of each tensor's largest magnitude, updated parameters within
  1e-6), the Mask R-CNN's 14 x 14 mask targets equal except where the
  JAX package's crop lies within 1e-3 of 0.5 (as
  tests/test_torch_port_mask.py).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_layout as rl
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import roi_box_head as jax_box_head
from paa_tpu.modeling import roi_mask_head as jax_mask_head
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.roi_box_head import Res5ROIBoxHead
from paa_tpu_torch.modeling.roi_mask_head import MaskRCNNC4Predictor
from paa_tpu_torch.tools import train_net
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_mask import (
    crop_gt_masks_raw, mask_batch, mask_loss_raw)
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (
    HW, STEPS, assert_gradients_and_update_match, assert_step_matches, cfgs,
    later_step_tolerances, roi_box_loss_with_samples, rpn_loss_with_masks,
    run_steps, two_stage_batch, two_stage_params)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "faster": os.path.join(ROOT, "configs", "e2e_faster_rcnn_R_50_C4_1x.yaml"),
    "mask": os.path.join(ROOT, "configs", "e2e_mask_rcnn_R_50_C4_1x.yaml"),
}
NARROW = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
          "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
          "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
          "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (32,)]


def c4_params(shapes, rng):
    """``two_stage_params`` with the RPN's and the box head's predictors
    at 1/100 of their init's std: the seeded body's C4 features are ~1e2
    (uint8 pixels less the mean through kaiming-scale convs) and res5
    pools 2,048 of them, so at the init's stds the RPN's deltas clip
    most proposals flat at the image's edges and the classifier's
    logits reach ~50 (a loss of ~50) in both packages."""
    params = two_stage_params(shapes, rng)
    for head, layer in (("rpn_head", "cls_logits"), ("rpn_head", "bbox_pred"),
                        ("box_head", "cls_score"), ("box_head", "bbox_pred")):
        params[head][layer]["kernel"] = params[head][layer]["kernel"] * 0.01
    return params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.fixture(scope="module", params=["faster", "mask"])
def models(request):
    """Both packages' narrow C4 model from one set of JAX params
    (``c4_params``)."""
    jcfg, cfg = cfgs(CONFIGS[request.param], NARROW)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = c4_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return request.param, jmodel, params, model


def test_c4_build_matches_jax(models):
    """One stride-16 level with every size x ratio (15 anchors per
    location), the RPN's shared conv 1,024 wide on a 128-channel C4, res5
    to 2,048; every port tensor written from the JAX tree and none at
    its init."""
    kind, jmodel, params, model = models
    assert model.strides == jmodel.strides == (16,)
    assert model.feature_shapes(HW) == jmodel.feature_shapes(HW)
    anchors, counts = model.anchors_for(HW)
    want, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want)
    assert list(counts) == list(want_counts) == [4 * 6 * 15]
    module = model.module
    assert module.rpn_head.conv.weight.shape == (1024, 128, 3, 3)
    assert module.box_head.layer4_2.conv3.weight.shape[0] == 2048
    assert module.share_mask_extractor == (kind == "mask")
    fresh = build_detection_model(model.cfg, device="cpu", seed=2)
    init = {k: v.clone() for k, v in fresh.module.state_dict().items()}
    load_jax_params(fresh.module, _seeded_params(
        params, np.random.RandomState(6)))
    state = fresh.module.state_dict()
    assert [k for k, v in state.items() if torch.equal(v, init[k])] == []
    if kind == "mask":
        assert {k.split(".")[1] for k in state if k.startswith("mask_head")} \
            == {"conv5_mask", "mask_fcn_logits"}


def _rois(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, 80, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.5, 60, (n, 2)).astype(np.float32)
    return (np.concatenate([xy, xy + wh], 1),
            rng.randint(0, 2, n).astype(np.int32))


def test_res5_box_head_and_its_features_match_jax():
    rng = np.random.RandomState(3)
    feat = rng.normal(size=(2, 6, 8, 32)).astype(np.float32)
    rois, bidx = _rois(4, 12)
    jhead = jax_box_head.Res5ROIBoxHead(num_classes=5, width_per_group=4)
    args = ([jnp.asarray(feat)], jnp.asarray(rois), jnp.asarray(bidx))
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), *args))["params"]
    params = _seeded_params(shapes, rng)
    want = jhead.apply({"params": params}, *args, return_features=True)
    head = Res5ROIBoxHead(5, in_channels=32, width_per_group=4)
    load_jax_params(head, params)
    with torch.no_grad():
        got = head([_t(feat).permute(0, 3, 1, 2)], _t(rois), _t(bidx).long(),
                   return_features=True)
        plain = head([_t(feat).permute(0, 3, 1, 2)], _t(rois),
                     _t(bidx).long())
    assert got[2].shape == (12, 2048, 7, 7) and len(plain) == 2
    _close(got[0].numpy(), want[0], 1e-4)
    _close(got[1].numpy(), want[1], 1e-4)
    _close(got[2].permute(0, 2, 3, 1).numpy(), want[2], 1e-4)
    for p, g in zip(plain, got):
        assert torch.equal(p, g)


def test_mask_c4_predictor_matches_jax():
    rng = np.random.RandomState(5)
    res5 = rng.normal(size=(6, 7, 7, 64)).astype(np.float32)
    jhead = jax_mask_head.MaskRCNNC4Predictor(num_classes=4, dim_reduced=16)
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), jnp.asarray(res5)))["params"]
    params = _seeded_params(shapes, rng)
    kernel = params["conv5_mask"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(res5)))
    head = MaskRCNNC4Predictor(4, in_channels=64, dim_reduced=16)
    load_jax_params(head, params)
    with torch.no_grad():
        got = head(_t(res5).permute(0, 3, 1, 2))
    assert got.shape == (6, 4, 14, 14) and want.shape == (6, 14, 14, 4)
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


def test_c4_detect_matches_jax(models):
    kind, jmodel, params, model = models
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = jmodel.make_eval_fn({"params": params})(jnp.asarray(images),
                                                   jnp.asarray(sizes))
    got = model.make_eval_fn()(torch.from_numpy(images),
                               torch.from_numpy(sizes))
    assert got["boxes"].shape == (2, 10, 4)
    assert int(got["valid"].sum()) > 5
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)
    assert ("masks" in got) == (kind == "mask")
    if kind == "mask":
        assert got["masks"].shape == (2, 10, 14, 14)
        np.testing.assert_allclose(got["masks"].numpy(),
                                   np.asarray(want["masks"]), rtol=0,
                                   atol=1e-4)


# ---- whole train steps -------------------------------------------------------

@pytest.fixture(scope="module")
def faster_runs():
    jcfg, cfg = cfgs(CONFIGS["faster"], NARROW)
    batch = two_stage_batch(2)
    return batch, *run_steps(jcfg, cfg, batch, STEPS, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples)),
        seeded=c4_params)


def test_first_c4_step_matches_jax(faster_runs):
    batch, model, out = faster_runs
    assert_step_matches(out[0]["port"], out[0]["jax"], batch)
    # a C4 model trains 52 tensors (no FPN; the stem and res2 frozen)
    assert_gradients_and_update_match(model, out[0], min_tensors=50)
    assert model.module.rpn_head.conv.weight.grad.abs().sum() > 0


def test_three_c4_steps_match_jax(faster_runs):
    batch, _, out = faster_runs
    for i, step in enumerate(out):
        assert_step_matches(step["port"], step["jax"], batch,
                            **later_step_tolerances(i))
    losses = [float(s["port"]["metrics"]["loss"]) for s in out]
    assert len(set(losses)) == STEPS and all(np.isfinite(losses))


@pytest.fixture(scope="module")
def mask_runs():
    jcfg, cfg = cfgs(CONFIGS["mask"], NARROW)
    batch = mask_batch(2)
    return batch, *run_steps(jcfg, cfg, batch, STEPS, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples),
        (jax_mask_head, "crop_gt_masks_for_rois", crop_gt_masks_raw),
        (jax_mask_head, "mask_loss", mask_loss_raw)), seeded=c4_params)


def _assert_mask_targets(step):
    got, want = step["port"]["metrics"], step["jax"]["metrics"]
    raw = want["mask_raw"]
    assert raw.shape[-1] == 14
    targets = got["mask_targets"].reshape(raw.shape)
    near = np.abs(raw - 0.5) <= 1e-3
    np.testing.assert_array_equal(targets[~near],
                                  want["mask_targets"][~near])


def test_first_c4_mask_step_matches_jax(mask_runs):
    """The mask branch shares the box head's res5: one res5 per step in
    the port, the box head run again for the mask in the JAX package;
    the same gradient."""
    batch, model, out = mask_runs
    assert_step_matches(out[0]["port"], out[0]["jax"], batch,
                        losses=("loss_mask", "loss"))
    assert_step_matches(out[0]["port"], out[0]["jax"], batch)
    _assert_mask_targets(out[0])
    assert_gradients_and_update_match(model, out[0], min_tensors=50)
    assert model.module.mask_head.conv5_mask.weight.grad.abs().sum() > 0


def test_three_c4_mask_steps_match_jax(mask_runs):
    batch, _, out = mask_runs
    for i, step in enumerate(out):
        assert_step_matches(step["port"], step["jax"], batch,
                            losses=("loss_mask", "loss"),
                            **later_step_tolerances(i))
        _assert_mask_targets(step)
    assert len({float(s["port"]["metrics"]["loss_mask"]) for s in out}) == \
        STEPS


# ---- the CLIs ----------------------------------------------------------------

CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools", "synth_catalog.py")
# res2 256 wide: res5 then ends at 2,048 in the pickle's body too (the
# JAX package's C4 head, and so the port's, always ends there)
WIDE_RES2 = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 256]
CLI = NARROW + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 300, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 60,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 300, "MODEL.RPN.POST_NMS_TOP_N_TEST", 30,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, "SOLVER.BASE_LR", 0.001,
    "INPUT.MIN_SIZE_TRAIN", (96,), "INPUT.MAX_SIZE_TRAIN", 128,
    "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 128,
    "TPU.TRAIN_BUCKETS", ((128, 128),), "TPU.TEST_BUCKETS", ((128, 128),),
    "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 4, "TPU.MAX_GT", 20,
    "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
    "PATHS_CATALOG", CATALOG, "DATASETS.TRAIN", ("synth_coco_4",),
    "DATASETS.TEST", ("synth_coco_4",)]
METRICS = sorted(["AP", "AP50", "AP75", "APs", "APm", "APl", "AR1", "AR10",
                  "AR100", "ARs", "ARm", "ARl"])


def _opts(*pairs):
    return [str(v) for v in pairs]


def _body_blobs(extra):
    """A seeded Detectron R-50 ImageNet pickle's blobs at the narrow
    bottlenecks (and ``extra`` widths)."""
    from paa_tpu_torch.config import get_cfg

    fpn = get_cfg()
    fpn.merge_from_file(os.path.join(ROOT, "configs", "paa",
                                     "paa_R_50_FPN_1x.yaml"))
    fpn.merge_from_list(NARROW[:6] + extra)
    body = {k: v for k, v in rl.seeded_state_dict(rl.layout(fpn), 11).items()
            if k.startswith("backbone.body.")}
    return rl.c2_imagenet_blobs(body, seed=12)


def test_c2_pickle_res5_lands_in_the_c4_box_head(tmp_path):
    """A C4 model takes an ImageNet pickle's res5 blobs into its box head
    (res2 256 wide, where res5 ends at 2,048 in the body too); everything
    but the classifier is matched and every box-head tensor but the
    folded running statistics written."""
    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.utils.torch_import import load_c2_pickle

    blobs = _body_blobs(WIDE_RES2)
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    cfg = get_cfg()
    cfg.merge_from_file(CONFIGS["faster"])
    cfg.merge_from_list(NARROW + WIDE_RES2)
    model = build_detection_model(cfg, device="cpu")
    skipped, unwritten = load_c2_pickle(model.module, tmp_path / "R-50.pkl")
    assert skipped == ["pred_w", "pred_b"]
    head = model.module.box_head
    for blob, tensor in (("res5_0_branch2a_w", head.layer4_0.conv1.weight),
                         ("res5_0_branch1_w", head.layer4_0.downsample_conv
                          .weight),
                         ("res5_2_branch2c_bn_s", head.layer4_2.bn3.weight),
                         ("res4_5_branch2b_w",
                          model.module.backbone.body.layer3_5.conv2.weight)):
        np.testing.assert_array_equal(tensor.detach().numpy(), blobs[blob])
    assert not any(k.startswith(("box_head.layer4_", "backbone.body."))
                   and "running" not in k for k in unwritten)


@pytest.mark.parametrize("kind", ["faster", "mask"])
def test_train_net_c4_from_its_pickle_then_test(
        tmp_path, monkeypatch, kind):
    """Two iterations of each C4 config from its catalog R-50 pickle (a
    seeded Detectron body at the narrow shapes, whose res5, 256 wide,
    does not fit the C4 head's fixed 2,048 and is skipped, as in the JAX
    package): the frozen stem in the checkpoint equals the pickle's;
    then the test pass's AP tables (bbox, and segm for Mask R-CNN)."""
    from paa_tpu_torch.config.paths_catalog import ModelCatalog

    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    blobs = _body_blobs([])
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    out = tmp_path / "out"
    seen = {}
    rc = train_net.main(
        ["--config-file", CONFIGS[kind], "--device", "cpu",
         *_opts(*CLI, "SOLVER.MAX_ITER", 2, "OUTPUT_DIR", out)],
        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0 and sorted(seen) == [1, 2]
    for m in seen.values():
        assert np.isfinite(list(m.values())).all()
        assert {"loss_objectness", "loss_classifier"} <= set(m)
        assert ("loss_mask" in m) == (kind == "mask")
    ckpt = torch.load(out / "model_final", weights_only=True)["model"]
    np.testing.assert_array_equal(
        ckpt["backbone.body.stem.conv1.weight"].numpy(), blobs["conv1_w"])
    assert "box_head.layer4_0.downsample_conv.weight" in ckpt
    with open(out / "inference" / "synth_coco_4" / "coco_results.json") as f:
        results = json.load(f)
    assert sorted(k for k in results if "/" not in k) == METRICS
    assert len(results) == (24 if kind == "mask" else 12)


@pytest.mark.parametrize("kind", ["faster", "mask"])
def test_test_net_c4_prints_its_tables(tmp_path, kind):
    """``python -m paa_tpu_torch.tools.test_net`` on each C4 config from
    the seeded weights: the bbox table, and for Mask R-CNN the segm."""
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--config-file", CONFIGS[kind], "--device", "cpu",
         *_opts(*CLI, "OUTPUT_DIR", out,
                # the seeded classifier's scores sit near 1/81: keep them
                "MODEL.ROI_HEADS.SCORE_THRESH", 0.0)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path / "synth")})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    text = proc.stdout + proc.stderr
    assert "Task: bbox" in text
    assert ("Task: segm" in text) == (kind == "mask")
    with open(out / "inference" / "synth_coco_4" / "coco_results.json") as f:
        results = json.load(f)
    assert sorted(k for k in results if "/" not in k) == METRICS
    assert sorted(k[5:] for k in results if k.startswith("segm/")) == (
        METRICS if kind == "mask" else [])

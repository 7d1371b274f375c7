"""The RPN-only model of the PyTorch port (configs/rpn_R_50_FPN_1x.yaml and
configs/rpn_R_50_C4_1x.yaml) against the JAX package, on the CPU: the
build, the proposals it serves, its train step, the box-proposal
average recall (``evaluate_box_proposals``, the box_proposal table) and
``inference`` over a synthetic COCO. The FPN model is narrow as
tests/test_torch_port_two_stage.py's (64 FPN channels), the C4 model as
tests/test_torch_port_c4.py's (C4 128 channels, the RPN conv at the JAX
package's fixed 1,024), 2 x 64 x 96 input, float32, the JAX params
carried across by ``load_jax_params``.

Tolerances, each with its reason:
- integer outputs equal: anchors, each proposal's validity and its
  place in the pick order, the sampled anchors, num_pos;
- proposals within 1e-3 px plus 5e-5 of their coordinate (the RPN's
  outputs agree within 1e-4 of their largest magnitude, convolutions in
  another summation order, and the decode's exp scales a delta's
  difference by the anchor's size: 1.2e-3 px at 52 px seen) and their
  objectness within 1e-4 of the largest magnitude;
- the train step as tests/test_torch_port_two_stage_train.py's first:
  losses within 1e-4 relative, the applied gradients within 1e-3 of
  each tensor's largest magnitude, the updated parameters within 1e-6;
- average recall: ``evaluate_box_proposals`` on the same proposals
  equal to the JAX package's (the same float64 numpy); the table
  through ``inference`` within 1e-6 (proposals within 1e-3 px may move
  an IoU across a threshold only by that much, and none does here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine.inference import inference as jax_inference
from paa_tpu.evaluation.coco_eval import (
    evaluate_box_proposals as jax_evaluate_box_proposals)
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.evaluation.coco_eval import (
    PROPOSAL_AREAS, box_proposal_table, evaluate_box_proposals)
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.two_stage import RPNOnlyModel
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_c4 import NARROW as C4_NARROW
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (
    HW, assert_gradients_and_update_match, cfgs, rpn_loss_with_masks,
    run_steps, two_stage_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "fpn": (os.path.join(ROOT, "configs", "rpn_R_50_FPN_1x.yaml"), []),
    "c4": (os.path.join(ROOT, "configs", "rpn_R_50_C4_1x.yaml"),
           C4_NARROW[:6]),
}
# the objectness and deltas kernels' std: the init's 0.01 on the FPN
# levels; on the C4 map (~1e2 features of the seeded body) 1e-4, as
# tests/test_torch_port_c4.py seeds its RPN
HEAD_STD = {"fpn": 0.01, "c4": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rpn_params(kind):
    """``_seeded_params`` with the RPN head at its init's scale (its
    shared conv normal(0.01), the predictors HEAD_STD, biases 0)."""
    def seeded(shapes, rng):
        params = _seeded_params(shapes, rng)
        for layer, std in (("conv", 0.01), ("cls_logits", HEAD_STD[kind]),
                           ("bbox_pred", HEAD_STD[kind])):
            leaves = params["rpn_head"][layer]
            leaves["kernel"] = rng.normal(0, std, leaves["kernel"].shape
                                          ).astype(np.float32)
            leaves["bias"] = np.zeros_like(leaves["bias"])
        return params
    return seeded


@pytest.fixture(scope="module", params=["fpn", "c4"])
def models(request):
    kind = request.param
    path, extra = CONFIGS[kind]
    jcfg, cfg = cfgs(path, extra)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = rpn_params(kind)(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return kind, jmodel, params, model


def test_rpn_only_build_matches_jax(models):
    kind, jmodel, _, model = models
    assert isinstance(model, RPNOnlyModel) and model.head_type == "rpn"
    assert model.strides == tuple(jmodel.strides)
    anchors, counts = model.anchors_for(HW)
    janchors, jcounts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(janchors))
    assert tuple(counts) == tuple(jcounts)
    m = model.module
    assert m.rpn_head.conv.weight.shape[0] == (1024 if kind == "c4" else 64)
    assert len(counts) == (1 if kind == "c4" else 5)
    assert not hasattr(m, "box_head")


def test_rpn_only_proposals_match_jax(models):
    kind, jmodel, params, model = models
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = jmodel.make_eval_fn({"params": params})(jnp.asarray(images),
                                                   jnp.asarray(sizes))
    got = model.make_eval_fn()(torch.from_numpy(images),
                               torch.from_numpy(sizes))
    k = model.cfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST
    assert got["boxes"].shape[0] == 2 and got["boxes"].shape[1] <= k
    assert int(got["valid"].sum()) > 10
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  got["valid"].numpy().astype(np.int32))
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=5e-5,
                               atol=1e-3)
    scores = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"].numpy(), scores, rtol=0,
                               atol=1e-4 * np.abs(scores).max())
    # pick order: descending objectness among the valid slots
    for s, v in zip(got["scores"].numpy(), got["valid"].numpy()):
        assert (np.diff(s[v]) <= 0).all()


@pytest.mark.parametrize("kind", ["fpn", "c4"])
def test_rpn_only_train_step_matches_jax(kind):
    path, extra = CONFIGS[kind]
    jcfg, cfg = cfgs(path, extra)
    batch = two_stage_batch(2)
    model, out = run_steps(jcfg, cfg, batch, 1, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),),
        seeded=rpn_params(kind))
    got, want = out[0]["port"]["metrics"], out[0]["jax"]["metrics"]
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("rpn_pos", "rpn_neg"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(k for k in got if k.startswith("loss")) == {
        "loss", "loss_objectness", "loss_rpn_box_reg"}
    for k in ("loss_objectness", "loss_rpn_box_reg", "loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert_gradients_and_update_match(
        model, out[0], min_tensors=30 if kind == "c4" else 60)


# ---- box-proposal average recall --------------------------------------------

def _proposal_case(seed=5, n_images=4):
    """GT annotations of every area range (crowds among them) and, per
    image, 1,200 proposals in pick order (some near the GTs), so that
    the limits 100 and 1,000 differ."""
    rng = np.random.RandomState(seed)
    gt, props = {}, {}
    for img in range(1, n_images + 1):
        anns = []
        for j in range(rng.randint(3, 9)):
            w, h = rng.choice([12.0, 40.0, 150.0]) * rng.uniform(0.7, 1.4, 2)
            x, y = rng.uniform(0, 300, 2)
            anns.append({"bbox": [x, y, w, h], "area": w * h * 0.8,
                         "iscrowd": int(j == 0 and img == 2)})
        gt[img] = anns
        boxes = rng.uniform(0, 350, (1200, 2))
        boxes = np.concatenate(
            [boxes, boxes + rng.uniform(5, 160, (1200, 2))], axis=1)
        near = rng.choice(1200, 200, replace=False)
        for i, a in zip(near, np.resize(np.arange(len(anns)), 200)):
            x, y, w, h = anns[a]["bbox"]
            boxes[i] = [x, y, x + w - 1, y + h - 1] + rng.normal(0, 3, 4)
        props[img] = {"boxes": boxes}
    props[3] = {"boxes": np.zeros((0, 4))}  # an image without proposals
    return props, gt, list(range(1, n_images + 2))


@pytest.mark.parametrize("area", sorted(PROPOSAL_AREAS))
@pytest.mark.parametrize("limit", [100, 1000])
def test_evaluate_box_proposals_matches_jax(area, limit):
    props, gt, ids = _proposal_case()
    got = evaluate_box_proposals(props, gt, ids, area=area, limit=limit)
    want = jax_evaluate_box_proposals(props, gt, ids, area=area,
                                      limit=limit)
    assert got["num_pos"] == want["num_pos"] > 0
    np.testing.assert_array_equal(got["recalls"], want["recalls"])
    assert got["ar"] == want["ar"]
    if area == "all":
        assert 0 < got["ar"] < 1


def test_box_proposal_table_keys_and_limits():
    props, gt, ids = _proposal_case()
    table = box_proposal_table(props, gt, ids)
    assert list(table) == [f"AR{s}@{n}" for n in (100, 1000)
                           for s in ("", "s", "m", "l")]
    assert table["AR@1000"] >= table["AR@100"]


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """The narrow FPN RPN-only model over a 5-image synthetic COCO (3
    batches of 2, the last padded), in both packages."""
    root = str(tmp_path_factory.mktemp("port_rpn_eval"))
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=((96, 64), (64, 96)))
    path, _ = CONFIGS["fpn"]
    jcfg, cfg = cfgs(path, [
        "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
        "TPU.TEST_BUCKETS", ((96, 96),), "TEST.IMS_PER_BATCH", 2,
        "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2,
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 200])
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), (96, 96)))["params"]
    params = rpn_params("fpn")(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    want = jax_inference(jcfg, jmodel, {"params": params},
                         JCOCODataset(ann_file, img_dir, False))
    out = os.path.join(root, "out")
    got = inference(cfg, model, COCODataset(ann_file, img_dir, False),
                    output_folder=out)
    return got, want, out


def test_inference_box_proposal_table_matches_jax(eval_case):
    got, want, out = eval_case
    assert list(got) == list(want) and len(got) == 8
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])
    assert got["AR@1000"] > 0
    with open(os.path.join(out, "box_proposals.json")) as f:
        assert json.load(f) == got

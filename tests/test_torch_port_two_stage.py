"""The Faster R-CNN R-50-FPN inference slice of the PyTorch port against
the JAX package, at a narrow config (BACKBONE_OUT_CHANNELS=64,
NUM_CLASSES=5, MLP_HEAD_DIM=64, RPN test top-n 50/20/40,
DETECTIONS_PER_IMG=10), float32, input 2x64x96, with the JAX params
carried across by ``load_jax_params``. The JAX side runs on the CPU,
where its NMS is the scan that tests/test_nms_pallas.py pins to the
Pallas kernel K2 in interpret mode.

Tolerances, each with its reason:
- FPN features and RPN outputs within 1e-4 of each tensor's largest
  magnitude (convolutions sum in different orders; as in
  tests/test_torch_port_model.py);
- ROIAlign within 1e-5 absolute (the same bilinear terms; the 2x2 mean
  may sum in another order);
- proposals from the same RPN outputs: order and valid equal, boxes
  within 1e-3 px (exp and the decode's products round differently);
- box-head outputs within 1e-4 of the largest magnitude (float32
  matmuls of length 3136 in different orders);
- post-processing from the same inputs: valid and labels equal, boxes
  within 1e-3 px, scores within 1e-4 (softmax);
- the whole slice: valid and labels equal, boxes within 1e-3 px and
  scores within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.roi_box_head import ROIBoxConfig as JROIBoxConfig
from paa_tpu.modeling.roi_box_head import (
    roi_box_postprocess as jax_postprocess,
    roi_box_postprocess_batched as jax_postprocess_batched,
)
from paa_tpu.modeling.rpn import RPNConfig as JRPNConfig
from paa_tpu.modeling.rpn import select_proposals as jax_select
from paa_tpu.modeling.two_stage import FasterRCNN as JFasterRCNN
from paa_tpu.ops import roi_align as jax_roi
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.roi_box_head import (
    ROIBoxConfig,
    roi_box_postprocess,
    roi_box_postprocess_batched,
)
from paa_tpu_torch.modeling.rpn import RPNConfig, select_proposals
from paa_tpu_torch.modeling.two_stage import TwoStageModel
from paa_tpu_torch.ops import roi_align as port_roi
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import _seeded_params

HW = (64, 96)
CONFIG = "configs/e2e_faster_rcnn_R_50_FPN_1x.yaml"
OVERRIDES = [
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 5,
    "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 50,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 20,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 40,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 10,
]


def _cfg(get, extra=()):
    cfg = get()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build(_cfg(jax_get_cfg))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    model = build_detection_model(_cfg(get_cfg), device="cpu")
    load_jax_params(model.module, params)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    return jmodel, {"params": params}, model, images, sizes


@pytest.fixture(scope="module")
def jax_stages(models):
    """The JAX package's features, RPN outputs, proposals and box-head
    outputs for the narrow input, as numpy."""
    jmodel, variables, model, images, sizes = models
    x = images.astype(np.float32) - np.asarray(model.cfg.INPUT.PIXEL_MEAN,
                                                np.float32)
    feats, rpn = jax.jit(lambda v, xx: jmodel.module.apply(
        v, xx, method=JFasterRCNN.backbone_rpn))(variables, x)
    anchors, counts = jmodel.anchors_for(HW)
    props, _, pvalid = jax_select(
        rpn, jnp.asarray(sizes), jnp.asarray(anchors), counts,
        JRPNConfig.from_cfg(jmodel.cfg))
    bsz, k = props.shape[:2]
    bidx = jnp.repeat(jnp.arange(bsz, dtype=jnp.int32), k)
    cls, deltas = jax.jit(lambda v, f, r, b: jmodel.module.apply(
        v, f, r, b, method=JFasterRCNN.box))(
        variables, feats, props.reshape(-1, 4), bidx)
    as_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"x": x, "features": as_np(feats), "rpn": as_np(rpn),
            "proposals": np.asarray(props), "p_valid": np.asarray(pvalid),
            "cls": np.asarray(cls), "deltas": np.asarray(deltas)}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.array(a))


def test_build_is_two_stage_with_rpn_anchors(models):
    jmodel, _, model, _, _ = models
    assert isinstance(model, TwoStageModel)
    assert model.feature_shapes(HW) == jmodel.feature_shapes(HW)
    anchors, counts = model.anchors_for(HW)
    want, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want)
    assert list(counts) == list(want_counts)


def test_backbone_and_rpn_head_match_jax(models, jax_stages):
    _, _, model, _, _ = models
    with torch.no_grad():
        xt = _t(jax_stages["x"]).permute(0, 3, 1, 2).contiguous()
        feats, rpn = model.module.backbone_rpn(xt)
    want_f = jax_stages["features"]
    assert len(feats) == len(want_f) == 5  # P2..P5 and the pooled P6
    for g, w in zip(feats, want_f):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    for key in ("objectness", "box_regression"):
        _close(rpn[key].numpy(), jax_stages["rpn"][key], 1e-4)


def _rpn_outputs(jax_stages, ties):
    rpn = {k: v.copy() for k, v in jax_stages["rpn"].items()}
    if ties:  # a coarse grid, as bf16 logits tie: top-k order by index
        rpn["objectness"] = np.round(rpn["objectness"] * 4) / 4
    return rpn


@pytest.mark.parametrize("ties", [False, True])
def test_select_proposals_matches_jax(models, jax_stages, ties):
    jmodel, _, model, _, sizes = models
    rpn = _rpn_outputs(jax_stages, ties)
    anchors, counts = jmodel.anchors_for(HW)
    want = jax_select({k: jnp.asarray(v) for k, v in rpn.items()},
                      jnp.asarray(sizes), jnp.asarray(anchors), counts,
                      JRPNConfig.from_cfg(jmodel.cfg))
    got = select_proposals({k: _t(v) for k, v in rpn.items()}, _t(sizes),
                           _t(anchors), counts, RPNConfig.from_cfg(model.cfg))
    assert got[0].shape == (2, 40, 4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2].sum()) > 20
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)


def _roi_case(seed, n, hw_img):
    """Rois over an image of hw_img: ordinary ones, tiny ones (below a
    pixel), and ones crossing every edge of the image."""
    rng = np.random.RandomState(seed)
    h, w = hw_img
    xy = rng.uniform(-0.3 * w, w, (n, 2)) * np.asarray([1, h / w])
    wh = rng.uniform(0.2, 1.2 * w, (n, 2))
    rois = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    rois[: n // 4, 2:] = rois[: n // 4, :2] + rng.uniform(0, 0.8,
                                                            (n // 4, 2))
    rois[n // 4: n // 2, 2] = w + rng.uniform(0, 40, n // 4)
    return rois, rng.randint(0, 2, n).astype(np.int32)


def test_roi_align_single_level_matches_jax():
    rng = np.random.RandomState(3)
    feat = rng.normal(size=(2, 9, 13, 6)).astype(np.float32)
    rois, bidx = _roi_case(4, 40, (36, 52))
    want = jax_roi.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                             jnp.asarray(bidx), (7, 7), 0.25, 2)
    got = port_roi.roi_align(_t(feat).permute(0, 3, 1, 2), _t(rois),
                             _t(bidx), (7, 7), 0.25, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_roi_align_of_nan_and_infinite_rois_matches_jax():
    """A NaN roi (a diverged RPN's proposal) pools NaN bins and an
    infinite one zeros, as XLA's clamped gather gives the JAX package;
    the other rois are untouched. A NaN index must not reach the gather
    (on the card: a device-side assert that ends the process)."""
    rng = np.random.RandomState(5)
    feat = rng.normal(size=(2, 6, 8, 4)).astype(np.float32)
    nan, inf = np.nan, np.inf
    rois = np.asarray([[1, 1, 5, 4], [nan, 1, 5, 4], [inf, 1, 5, 4],
                       [1, -inf, 5, nan], [0, 0, 7, 5]], np.float32)
    bidx = np.asarray([0, 1, 0, 1, 1], np.int32)
    want = np.asarray(jax_roi.roi_align(
        jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(bidx), (2, 2),
        1.0, 2))
    got = port_roi.roi_align(_t(feat).permute(0, 3, 1, 2), _t(rois),
                             _t(bidx), (2, 2), 1.0, 2).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[[1, 3]]).all() and not np.isnan(got[[0, 2, 4]]).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_multilevel_roi_align_matches_jax(dtype):
    """Every level gets rois (the sizes span 1/4 to 1/32), and bfloat16
    maps give float32 pooled features on both sides."""
    rng = np.random.RandomState(5)
    hws = [(64, 96), (32, 48), (16, 24), (8, 12)]
    feats = [rng.normal(size=(2, h, w, 8)).astype(np.float32)
             for h, w in hws]
    rois, bidx = _roi_case(6, 64, (256, 384))
    rois[48:56] = [0, 0, 255, 383]  # sqrt-area 313: P4
    rois[56:] = [-50, -50, 500, 600]  # 599, past the image: P5
    jfeats = [jnp.asarray(f, jnp.bfloat16 if dtype == "bfloat16"
                          else jnp.float32) for f in feats]
    want = np.asarray(jax_roi.multilevel_roi_align(
        jfeats, jnp.asarray(rois), jnp.asarray(bidx)))
    levels = port_roi.fpn_level_for_rois(_t(rois)).numpy()
    np.testing.assert_array_equal(levels, np.asarray(
        jax_roi.fpn_level_for_rois(jnp.asarray(rois))))
    assert set(levels) == {0, 1, 2, 3}
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = port_roi.multilevel_roi_align(
        [_t(f).to(tdtype).permute(0, 3, 1, 2) for f in feats], _t(rois),
        _t(bidx))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_box_head_matches_jax(models, jax_stages):
    _, _, model, _, _ = models
    props = jax_stages["proposals"]
    bsz, k = props.shape[:2]
    with torch.no_grad():
        feats = [_t(f).permute(0, 3, 1, 2) for f in jax_stages["features"]]
        cls, deltas = model.module.box(
            feats, _t(props.reshape(-1, 4)),
            torch.arange(bsz).repeat_interleave(k))
    _close(cls.numpy(), jax_stages["cls"], 1e-4)
    _close(deltas.numpy(), jax_stages["deltas"], 1e-4)


def _assert_detections(got, want):
    for key in ("valid", "labels"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("batched", [True, False])
def test_roi_box_postprocess_matches_jax(models, jax_stages, batched):
    """Same head outputs and proposals into both packages; some rois
    invalid and some scores under the threshold."""
    _, _, _, _, sizes = models
    props = jax_stages["proposals"]
    bsz, k = props.shape[:2]
    c = jax_stages["cls"].shape[-1]
    cls = jax_stages["cls"].reshape(bsz, k, c).copy()
    cls[:, ::3, 1:] -= 4.0  # background wins: scores under 0.05
    deltas = jax_stages["deltas"].reshape(bsz, k, c, 4)
    p_valid = jax_stages["p_valid"].copy()
    p_valid[:, -5:] = False
    jbc = JROIBoxConfig(num_classes=c, detections_per_img=10)
    bc = ROIBoxConfig(num_classes=c, detections_per_img=10)
    args = (cls, deltas, props, p_valid, sizes)
    if batched:
        want = jax_postprocess_batched(*map(jnp.asarray, args), jbc)
        got = roi_box_postprocess_batched(*map(_t, args), bc)
        assert got["boxes"].shape == (2, 10, 4)
        _assert_detections(got, want)
        return
    for i in range(bsz):
        one = [a[i] for a in args]
        want = jax_postprocess(*map(jnp.asarray, one), jbc)
        got = roi_box_postprocess(*map(_t, one), bc)
        assert int(got["valid"].sum()) > 0
        _assert_detections(got, want)


def test_eval_fn_matches_jax(models):
    jmodel, variables, model, images, sizes = models
    want = jmodel.make_eval_fn(variables)(jnp.asarray(images),
                                          jnp.asarray(sizes))
    # a model built from another seed, handed the carried-across state
    other = build_detection_model(model.cfg, device="cpu", seed=1)
    got = other.make_eval_fn(model.module.state_dict())(
        torch.from_numpy(images), torch.from_numpy(sizes))
    assert got["boxes"].shape == (2, 10, 4)
    assert int(got["valid"].sum()) > 0
    _assert_detections(got, want)


def test_seeded_build_inits_the_box_head_like_jax():
    """Kaiming-uniform fc6/fc7, normal(0.01) cls_score, normal(0.001)
    bbox_pred, zero biases; seeds give reproducible weights."""
    cfg = _cfg(get_cfg)
    a = build_detection_model(cfg, device="cpu", seed=3).module.box_head
    b = build_detection_model(cfg, device="cpu", seed=3).module.box_head
    a.requires_grad_(False)
    assert torch.equal(a.fc6.weight, b.fc6.weight)
    bound = np.sqrt(3.0 / a.fc6.weight.shape[1])
    assert float(a.fc6.weight.abs().max()) <= bound
    assert float(a.fc6.weight.abs().max()) > 0.9 * bound
    assert abs(float(a.cls_score.weight.std()) - 0.01) < 0.002
    assert abs(float(a.bbox_pred.weight.std()) - 0.001) < 0.0002
    for lin in (a.fc6, a.fc7, a.cls_score, a.bbox_pred):
        assert not lin.bias.any()


@pytest.mark.parametrize("extra", [
    # Mask R-CNN and Keypoint R-CNN build on an FPN body, Faster and Mask
    # R-CNN on a C4 or FBNet one (tests/test_torch_port_mask.py,
    # tests/test_torch_port_keypoint.py, tests/test_torch_port_c4.py,
    # tests/test_torch_port_fbnet.py), the Xconv and GN heads and the C4
    # unshared mask head (tests/test_torch_port_gn.py) and the RPN-only
    # model (tests/test_torch_port_rpn_only.py); Keypoint R-CNN on a C4 or
    # FBNet body does not build, in neither package
    ["MODEL.KEYPOINT_ON", True, "MODEL.BACKBONE.CONV_BODY", "R-50-C4"],
    ["MODEL.KEYPOINT_ON", True, "MODEL.BACKBONE.CONV_BODY", "FBNet",
     "MODEL.RPN.ANCHOR_STRIDE", (16,)],
])
def test_unported_two_stage_configs_raise(extra):
    with pytest.raises(NotImplementedError):
        build_detection_model(_cfg(get_cfg, extra), device="cpu")


def test_fbnet_body_builds_at_its_stride():
    """CONV_BODY FBNet builds the single-level model (its trunk's stride,
    16, one RPN level of 15 anchors); at another RPN.ANCHOR_STRIDE it
    raises, as the JAX package asserts."""
    model = build_detection_model(_cfg(get_cfg, [
        "MODEL.BACKBONE.CONV_BODY", "FBNet",
        "MODEL.RPN.ANCHOR_STRIDE", (16,)]), device="cpu")
    assert model.strides == (16,)
    assert model.module.rpn_head.cls_logits.weight.shape[0] == 15
    with pytest.raises(ValueError, match="stride"):
        build_detection_model(_cfg(get_cfg, [
            "MODEL.BACKBONE.CONV_BODY", "FBNet",
            "MODEL.RPN.ANCHOR_STRIDE", (8,)]), device="cpu")


def test_default_device_is_the_card():
    cfg = _cfg(get_cfg)
    if torch.cuda.is_available():
        assert build_detection_model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_detection_model(cfg)

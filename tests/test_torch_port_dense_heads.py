"""The ATSS, FCOS and RetinaNet heads of the PyTorch port, and PAA without
its IoU branch, against the JAX package on the CPU in float32.

- Heads alone, narrow (2 convs, 32 channels, 2 levels), on seeded
  features, with the JAX params (filled from a numpy seed) carried
  across by ``load_jax_params``: ATSS with 'BOX' and 'POINT' regression,
  without its branch and with the DCN tower; FCOS with and without
  NORM_REG_TARGETS and CENTERNESS_ON_REG; RetinaNet; PAA with
  USE_IOU_PRED off. Outputs within 1e-4 of each tensor's largest
  magnitude, the forward tolerance of tests/test_torch_port_model.py.
- Post-processing of each head on the same seeded head outputs through
  each package's ``DetectionModel.postprocess`` (FCOS's ``decode_ltrb``
  with and without the stride ``reg_scales``), at PRE_NMS_TOP_N 1000
  (the compaction tiers) and 20 (the top-k tier): labels and valid
  equal, boxes and scores within 1e-5 absolute (the same float32
  operations; boxes are below 100 px).
- Every file of configs/atss, configs/fcos and configs/retinanet builds
  at narrow width with the head, anchors and strides it names, the five
  MobileNetV2 FCOS files on the MobileNetV2 body.
- The reference checkpoint layout of the narrow ATSS and FCOS models
  (tests/reference_layout.py: GroupNorm towers, ``centerness``, P6 from
  C5 for RetinaNet) lands on the tensors the JAX package's import lands
  on; a RetinaNet file raises, since its towers (conv i at index 2i)
  are read by the JAX package's GroupNorm-tower rule into the wrong
  convs (ROADMAP section 3).
- ``param_labels`` of each narrow model equals the JAX package's, the DCN
  tower's offset convs included.
- ``TTAEngine.detect_batch`` of ATSS (with and without VOTE), FCOS (with
  VOTE) and RetinaNet (without) against the JAX package's engine;
  FCOS's TTA without VOTE raises (ROADMAP section 3).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_layout as rl
from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.atss_head import atss_head_from_cfg as jatss_head
from paa_tpu.modeling.fcos_head import fcos_head_from_cfg as jfcos_head
from paa_tpu.modeling.paa_head import paa_head_from_cfg as jpaa_head
from paa_tpu.modeling.retinanet_head import (
    retinanet_head_from_cfg as jretina_head)
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu.utils import torch_import as jti
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.atss_head import atss_head_from_cfg
from paa_tpu_torch.modeling.fcos_head import fcos_head_from_cfg
from paa_tpu_torch.modeling.paa_head import paa_head_from_cfg
from paa_tpu_torch.modeling.retinanet_head import retinanet_head_from_cfg
from paa_tpu_torch.ops import dcn
from paa_tpu_torch.solver import param_labels
from paa_tpu_torch.modeling.mobilenet import MobileNetV2
from paa_tpu_torch.utils import load_jax_params
from paa_tpu_torch.utils import torch_import as ti
from test_torch_port_model import _seeded_params
from test_torch_port_train import _one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
# the narrow heads: 2 convs, 32 channels, 2 levels
NARROW_HEAD = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
               "TPU.FUSED_GN", True, "TPU.DCN_MODE", "gather"]
HEADS = {
    "atss_box": ("ATSS", []),
    "atss_point": ("ATSS", ["MODEL.ATSS.REGRESSION_TYPE", "POINT"]),
    "atss_no_branch": ("ATSS", ["MODEL.ATSS.USE_CENTERNESS_PRED", False,
                                "MODEL.ATSS.USE_IOU_PRED", False]),
    "atss_dcn": ("ATSS", ["MODEL.ATSS.USE_DCN_IN_TOWER", True]),
    "fcos": ("FCOS", []),
    "fcos_norm": ("FCOS", ["MODEL.FCOS.NORM_REG_TARGETS", True]),
    "fcos_ctr_on_reg": ("FCOS", ["MODEL.FCOS.CENTERNESS_ON_REG", True]),
    "fcos_norm_ctr_on_reg": ("FCOS", ["MODEL.FCOS.NORM_REG_TARGETS", True,
                                      "MODEL.FCOS.CENTERNESS_ON_REG", True]),
    "retinanet": ("RETINANET", ["MODEL.RETINANET.SCALES_PER_OCTAVE", 3]),
    "paa_no_iou_pred": ("PAA", ["MODEL.PAA.USE_IOU_PRED", False]),
}
HEAD_BUILDERS = {"ATSS": (jatss_head, atss_head_from_cfg),
                 "FCOS": (jfcos_head, fcos_head_from_cfg),
                 "RETINANET": (jretina_head, retinanet_head_from_cfg),
                 "PAA": (jpaa_head, paa_head_from_cfg)}


def _head_cfgs(node, extra):
    strides = "FPN_STRIDES" if node == "FCOS" else "ANCHOR_STRIDES"
    levels = [f"MODEL.{node}.NUM_CONVS", 2, f"MODEL.{node}.{strides}",
              (8, 16)]
    if node != "FCOS":
        levels += [f"MODEL.{node}.ANCHOR_SIZES", (64, 128)]
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(NARROW_HEAD + levels + extra)
        cfg.freeze()
        out.append(cfg)
    return out


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(HEADS))
def test_head_matches_jax(case):
    node, extra = HEADS[case]
    jcfg, cfg = _head_cfgs(node, extra)
    jbuild, build = HEAD_BUILDERS[node]
    rng = np.random.RandomState(0)
    feats = [rng.normal(0, 1, (2, h, w, 32)).astype(np.float32)
             for h, w in ((8, 12), (4, 6))]
    jhead = jbuild(jcfg)
    shapes = jax.eval_shape(lambda: jhead.init(
        jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]))["params"]
    params = _seeded_params(shapes, np.random.RandomState(1))
    want = jax.jit(lambda p, fs: jhead.apply({"params": p}, fs))(
        params, [jnp.asarray(f) for f in feats])
    head = load_jax_params(build(cfg), params)
    with torch.no_grad():
        got = head([torch.from_numpy(f).permute(0, 3, 1, 2).contiguous()
                    for f in feats])
    assert set(got) == set(want)
    assert ("iou_pred" in got) == (case not in ("atss_no_branch",
                                                "retinanet",
                                                "paa_no_iou_pred"))
    for k in want:
        _close(got[k].numpy(), want[k], 1e-4)
    if case in ("atss_point", "fcos_norm", "fcos_norm_ctr_on_reg"):
        assert (got["box_regression"] >= 0).all()  # the ReLU
    if case == "atss_dcn":
        assert isinstance(head.cls_tower.conv1, dcn.DeformConv)


# ---- post-processing ------------------------------------------------------

CONFIG_FILES = {
    "atss": "configs/atss/atss_R_50_FPN_1x.yaml",
    "fcos": "configs/fcos/fcos_imprv_R_50_FPN_1x.yaml",
    "retinanet": "configs/retinanet/retinanet_R-50-FPN_1x.yaml",
}
# the narrow models of the three configs: a ResNet-50 of an eighth of the
# widths, 32 FPN channels, 2 tower convs
NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
          "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
          "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
          "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
          "TPU.FUSED_GN", True, "TPU.COMPUTE_DTYPE", "float32",
          "TEST.DETECTIONS_PER_IMG", 10]


def narrow_cfgs(kind, extra=()):
    """(JAX cfg, port cfg) of ``kind``'s config file at narrow width."""
    node = {"atss": "ATSS", "fcos": "FCOS", "retinanet": "RETINANET"}[kind]
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(os.path.join(ROOT, CONFIG_FILES[kind]))
        cfg.merge_from_list(NARROW + [f"MODEL.{node}.NUM_CONVS", 2]
                            + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


@pytest.mark.parametrize("top_n", [1000, 20])
@pytest.mark.parametrize("kind,extra", [
    ("atss", []),
    ("fcos", []),
    ("fcos", ["MODEL.FCOS.NORM_REG_TARGETS", False]),
    ("retinanet", []),
])
def test_postprocess_matches_jax(kind, extra, top_n):
    node = {"atss": "ATSS", "fcos": "FCOS", "retinanet": "RETINANET"}[kind]
    jcfg, cfg = narrow_cfgs(kind, extra + [f"MODEL.{node}.PRE_NMS_TOP_N",
                                           top_n])
    jmodel = jax_build(jcfg)
    model = build_detection_model(cfg, device="cpu")
    assert model.head_type == kind
    anchors, counts = model.anchors_for(HW)
    want_anchors, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want_anchors)
    assert list(counts) == list(want_counts)
    n = anchors.shape[0]
    rng = np.random.RandomState(2)
    outputs = {"cls_logits": rng.normal(-3.2, 0.8, (2, n, 80)).astype(
        np.float32)}
    if kind == "fcos":  # l/t/r/b: in strides under NORM_REG_TARGETS
        scale = 1.0 if cfg.MODEL.FCOS.NORM_REG_TARGETS else 12.0
        outputs["box_regression"] = (scale * np.exp(rng.normal(
            0.5, 0.5, (2, n, 4)))).astype(np.float32)
    else:
        outputs["box_regression"] = rng.normal(0, 0.3, (2, n, 4)).astype(
            np.float32)
    if kind != "retinanet":
        outputs["iou_pred"] = rng.normal(0, 1, (2, n)).astype(np.float32)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = jmodel.postprocess({k: jnp.asarray(v) for k, v in outputs.items()},
                              jnp.asarray(sizes), jnp.asarray(want_anchors),
                              want_counts)
    got = model.postprocess({k: torch.from_numpy(v)
                             for k, v in outputs.items()},
                            torch.from_numpy(sizes), anchors, counts)
    assert int(got["valid"].sum()) == 20
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    pp, jpp = model.postprocess_config(), jmodel.postprocess_config()
    assert pp.__dict__ == jpp.__dict__ and not pp.score_voting


def _head_init_scale(tree, rng, cls_bias=None):
    """The head's convs at their init's scale, normal(0.01), and the cls
    bias at the focal prior 0.01, or drawn from ``rng`` in ``cls_bias``
    (a range about the 0.05 threshold, so that detections exist):
    RetinaNet's towers have no norm, so kaiming-scale kernels would make
    its logits, losses and updates explode."""
    def walk(node):
        for sub in node.values():
            if isinstance(sub, dict) and "kernel" in sub:
                sub["kernel"] = rng.normal(0, 0.01, sub["kernel"].shape
                                           ).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub)

    walk(tree)
    bias = tree["cls_logits"]["bias"]
    bias[:] = -np.log(99.0) if cls_bias is None else rng.uniform(
        *cls_bias, bias.shape)


@pytest.mark.parametrize("kind,extra", [
    ("atss", []),
    ("fcos", []),
    ("retinanet", []),
    ("retinanet", ["MODEL.RETINANET.USE_C5", False]),
])
def test_eval_fn_matches_jax(kind, extra):
    """The whole inference slice of each narrow model, uint8 in,
    detections out (RetinaNet with P6 from C5, its config's, and from P5):
    FPN features and head outputs within 1e-4 of each tensor's largest
    magnitude, labels and valid equal, boxes and scores within 1e-3, as
    tests/test_torch_port_model.py holds PAA-R50's."""
    from flax import linen as nn

    jcfg, cfg = narrow_cfgs(kind, extra)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    _head_init_scale(params["head"], np.random.RandomState(1), (-3.5, -2.5))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)

    x = images.astype(np.float32) - np.asarray(cfg.INPUT.PIXEL_MEAN,
                                                np.float32)

    def feats_and_out(m, xx):
        feats = m.backbone(xx)
        return feats, m.head(feats)

    want_f, want_o = jax.jit(lambda v, xx: nn.apply(
        feats_and_out, jmodel.module)(v, xx))({"params": params}, x)
    with torch.no_grad():
        got_f = model.module.backbone(
            torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
        got_o = model.module.head(got_f)
    for g, w in zip(got_f, want_f):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    assert set(got_o) == set(want_o)
    for k in want_o:
        _close(got_o[k].numpy(), want_o[k], 1e-4)

    want = jmodel.make_eval_fn({"params": params})(jnp.asarray(images),
                                                   jnp.asarray(sizes))
    got = model.make_eval_fn()(torch.from_numpy(images),
                               torch.from_numpy(sizes))
    assert int(got["valid"].sum()) > 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-3, err_msg=k)


def test_paa_without_iou_pred_postprocess_and_loss_match_jax():
    """PAA with USE_IOU_PRED off (the head gives no ``iou_pred``): the
    post-processing (score voting on) and ``paa_loss`` on the same seeded
    outputs equal the JAX package's, within the limits above and those of
    tests/test_torch_port_loss.py (losses 1e-5 relative)."""
    from paa_tpu.modeling.paa_loss import PAALossConfig as JPAALossConfig
    from paa_tpu.modeling.paa_loss import paa_loss as jax_paa_loss
    from paa_tpu_torch.modeling.paa_loss import PAALossConfig, paa_loss
    from test_torch_port_model import OVERRIDES

    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(OVERRIDES + [
            "MODEL.PAA.USE_IOU_PRED", False,
            "MODEL.PAA.INFERENCE_SCORE_VOTING", True])
        cfg.freeze()
        cfgs.append(cfg)
    jmodel, model = jax_build(cfgs[0]), build_detection_model(cfgs[1],
                                                              device="cpu")
    anchors, counts = model.anchors_for(HW)
    n = anchors.shape[0]
    rng = np.random.RandomState(4)
    outputs = {
        "cls_logits": rng.normal(-3.2, 0.8, (2, n, 80)).astype(np.float32),
        "box_regression": rng.normal(0, 0.3, (2, n, 4)).astype(np.float32)}
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = jax.jit(lambda o, z, a: jmodel.postprocess(o, z, a, counts))(
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(sizes),
        jnp.asarray(anchors.numpy()))
    got = model.postprocess({k: torch.from_numpy(v)
                             for k, v in outputs.items()},
                            torch.from_numpy(sizes), anchors, counts)
    assert int(got["valid"].sum()) == 20
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)

    gt_boxes = np.asarray([[[6, 6, 40, 44], [30, 20, 90, 60]],
                           [[10, 30, 70, 58], [0, 0, 0, 0]]], np.float32)
    gt_labels = np.asarray([[1, 3], [4, 0]], np.int32)
    jlc, lc = JPAALossConfig.from_cfg(cfgs[0]), PAALossConfig.from_cfg(
        cfgs[1])
    want = jax.jit(lambda o, b, l, a: jax_paa_loss(o, b, l, a, counts, jlc))(
        {k: jnp.asarray(v) for k, v in outputs.items()},
        jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
        jnp.asarray(anchors.numpy()))
    got = paa_loss({k: torch.from_numpy(v) for k, v in outputs.items()},
                   torch.from_numpy(gt_boxes), torch.from_numpy(gt_labels),
                   anchors, counts, lc)
    assert set(got) == set(want) == {"loss_cls", "loss_reg", "num_pos"}
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss_cls", "loss_reg"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


# ---- config builds --------------------------------------------------------

DENSE_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for d in ("atss", "fcos", "retinanet")
    for p in glob.glob(os.path.join(ROOT, "configs", d, "*.yaml")))
CONFIG_NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
                 "MODEL.RESNETS.WIDTH_PER_GROUP", 1,
                 "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
                 "MODEL.RESNETS.RES2_OUT_CHANNELS", 64]


@pytest.mark.parametrize("path", DENSE_CONFIGS)
def test_every_dense_config_builds(path):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, path))
    cfg.merge_from_list(CONFIG_NARROW)
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu")
    body = model.module.backbone.resnet
    assert isinstance(body, MobileNetV2) == ("MNV2" in path)
    m = cfg.MODEL
    kind = ("atss" if m.ATSS_ON else "fcos" if m.FCOS_ON else "retinanet")
    assert model.head_type == kind
    node = m[kind.upper()]
    head = model.module.head
    assert model.strides == tuple(
        node.FPN_STRIDES if kind == "fcos" else node.ANCHOR_STRIDES)
    if kind != "retinanet":
        assert isinstance(head.cls_tower.conv3, dcn.DeformConv) == \
            node.USE_DCN_IN_TOWER
    p6 = model.module.backbone.fpn.p6
    assert p6.weight.shape[1] == (64 * 8 if m.RETINANET.USE_C5 else 32)
    anchors, counts = model.anchors_for(HW)
    a = 1 if kind == "fcos" else len(node.ASPECT_RATIOS) * \
        node.SCALES_PER_OCTAVE
    assert anchors.shape == (a * sum(h * w for h, w in
                                     model.feature_shapes(HW)), 4)
    assert head.cls_logits.weight.shape[0] == a * 80


# ---- reference checkpoints -------------------------------------------------

@pytest.mark.parametrize("kind,extra", [
    ("atss", ["MODEL.ATSS.USE_DCN_IN_TOWER", True]),
    ("fcos", []),
])
def test_reference_import_lands_where_jax_lands(kind, extra):
    from test_torch_port_ckpt_import import _jax_tree, _port_layout

    jcfg, cfg = narrow_cfgs(kind, extra)
    state = rl.seeded_state_dict(rl.layout(cfg), seed=5)
    assert any(".centerness." in k for k in state)
    tree = jti.load_torch_state_dict(_jax_tree(jax_build(jcfg)), state)
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_torch_state_dict(model.module, state)
    assert skipped == [] and unwritten == []
    want = _port_layout(model, tree)
    got = model.module.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)


def test_reference_retinanet_towers_raise():
    """The reference RetinaNet head's towers are Sequential(conv, ReLU):
    conv i at index 2i. The JAX package's rule (conv at 3i, GroupNorm at
    3i + 1) writes index 6 (conv 3) into conv2 and drops index 2 (conv
    1); the port raises on such a file rather than copy that."""
    _, cfg = narrow_cfgs("retinanet", ["MODEL.RETINANET.NUM_CONVS", 4])
    state = rl.seeded_state_dict(rl.layout(cfg), seed=5)
    assert "rpn.head.cls_tower.6.weight" in state
    assert jti.torch_name_to_flax_path("rpn.head.cls_tower.6.weight")[0] == \
        ("head", "cls_tower", "conv2", "kernel")
    assert jti.torch_name_to_flax_path("rpn.head.cls_tower.2.weight") is None
    model = build_detection_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="RetinaNet"):
        ti.load_torch_state_dict(model.module, state)
    # the rest of the file (body, FPN with P6 from C5, predictors) maps
    body = {k: v for k, v in state.items() if "_tower." not in k}
    skipped, unwritten = ti.load_torch_state_dict(model.module, body)
    assert skipped == []
    assert all("_tower." in k for k in unwritten) and unwritten


# ---- parameter labels -----------------------------------------------------

@pytest.mark.parametrize("kind,extra", [
    ("atss", ["MODEL.ATSS.USE_DCN_IN_TOWER", True]),
    ("fcos", []),
    ("retinanet", []),
])
def test_param_labels_match_jax(kind, extra):
    """Every port tensor gets the label of its JAX leaf (each JAX leaf
    filled with its own index and loaded into the port's module)."""
    jcfg, cfg = narrow_cfgs(kind, extra)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    leaves, treedef = jax.tree.flatten(shapes)
    ids = jax.tree.unflatten(treedef, [
        np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    want = jax.tree.leaves(jax_param_labels(ids, 2))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, ids)
    state = model.module.state_dict()
    got = param_labels(model.module, 2)
    assert len(got) == len(leaves)
    for name, t in state.items():
        assert got[name] == want[int(t.flatten()[0])], name
    if kind == "atss":
        assert {"dcn_offset", "dcn_offset_bias"} <= set(got.values())


TTA_EXTRA = ["INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
             "TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.H_FLIP", True,
             "TEST.BBOX_AUG.SCALE_H_FLIP", True,
             "TEST.BBOX_AUG.SCALES", (48, 80),
             "TEST.BBOX_AUG.SCALE_RANGES", ((0, 48), (24, 10000)),
             "TEST.BBOX_AUG.MERGE_TYPE", "soft-vote"]


@pytest.mark.parametrize("kind,vote", [("atss", True), ("atss", False),
                                       ("fcos", True), ("retinanet", False)])
def test_tta_detect_batch_matches_jax(kind, vote):
    """``TTAEngine.detect_batch`` of each head (the identity, two scales
    with their ranges, each flipped; soft-vote, or the pooled candidates
    and one NMS without VOTE) against the JAX package's on 2 images:
    merged labels equal, boxes and scores within 1e-3, as
    tests/test_torch_port_tta.py holds PAA-R50's."""
    from paa_tpu.engine import bbox_aug as jaug
    from paa_tpu_torch.engine import bbox_aug as aug

    jcfg, cfg = narrow_cfgs(kind, TTA_EXTRA + ["TEST.BBOX_AUG.VOTE", vote])
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    _head_init_scale(params["head"], np.random.RandomState(1), (-3.5, -2.5))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    rng = np.random.RandomState(3)
    images = [rng.randint(0, 256, (64, 96, 3)).astype(np.uint8),
              rng.randint(0, 256, (90, 60, 3)).astype(np.uint8)]
    want = jaug.TTAEngine(jcfg, jmodel, {"params": params}).detect_batch(
        images)
    got = aug.TTAEngine(cfg, model).detect_batch(images)
    assert len(got) == len(want) == 2
    for (gb, gs, gl), (wb, ws, wl) in zip(got, want):
        assert len(gl) == len(wl) > 0
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-3)


def test_tta_of_fcos_needs_vote():
    """The JAX package's TTA candidate path (no VOTE) decodes FCOS's
    l/t/r/b distances as anchor deltas; the port runs FCOS's TTA with
    VOTE only (ROADMAP section 3)."""
    from paa_tpu_torch.engine.bbox_aug import TTAEngine

    _, cfg = narrow_cfgs("fcos", ["TEST.BBOX_AUG.ENABLED", True,
                                  "TEST.BBOX_AUG.VOTE", False])
    with pytest.raises(NotImplementedError, match="VOTE only"):
        TTAEngine(cfg, None)

"""Reference-checkpoint import of the PyTorch port against the JAX
package, on the CPU, at the narrow configs of
tests/test_torch_port_model.py (PAA-R50, BACKBONE_OUT_CHANNELS 64),
tests/test_torch_port_two_stage.py (Faster R-CNN R-50-FPN, 64 channels,
5 classes, MLP 64), the same Mask R-CNN with 64-channel mask convs,
and a narrow dcnv2 ResNeXt PAA (8 groups x 4, stem 16,
res2 64, modulated DCN in stages 3-5 and the towers' last conv, the JAX
side sampling with TPU.DCN_MODE "gather").

The reference's state-dict layout is written out from its module
definitions in tests/reference_layout.py (not from either package's
name table) and filled from a numpy seed, no tensor at an identity.

- The layout is complete: ``paa_tpu``'s ``load_torch_state_dict``
  matches every key and skips none, and writes every leaf of its tree;
  the port's skips none and leaves no port tensor unwritten.
- Both land on the same numbers: the port's tensors equal the JAX tree
  carried across by ``load_jax_params`` (exactly: the importers only
  rename, reshape and permute). fc6's column permutation, the Scale's
  shape and the mask logits' dropped background channel are checked
  here; the reference's ``conv5_mask`` (torch's ConvTranspose2d layout)
  copies as it is, where the JAX package flips it spatially, so equal
  tensors through ``load_jax_params`` check both flips.
- The forwards agree within test_torch_port_model.py's tolerances (FPN
  features and head outputs within 1e-4 of each tensor's largest
  magnitude), and so do the detections (labels and valid equal, boxes
  and scores within 1e-3; Mask R-CNN's mask probabilities within 1e-3
  and Keypoint R-CNN's heatmaps within 1e-3 of their largest magnitude:
  the heads pool at those boxes, which agree to 1e-3 px). Keypoint
  R-CNN (the keypoint convs and the 4x4 ``kps_score_lowres``, torch's
  layout) and the C4 models (the body under ``backbone.body``, res5 as
  ``roi_heads.box.feature_extractor.head.layer4``, the C4 mask
  predictor; a C4 of 1,024 channels, the width at which the reference's
  RPN conv is the JAX package's fixed 1,024) are among the layouts.
- A Detectron pickle (Caffe2Detectron surface: body, FPN, RPN, box
  head, and mask head ``_[mask]_fcnN``, ``conv5_mask``,
  ``mask_fcn_logits``; BatchNorm folded) made with
  tests/ref_torch.py's inverse rename lands on the same tensors through
  both packages' ``load_c2_pickle``; the running statistics keep 0 and
  1.
- A seeded X-101-32x8d ImageNet pickle at the X-152 dcnv2 config's
  ``MODEL.WEIGHT`` (narrowed): the port leaves unwritten exactly the
  tensors whose leaves ``paa_tpu`` leaves untouched (the offset convs,
  ``layer2_4..7`` and ``layer3_23..35``, which X-101 lacks, the FPN, the
  head and the folded running statistics).
- ``catalog://`` through ``ModelCatalog`` (its WEIGHTS_DIR set on the
  class, which reads the environment when it is defined), the
  ``module.`` prefix, a missing FrozenBN tensor left at its init, a
  planted wrong key reported as skipped, and the errors of
  ``load_pretrained_into``.
"""

import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import ref_torch
import reference_layout as rl
from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.config.paths_catalog import ModelCatalog as JModelCatalog
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.two_stage import FasterRCNN as JFasterRCNN
from paa_tpu.utils import torch_import as jti
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.config.paths_catalog import ModelCatalog
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.utils import load_jax_params
from paa_tpu_torch.utils import torch_import as ti
from test_torch_port_backbones import _restore_jax_dcn_mode  # noqa: F401
from test_torch_port_model import OVERRIDES as PAA_OVERRIDES
from test_torch_port_two_stage import CONFIG as FRCNN_CONFIG
from test_torch_port_two_stage import OVERRIDES as FRCNN_OVERRIDES

MRCNN_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
MRCNN_OVERRIDES = FRCNN_OVERRIDES + [
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (64, 64, 64, 64)]
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")
# Keypoint R-CNN: the Faster R-CNN overrides, 2 classes, two 32-channel
# keypoint convs; the C4 models: a C4 of 1,024 channels (the width at
# which the reference's RPN conv is the JAX package's fixed 1,024) on
# narrow bottlenecks, a 32-channel mask predictor
KRCNN = (os.path.join(CONFIGS, "e2e_keypoint_rcnn_R_50_FPN_1x.yaml"),
         FRCNN_OVERRIDES + ["MODEL.ROI_BOX_HEAD.NUM_CLASSES", 2,
                            "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", (32, 32)])
C4 = FRCNN_OVERRIDES + ["MODEL.RESNETS.RES2_OUT_CHANNELS", 256,
                        "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
                        "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
                        "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (32,)]
# the GN models (narrow as Faster R-CNN): the Xconv1fc GN Mask R-CNN with
# 64-wide head convs; the scratch FPN2MLP one with its fc GN at MLP 256
# (groups of 8); a GN-free Xconv head with the 1x1 mask predictor; the
# RPN-only models (C4 at the config's width)
GN_HEADS = ["MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM", 64,
            "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (64, 64, 64, 64)]
GN_FILES = {
    "mrcnn_gn": (os.path.join(CONFIGS, "gn_baselines",
                              "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml"),
                 FRCNN_OVERRIDES + GN_HEADS),
    "frcnn_gn": (os.path.join(CONFIGS, "gn_baselines",
                              "scratch_e2e_faster_rcnn_R_50_FPN_3x_gn.yaml"),
                 FRCNN_OVERRIDES + ["MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 256]),
    "mrcnn_xconv": (MRCNN_CONFIG, FRCNN_OVERRIDES + GN_HEADS + [
        "MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR",
        "FPNXconv1fcFeatureExtractor",
        "MODEL.ROI_MASK_HEAD.PREDICTOR", "MaskRCNNConv1x1Predictor"]),
    "rpn_fpn": (os.path.join(CONFIGS, "rpn_R_50_FPN_1x.yaml"),
                FRCNN_OVERRIDES),
    "rpn_c4": (os.path.join(CONFIGS, "rpn_R_50_C4_1x.yaml"), []),
}
FILES = {**GN_FILES, "krcnn": KRCNN,
         "frcnn_c4": (os.path.join(CONFIGS, "e2e_faster_rcnn_R_50_C4_1x.yaml"),
                      C4),
         "mrcnn_c4": (os.path.join(CONFIGS, "e2e_mask_rcnn_R_50_C4_1x.yaml"),
                      C4)}
TWO_STAGE = ("frcnn", "mrcnn", "krcnn")

HW = (64, 96)
SLIM = ["MODEL.RESNETS.WIDTH_PER_GROUP", 8,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 32]
DCNV2_X = ["MODEL.RESNETS.NUM_GROUPS", 8,
           "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
           "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
           "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
           "MODEL.RESNETS.STAGE_WITH_DCN", (False, True, True, True),
           "MODEL.RESNETS.WITH_MODULATED_DCN", True,
           "MODEL.PAA.USE_DCN_IN_TOWER", True,
           "TPU.DCN_MODE", "gather"]
X152_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "paa",
    "paa_dcnv2_X_152_32x8d_FPN_2x.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(get, kind, extra=()):
    cfg = get()
    if kind == "frcnn":
        cfg.merge_from_file(FRCNN_CONFIG)
        cfg.merge_from_list(FRCNN_OVERRIDES + list(extra))
    elif kind == "mrcnn":
        cfg.merge_from_file(MRCNN_CONFIG)
        cfg.merge_from_list(MRCNN_OVERRIDES + list(extra))
    elif kind in FILES:
        cfg.merge_from_file(FILES[kind][0])
        cfg.merge_from_list(FILES[kind][1] + list(extra))
    elif kind == "dcnv2_x":
        cfg.merge_from_list(PAA_OVERRIDES + DCNV2_X + list(extra))
    else:
        cfg.merge_from_list(PAA_OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


def _jax_tree(jmodel):
    """The JAX model's param tree with every leaf 0 except FrozenBN's
    running variances (1, their init), so that an unwritten leaf shows."""
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]

    def leaf(path, s):
        one = path[-1].key == "running_var"
        return (np.ones if one else np.zeros)(s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger():
    logger = logging.getLogger(f"ckpt_import_{id(object())}")
    handler = _Records()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger, handler.lines


@pytest.fixture(scope="module", params=["paa", "frcnn", "mrcnn",
                                        "dcnv2_x", "krcnn"])
def loaded(request):
    """One seeded reference state dict loaded into each package."""
    kind = request.param
    jcfg, cfg = _cfg(jax_get_cfg, kind), _cfg(get_cfg, kind)
    state = rl.seeded_state_dict(rl.layout(cfg), seed=5)
    jmodel = jax_build(jcfg)
    jlogger, jlines = _logger()
    start = _jax_tree(jmodel)
    tree = jti.load_torch_state_dict(
        start, state, jlogger,
        box_pooler_resolution=jcfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_torch_state_dict(model.module, state)
    return dict(kind=kind, state=state, jmodel=jmodel, start=start,
                tree=tree, jlines=jlines, model=model, skipped=skipped,
                unwritten=unwritten)


def _port_layout(model, tree):
    """A JAX param tree as the port's named tensors (load_jax_params into
    a scratch module)."""
    scratch = build_detection_model(model.cfg, device="cpu", seed=2)
    load_jax_params(scratch.module, tree)
    return scratch.module.state_dict()


def test_reference_layout_is_complete(loaded):
    assert len(loaded["state"]) > 290
    assert f"matched {len(loaded['state'])} tensors, skipped 0" in \
        loaded["jlines"][0]
    written = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.any(a != b)), loaded["tree"], loaded["start"]))
    assert all(written)
    assert loaded["skipped"] == [] and loaded["unwritten"] == []


def test_import_lands_on_the_tensors_jax_lands_on(loaded):
    want = _port_layout(loaded["model"], loaded["tree"])
    got = loaded["model"].module.state_dict()
    assert set(got) == set(want)
    for key, value in got.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)


def test_fc6_columns_and_scale_shape(loaded):
    """fc6's (out, C * 7 * 7) NCHW columns land in the port's (7, 7, C)
    order; a (1,) Scale lands as a scalar; the mask logits' channel 0
    (the background, which the reference never reads) is dropped and
    ``conv5_mask`` copies in torch's layout."""
    state, module = loaded["state"], loaded["model"].module
    if loaded["kind"] == "krcnn":  # the 4x4 deconv copies as it is too
        np.testing.assert_array_equal(
            module.keypoint_head.kps_score_lowres.weight.detach().numpy(),
            state["roi_heads.keypoint.predictor.kps_score_lowres.weight"])
    if loaded["kind"] == "mrcnn":
        p = "roi_heads.mask.predictor"
        np.testing.assert_array_equal(
            module.mask_head.mask_fcn_logits.weight.detach().numpy(),
            state[f"{p}.mask_fcn_logits.weight"][1:])
        np.testing.assert_array_equal(
            module.mask_head.mask_fcn_logits.bias.detach().numpy(),
            state[f"{p}.mask_fcn_logits.bias"][1:])
        np.testing.assert_array_equal(
            module.mask_head.conv5_mask.weight.detach().numpy(),
            state[f"{p}.conv5_mask.weight"])
    if loaded["kind"] not in TWO_STAGE:
        for level in range(5):
            got = module.head.get_submodule(f"scale{level}").scale
            assert got.shape == ()
            assert float(got.detach()) == \
                state[f"rpn.head.scales.{level}.scale"][0]
        return
    w = state["roi_heads.box.feature_extractor.fc6.weight"]
    got = module.box_head.fc6.weight.detach().numpy()
    c = w.shape[1] // 49
    for h, x, ch in ((0, 0, 0), (2, 5, 7), (6, 6, c - 1), (3, 1, 33)):
        np.testing.assert_array_equal(got[:, (h * 7 + x) * c + ch],
                                      w[:, ch * 49 + h * 7 + x])


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_forward_matches_jax(loaded):
    model, jmodel = loaded["model"], loaded["jmodel"]
    variables = {"params": loaded["tree"]}
    x = np.random.RandomState(3).uniform(-100, 100, (2, *HW, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    if loaded["kind"] not in TWO_STAGE:
        def fwd(m, xx):
            feats = m.backbone(xx)
            return feats, m.head(feats)

        want_f, want_o = jax.jit(lambda v, xx: nn.apply(
            fwd, jmodel.module)(v, xx))(variables, x)
        with torch.no_grad():
            got_f = model.module.backbone(xt)
            got_o = model.module.head(got_f)
    else:
        want_f, want_o = jax.jit(lambda v, xx: jmodel.module.apply(
            v, xx, method=JFasterRCNN.backbone_rpn))(variables, x)
        with torch.no_grad():
            got_f, got_o = model.module.backbone_rpn(xt)
        # the box head on the same rois: fc6 sees every pooled column
        rois = np.asarray([[4, 6, 50, 40], [10, 2, 90, 60], [0, 0, 30, 63]],
                          np.float32)
        bidx = np.asarray([0, 1, 1], np.int32)
        want_box = jax.jit(lambda v, f, r, b: jmodel.module.apply(
            v, f, r, b, method=JFasterRCNN.box))(
            variables, want_f, jnp.asarray(rois), jnp.asarray(bidx))
        with torch.no_grad():
            got_box = model.module.box(got_f, torch.from_numpy(rois),
                                       torch.from_numpy(bidx).long())
        for g, w in zip(got_box, want_box):
            _close(g.numpy(), w, 1e-4)
        # the mask or keypoint head on the same rois
        for kind, method in (("mrcnn", "mask"), ("krcnn", "keypoint")):
            if loaded["kind"] != kind:
                continue
            want_head = jax.jit(lambda v, f, r, b: jmodel.module.apply(
                v, f, r, b, method=getattr(JFasterRCNN, method)))(
                variables, want_f, jnp.asarray(rois), jnp.asarray(bidx))
            with torch.no_grad():
                got_head = getattr(model.module, method)(
                    got_f, torch.from_numpy(rois),
                    torch.from_numpy(bidx).long())
            _close(got_head.permute(0, 2, 3, 1).numpy(), want_head, 1e-4)
    assert len(got_f) == len(want_f) == 5
    for g, w in zip(got_f, want_f):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    assert set(got_o) == set(want_o)
    for k in want_o:
        _close(got_o[k].numpy(), want_o[k], 1e-4)


def test_detections_match_jax(loaded):
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    want = loaded["jmodel"].make_eval_fn({"params": loaded["tree"]})(
        jnp.asarray(images), jnp.asarray(sizes))
    got = loaded["model"].make_eval_fn()(torch.from_numpy(images),
                                         torch.from_numpy(sizes))
    assert int(got["valid"].sum()) > 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["boxes"].numpy(),
                               np.asarray(want["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-3)
    assert ("masks" in got) == ("masks" in want) == (
        loaded["kind"] == "mrcnn")
    if "masks" in got:
        assert got["masks"].shape == (2, 10, 28, 28)
        np.testing.assert_allclose(got["masks"].numpy(),
                                   np.asarray(want["masks"]), rtol=0,
                                   atol=1e-3)
    if loaded["kind"] == "krcnn":  # heatmap logits: 1e-3 of the largest
        want_h = np.asarray(want["kp_heatmaps"])
        assert got["kp_heatmaps"].shape == (2, 10, 17, 56, 56)
        np.testing.assert_allclose(
            got["kp_heatmaps"].permute(0, 1, 3, 4, 2).numpy(), want_h,
            rtol=0, atol=1e-3 * np.abs(want_h).max())


def _c4_port_key(key):
    """The port's name of a reference C4 key, written out here: the body
    keeps ``backbone.body`` (blocks ``layer{s}_{b}``), res5 is the box
    head's ``layer4_{b}`` (the mask branch's listing too), a downsample's
    conv and FrozenBN are ``downsample_conv`` / ``downsample_bn``, the
    RPN head ``rpn_head`` and the predictors the heads' own."""
    parts = key.split(".")
    if parts[:2] == ["backbone", "body"] and parts[2].startswith("layer"):
        parts = ["backbone", "body", f"{parts[2]}_{parts[3]}", *parts[4:]]
    elif parts[:3] == ["roi_heads", "box", "feature_extractor"] or \
            parts[:3] == ["roi_heads", "mask", "feature_extractor"]:
        parts = ["box_head", f"layer4_{parts[5]}", *parts[6:]]
    elif parts[:2] == ["rpn", "head"]:
        parts = ["rpn_head", *parts[2:]]
    elif parts[:3] == ["roi_heads", "box", "predictor"]:
        parts = ["box_head", *parts[3:]]
    elif parts[:3] == ["roi_heads", "mask", "predictor"]:
        parts = ["mask_head", *parts[3:]]
    out = ".".join(parts)
    return out.replace("downsample.0.", "downsample_conv.").replace(
        "downsample.1.", "downsample_bn.")


@pytest.mark.parametrize("kind", ["frcnn_c4", "mrcnn_c4"])
def test_c4_reference_checkpoint_import(kind):
    """A seeded reference C4 state dict (the C4 Mask R-CNN's shared res5
    listed under both branches, as its state dict lists it) fills every
    port tensor and skips nothing; each equals the file's tensor of its
    name (the mask logits without channel 0). The JAX package's importer
    reaches only the heads: it writes its FPN body's scope
    (``backbone/resnet``), not the C4 one (``backbone/body``), so every
    body key, and the mask branch's listing of res5, stay unmatched there
    (ROADMAP section 3); the port's detect on the imported weights gives
    finite detections."""
    jcfg, cfg = _cfg(jax_get_cfg, kind), _cfg(get_cfg, kind)
    state = rl.with_shared_mask_extractor(
        rl.seeded_state_dict(rl.layout(cfg), seed=5))
    assert len(state) > 240
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_torch_state_dict(model.module, state)
    assert skipped == [] and unwritten == []
    got = model.module.state_dict()
    for key, value in state.items():
        want = value[1:] if "mask_fcn_logits" in key else value
        np.testing.assert_array_equal(got[_c4_port_key(key)].numpy(), want,
                                      err_msg=key)
    jlogger, jlines = _logger()
    jti.load_torch_state_dict(_jax_tree(jax_build(jcfg)), state, jlogger)
    unmatched = [k for k in state if k.startswith("backbone.body.")
                 or k.startswith("roi_heads.mask.feature_extractor.")]
    assert f"matched {len(state) - len(unmatched)} tensors, skipped " \
           f"{len(unmatched)}" in jlines[0]
    images = np.random.RandomState(1).randint(0, 256, (2, *HW, 3)).astype(
        np.uint8)
    det = model.make_eval_fn()(torch.from_numpy(images), torch.from_numpy(
        np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)))
    assert bool(torch.isfinite(det["boxes"]).all())


# ---- Detectron pickles ----------------------------------------------------

def _c2_pickle(path, state):
    """A Caffe2Detectron-style pickle of ``state`` (BatchNorm folded),
    named by tests/ref_torch.py's inverse of the reference's rename, with
    the optimizer momenta a trained Detectron model carries."""
    blobs = {}
    for key, value in rl.fold_frozen_bn(state).items():
        name = ref_torch.torch_key_to_c2_detection_name(key)
        if name is not None:
            blobs[name] = value
            blobs[name + "_momentum"] = np.zeros_like(value)
    blobs["weight_order"] = np.asarray(sorted(blobs))
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    return blobs


@pytest.mark.parametrize("kind", TWO_STAGE)
def test_c2_pickle_lands_on_the_tensors_jax_lands_on(tmp_path, kind):
    jcfg, cfg = _cfg(jax_get_cfg, kind), _cfg(get_cfg, kind)
    state = rl.seeded_state_dict(rl.layout(cfg), seed=6)
    path = str(tmp_path / "model_final.pkl")
    blobs = _c2_pickle(path, state)
    tree = jti.load_c2_pickle(
        _jax_tree(jax_build(jcfg)), path,
        box_pooler_resolution=jcfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_c2_pickle(model.module, path)
    assert sorted(skipped) == sorted(
        [n for n in blobs if n.endswith("_momentum")] + ["weight_order"])
    # Detectron folds BatchNorm: the running statistics are not written
    assert unwritten and all(k.endswith(("running_mean", "running_var"))
                             for k in unwritten)
    want = _port_layout(model, tree)
    for key, value in model.module.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)
        if key.endswith("running_var"):
            assert bool((value == 1).all()), key


def test_reference_layout_c2_names_match_ref_torch():
    cfg = _cfg(get_cfg, "paa")
    for key in rl.layout(cfg):
        if key.startswith("backbone.body."):
            assert rl.c2_body_name(key) == ref_torch.torch_key_to_c2_name(key)


@pytest.fixture
def slim_imagenet_pkl(tmp_path, monkeypatch):
    """A slim R-50 ImageNet pickle at catalog://ImageNetPretrained/MSRA/R-50
    of both packages' ModelCatalog."""
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(JModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    cfg = _cfg(get_cfg, "paa", SLIM)
    body = {k: v for k, v in rl.seeded_state_dict(rl.layout(cfg), 7).items()
            if k.startswith("backbone.body.")}
    blobs = rl.c2_imagenet_blobs(body, seed=8)
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    return cfg, blobs


def test_catalog_pickle_resolves_like_jax(slim_imagenet_pkl):
    cfg, blobs = slim_imagenet_pkl
    weight = "catalog://ImageNetPretrained/MSRA/R-50"
    model = build_detection_model(cfg, device="cpu", seed=1)
    head_before = model.module.head.cls_logits.weight.detach().clone()
    skipped, unwritten = ti.load_pretrained_into(cfg, model.module, weight)
    assert sorted(skipped) == ["pred_b", "pred_w"]
    assert not any(k.startswith("backbone.resnet.") and
                   not k.endswith(("running_mean", "running_var"))
                   for k in unwritten)
    resnet = model.module.backbone.resnet
    np.testing.assert_array_equal(resnet.stem.conv1.weight.detach().numpy(),
                                  blobs["conv1_w"])
    np.testing.assert_array_equal(
        resnet.layer3_5.bn2.bias.numpy(), blobs["res4_5_branch2b_bn_b"])
    assert torch.equal(model.module.head.cls_logits.weight, head_before)

    jcfg = _cfg(jax_get_cfg, "paa", SLIM)
    tree = jti.load_pretrained_into(jcfg, _jax_tree(jax_build(jcfg)), weight)
    want = _port_layout(model, tree)
    for key, value in model.module.state_dict().items():
        if key.startswith("backbone.resnet."):
            torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                       msg=key)


def test_x101_pickle_into_x152_leaves_what_jax_leaves(tmp_path,
                                                      monkeypatch):
    """The X-152 dcnv2 config's MODEL.WEIGHT is the X-101-32x8d ImageNet
    pickle: its blobs fill the stem and every block X-101 has (the DCN
    blocks' sampled convs from plain ``branch2b``), R-152's extra blocks
    (res3 has 8 to X-101's 4, res4 36 to its 23) keep their init; the
    port's unwritten tensors are exactly those whose leaves ``paa_tpu``
    leaves untouched (every leaf starts at NaN there)."""
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setattr(JModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    narrow = ["MODEL.RESNETS.NUM_GROUPS", 4,
              "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
              "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
              "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
              "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
              "TPU.DCN_MODE", "gather"]
    cfgs = []
    for get in (get_cfg, jax_get_cfg):
        cfg = get()
        cfg.merge_from_file(X152_CONFIG)
        cfg.merge_from_list(narrow)
        cfg.freeze()
        cfgs.append(cfg)
    cfg, jcfg = cfgs
    weight = cfg.MODEL.WEIGHT
    assert weight == "catalog://ImageNetPretrained/FAIR/20171220/X-101-32x8d"
    r = cfg.MODEL.RESNETS
    x101 = rl.resnet_keys(rl.BLOCKS["R-101"], r.STEM_OUT_CHANNELS,
                          r.RES2_OUT_CHANNELS, r.WIDTH_PER_GROUP,
                          r.NUM_GROUPS)
    blobs = rl.c2_imagenet_blobs(rl.seeded_state_dict(x101, 10), seed=11)
    with open(tmp_path / "X-101-32x8d.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)

    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_pretrained_into(cfg, model.module, weight)
    assert sorted(skipped) == ["pred_b", "pred_w"]

    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    start = jax.tree.map(lambda a: np.full(a.shape, np.nan, np.float32),
                         shapes)
    tree = jti.load_pretrained_into(jcfg, start, weight)
    scratch = build_detection_model(cfg, device="cpu", seed=2)
    load_jax_params(scratch.module, tree)
    untouched = sorted(k for k, v in scratch.module.state_dict().items()
                       if bool(torch.isnan(v).all()))
    assert unwritten == untouched

    def expected(key):
        return (not key.startswith("backbone.resnet.")
                or key.endswith(("running_mean", "running_var"))
                or ".conv2.offset." in key
                or any(key.startswith(f"backbone.resnet.layer2_{b}.")
                       for b in range(4, 8))
                or any(key.startswith(f"backbone.resnet.layer3_{b}.")
                       for b in range(23, 36)))

    assert unwritten == sorted(k for k in model.module.state_dict()
                               if expected(k))
    want = _port_layout(model, tree)
    for key, value in model.module.state_dict().items():
        if key not in unwritten:
            torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                       msg=key)
    np.testing.assert_array_equal(
        model.module.backbone.resnet.layer3_22.conv2.weight.detach().numpy(),
        blobs["res4_22_branch2b_w"])
    assert not model.module.backbone.resnet.layer3_22.conv2.offset.weight.any()


def test_module_prefix_missing_and_wrong_keys(tmp_path):
    cfg = _cfg(get_cfg, "paa", SLIM)
    state = rl.seeded_state_dict(rl.layout(cfg), seed=9)
    plain = build_detection_model(cfg, device="cpu", seed=1)
    ti.load_torch_state_dict(plain.module, state)

    # a DistributedDataParallel checkpoint: the same tensors
    prefixed = {f"module.{k}": torch.from_numpy(v) for k, v in state.items()}
    del prefixed["module.backbone.body.layer2.1.bn3.running_var"]
    prefixed["module.rpn.head.cls_logitz.weight"] = torch.zeros(3)
    wrong_shape = "module.rpn.head.bbox_pred.bias"
    prefixed[wrong_shape] = torch.zeros(5)
    other = build_detection_model(cfg, device="cpu", seed=2)
    skipped, unwritten = ti.load_torch_state_dict(other.module, prefixed)
    assert sorted(skipped) == sorted(["module.rpn.head.cls_logitz.weight",
                                      wrong_shape])
    assert unwritten == ["backbone.resnet.layer2_1.bn3.running_var",
                         "head.bbox_pred.bias"]
    var = other.module.backbone.resnet.layer2_1.bn3.running_var
    assert bool((var == 1).all())  # its init, never 0
    want = plain.module.state_dict()
    for key, value in other.module.state_dict().items():
        if key not in unwritten:
            assert torch.equal(value, want[key]), key

    # through load_pretrained_into: a {"model": ...} .pth
    path = tmp_path / "model.pth"
    torch.save({"model": prefixed, "iteration": 7}, path)
    third = build_detection_model(cfg, device="cpu", seed=3)
    assert ti.load_pretrained_into(cfg, third.module, str(path)) == \
        (skipped, unwritten)


def test_load_pretrained_into_raises(tmp_path, monkeypatch):
    cfg = _cfg(get_cfg, "paa", SLIM)
    module = build_detection_model(cfg, device="cpu").module
    with pytest.raises(FileNotFoundError):
        ti.load_pretrained_into(cfg, module, str(tmp_path / "nope.pth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="R-101.pkl"):
        ti.load_pretrained_into(cfg, module,
                                "catalog://ImageNetPretrained/MSRA/R-101")
    monkeypatch.setenv("PAA_TPU_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="not cached"):
        ti.load_pretrained_into(cfg, module,
                                "https://example.invalid/x/model.pth")
    junk = tmp_path / "junk.pth"
    junk.write_bytes(b"not a checkpoint")
    with pytest.raises(pickle.UnpicklingError):
        ti.load_pretrained_into(cfg, module, str(junk))
    nothing = tmp_path / "nothing.pth"
    torch.save({"model": {"fc.weight": torch.zeros(2)}}, nothing)
    with pytest.raises(ValueError, match="none of its tensors"):
        ti.load_pretrained_into(cfg, module, str(nothing))


@pytest.mark.parametrize("name,want", [
    ("rpn.head.cls_tower.2.weight", []),
    ("rpn.head.bbox_tower.9.bias", [("head.bbox_tower.conv3.bias", "copy")]),
    ("rpn.head.cls_tower.4.weight", [("head.cls_tower.gn1.weight", "copy")]),
    ("rpn.anchor_generator.cell_anchors.0", []),
    # an FPN body's res5 first, then a C4 body's (which has none) and a
    # C4 box head's
    ("module.backbone.body.layer4.2.downsample.1.running_var",
     [("backbone.resnet.layer4_2.downsample_bn.running_var", "copy"),
      ("backbone.body.layer4_2.downsample_bn.running_var", "copy"),
      ("box_head.layer4_2.downsample_bn.running_var", "copy")]),
    ("rpn.head.cls_tower.9.conv.bias", [("head.cls_tower.conv3.bias",
                                         "copy")]),
    ("rpn.head.bbox_tower.9.offset.weight",
     [("head.bbox_tower.conv3.offset.weight", "copy")]),
    ("rpn.head.cls_tower.10.offset.weight", []),
    ("backbone.body.layer3.35.conv2.conv.weight",
     [("backbone.resnet.layer3_35.conv2.weight", "copy")]),
    ("module.backbone.body.layer2.0.conv2.offset.bias",
     [("backbone.resnet.layer2_0.conv2.offset.bias", "copy")]),
])
def test_torch_name_to_port_keys(name, want):
    assert ti.torch_name_to_port_keys(name) == want


@pytest.mark.parametrize("blob,want", [
    ("res5_2_branch2c_bn_s", ["backbone.body.layer4.2.bn3.weight"]),
    ("res_conv1_bn_b", ["backbone.body.stem.bn1.bias"]),
    ("fpn_inner_res4_5_sum_lateral_w", ["backbone.fpn.fpn_inner3.weight"]),
    ("conv_rpn_fpn2_b", ["rpn.head.conv.bias"]),
    ("fc1000_w", []), ("res3_0_branch1_w_momentum", []),
    ("res4_35_branch2b_w", ["backbone.body.layer3.35.conv2.weight"]),
])
def test_c2_blob_to_torch_names_matches_jax(blob, want):
    assert ti.c2_blob_to_torch_names(blob) == want
    assert jti.c2_blob_to_torch_names(blob)[:1] == want[:1]


# ---- the GN, Xconv and RPN-only layouts -------------------------------------

@pytest.mark.parametrize("kind", ["mrcnn_gn", "frcnn_gn", "mrcnn_xconv",
                                  "rpn_fpn"])
def test_gn_xconv_and_rpn_only_import_lands_like_jax(kind):
    """A seeded reference state dict of each layout (a GN body's bnX with
    weight and bias alone, FPN and fc and mask_fcn Sequentials of (layer,
    GroupNorm), the xconvs Sequential with and without GN, the 1x1 mask
    predictor, the RPN-only model) fills every port tensor and skips
    nothing, in both packages; the port's tensors equal those the JAX
    package's importer writes, the Xconv head's fc6 columns permuted from
    the NCHW flatten as FPN2MLP's."""
    jcfg, cfg = _cfg(jax_get_cfg, kind), _cfg(get_cfg, kind)
    state = rl.seeded_state_dict(rl.layout(cfg), seed=5)
    jlogger, jlines = _logger()
    tree = jti.load_torch_state_dict(
        _jax_tree(jax_build(jcfg)), state, jlogger,
        box_pooler_resolution=jcfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    assert f"matched {len(state)} tensors, skipped 0" in jlines[0]
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_torch_state_dict(model.module, state)
    assert skipped == [] and unwritten == []
    want = _port_layout(model, tree)
    got = model.module.state_dict()
    for key, value in got.items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                   msg=key)
    p = "roi_heads.box.feature_extractor"
    if kind == "mrcnn_gn":
        assert f"{p}.xconvs.4.weight" in state  # block 1's GN
        np.testing.assert_array_equal(
            got["box_head.xconv2_gn.weight"].numpy(),
            state[f"{p}.xconvs.4.weight"])
        np.testing.assert_array_equal(
            got["backbone.fpn.fpn_layer3_gn.bias"].numpy(),
            state["backbone.fpn.fpn_layer3.1.bias"])
        np.testing.assert_array_equal(
            got["mask_head.mask_fcn2_gn.weight"].numpy(),
            state["roi_heads.mask.feature_extractor.mask_fcn2.1.weight"])
        np.testing.assert_array_equal(
            got["backbone.resnet.layer3_1.bn2.weight"].numpy(),
            state["backbone.body.layer3.1.bn2.weight"])
    if kind == "mrcnn_xconv":
        np.testing.assert_array_equal(got["box_head.xconv3.weight"].numpy(),
                                      state[f"{p}.xconvs.4.weight"])
        assert model.module.mask_head.conv5_mask is None
    if kind == "frcnn_gn":
        np.testing.assert_array_equal(got["box_head.fc7_gn.weight"].numpy(),
                                      state[f"{p}.fc7.1.weight"])
    if kind in ("mrcnn_gn", "mrcnn_xconv"):
        w = state[f"{p}.fc6.weight"]
        fc6 = got["box_head.fc6.weight"].numpy()
        for h, x, ch in ((0, 0, 0), (2, 5, 7), (6, 6, 63)):
            np.testing.assert_array_equal(fc6[:, (h * 7 + x) * 64 + ch],
                                          w[:, ch * 49 + h * 7 + x])
    if kind == "mrcnn_gn":  # the imported model detects as JAX's
        rng = np.random.RandomState(1)
        images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
        sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
        jdet = jax_build(jcfg).make_eval_fn({"params": tree})(
            jnp.asarray(images), jnp.asarray(sizes))
        det = model.make_eval_fn()(torch.from_numpy(images),
                                   torch.from_numpy(sizes))
        assert int(det["valid"].sum()) > 0
        for k in ("labels", "valid"):
            np.testing.assert_array_equal(det[k].numpy(),
                                          np.asarray(jdet[k]), err_msg=k)
        np.testing.assert_allclose(det["boxes"].numpy(),
                                   np.asarray(jdet["boxes"]), rtol=0,
                                   atol=1e-3)


def test_rpn_only_c4_reference_checkpoint_import():
    """The C4 RPN-only model at the config's width (C4 1,024 channels,
    where the reference's RPN conv is the JAX package's fixed 1,024):
    every port tensor written from the file's tensor of its name, nothing
    skipped (the JAX package's importer does not reach a C4 body:
    ROADMAP section 3)."""
    cfg = _cfg(get_cfg, "rpn_c4")
    state = rl.seeded_state_dict(rl.layout(cfg), seed=5)
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, unwritten = ti.load_torch_state_dict(model.module, state)
    assert skipped == [] and unwritten == []
    got = model.module.state_dict()
    for key, value in state.items():
        np.testing.assert_array_equal(got[_c4_port_key(key)].numpy(), value,
                                      err_msg=key)


def test_c2_gn_pickle_lands_on_group_norm(tmp_path):
    """A Detectron GN ImageNet pickle (``conv1_gn_{s,b}``,
    ``res{s}_{b}_branch2{a,b,c}_gn_{s,b}``, ``res{s}_0_branch1_gn_{s,b}``:
    the GroupNorm affine, nothing folded) lands on the GN body's
    GroupNorms of the same place, as in the JAX package."""
    jcfg, cfg = _cfg(jax_get_cfg, "mrcnn_gn"), _cfg(get_cfg, "mrcnn_gn")
    body = {k: v for k, v in rl.seeded_state_dict(rl.layout(cfg), 7).items()
            if k.startswith("backbone.body.")}
    blobs = {}
    for key, value in body.items():
        name = rl.c2_body_name(key)
        name = name.replace("res_conv1_bn_", "conv1_gn_").replace(
            "_bn_", "_gn_")
        blobs[name] = value
    path = str(tmp_path / "R-50-GN.pkl")
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    model = build_detection_model(cfg, device="cpu", seed=1)
    skipped, _ = ti.load_c2_pickle(model.module, path)
    assert skipped == []
    resnet = model.module.backbone.resnet
    np.testing.assert_array_equal(resnet.stem.bn1.weight.detach().numpy(),
                                  blobs["conv1_gn_s"])
    np.testing.assert_array_equal(
        resnet.layer2_0.downsample_bn.bias.detach().numpy(),
        blobs["res3_0_branch1_gn_b"])
    tree = jti.load_c2_pickle(_jax_tree(jax_build(jcfg)), path)
    want = _port_layout(model, tree)
    for key, value in model.module.state_dict().items():
        if key.startswith("backbone.resnet."):
            torch.testing.assert_close(value, want[key], rtol=0, atol=0,
                                       msg=key)

"""FBNet in the PyTorch port against the JAX package, on the CPU in
float32: the architecture tables and their width arithmetic for all five
archs, the trunks of all five at a narrow SCALE_FACTOR, the blocks' forms
(a negative stride's upsample, the squeeze-excitation, the GN norm), and
e2e_faster_rcnn_fbnet / e2e_mask_rcnn_fbnet / the xirb16d_dsmask Mask
R-CNN at SCALE_FACTOR 0.25 (WIDTH_DIVISOR 8), 5 classes, 2 x 64 x 96:
the build, ``detect`` whole and one train step with the JAX package's
draws replayed, the JAX params from a numpy seed carried across by
``load_jax_params``.

Limits, those of the existing port tests for the same outputs
(tests/test_torch_port_c4.py, test_torch_port_two_stage_train.py):
integer outputs equal (tables, widths, anchors, valid, labels, sampled
anchors and rois, num_pos); features within 1e-4 of each tensor's
largest magnitude; detections' boxes within 1e-3 px, scores and masks
within 1e-4; a step's losses within 1e-4 relative, the applied
gradients within 1e-3 of each tensor's largest magnitude, updated
parameters within 1e-6; the 12 x 12 mask targets equal except where the
JAX package's crop lies within 1e-3 of 0.5.

As for MobileNetV2 (tests/test_torch_port_mobile.py), the JAX package's
solver misses FrozenBatchNorm under FBNet's scope name ``bn`` and trains
its four tensors; the port keeps them frozen (ROADMAP.md section 3). The
first step's other tensors still agree: both start from the same
statistics, and the update comparison leaves those out.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import fbnet as jfbnet
from paa_tpu.modeling import roi_mask_head as jax_mask_head
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling import fbnet
from paa_tpu_torch.modeling.layers import FrozenBatchNorm, GroupNorm32
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_mask import crop_gt_masks_raw, mask_batch, mask_loss_raw
from test_torch_port_model import _seeded_params
from test_torch_port_two_stage_train import (  # noqa: F401 (autouse)
    HW, _one_thread, assert_step_matches, cfgs, in_port_layout,
    roi_box_loss_with_samples, rpn_loss_with_masks, run_steps,
    two_stage_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(fbnet.FBNET_ARCHS)
CONFIGS = {
    "faster": "e2e_faster_rcnn_fbnet.yaml",
    "mask": "e2e_mask_rcnn_fbnet.yaml",
    "dsmask": "e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml",
}
NARROW = ["MODEL.FBNET.SCALE_FACTOR", 0.25,
          "MODEL.RPN.PRE_NMS_TOP_N_TEST", 100,
          "MODEL.RPN.POST_NMS_TOP_N_TEST", 20]


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


# ---- the tables -------------------------------------------------------------

def test_divisible_width_matches_jax():
    """Every width 0..400 at every divisor 0..16: py2's round-half-up,
    and a 0 rounding giving divisor * divisor."""
    for divisor in range(17):
        for width in range(401):
            assert fbnet.divisible_width(width, divisor) == \
                jfbnet.divisible_width(width, divisor), (width, divisor)
    assert fbnet.divisible_width(3, 8) == 64  # the `or min_val` quirk
    assert fbnet.divisible_width(12, 8) == 16  # 1.5 rounds up


@pytest.mark.parametrize("arch", ARCHS)
def test_tables_and_widths_match_jax(arch):
    """The port's own copy of each table, its expanded blocks per role,
    the roles' output channels at several scales and the trunk stride."""
    assert fbnet.FBNET_ARCHS[arch]["stages"] == \
        jfbnet.FBNET_ARCHS[arch]["stages"]
    for role in ("backbone", "rpn", "bbox", "mask"):
        if role not in jfbnet.FBNET_ARCHS[arch]:
            assert role not in fbnet.FBNET_ARCHS[arch]
            continue
        blocks = fbnet.expanded_blocks(fbnet.FBNET_ARCHS[arch], role)
        assert blocks == jfbnet.expanded_blocks(jfbnet.FBNET_ARCHS[arch],
                                                role)
        for ratio in (1.0, 0.5, 0.25, 0.3):
            for divisor in (1, 8):
                assert fbnet.fbnet_out_channels(arch, role, ratio, divisor) \
                    == jfbnet.fbnet_out_channels(arch, role, ratio, divisor)
    assert fbnet.fbnet_trunk_stride(arch) == \
        jfbnet.fbnet_trunk_stride(arch) == 16
    assert fbnet.OP_KERNEL == jfbnet._OP_KERNEL


# ---- modules ----------------------------------------------------------------

def _jax_module(module, x, seed=1):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(seed))
    return params, np.asarray(jax.jit(
        lambda p, xx: module.apply({"params": p}, xx))(params, x))


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_matches_jax(arch):
    """Each arch's trunk at SCALE_FACTOR 0.25, WIDTH_DIVISOR 8: one
    stride-16 map; cham_v1a's 7x7 and 5x5 depthwise convs among them."""
    x = np.random.RandomState(0).normal(0, 1, (2, *HW, 3)).astype(
        np.float32)
    jtrunk = jfbnet.FBNetTrunk(arch=arch, width_ratio=0.25, width_divisor=8)
    shapes = jax.eval_shape(lambda: jtrunk.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(1))
    want = jax.jit(lambda p, xx: jtrunk.apply({"params": p}, xx))(params, x)
    trunk = load_jax_params(fbnet.FBNetTrunk(arch, 0.25, 8), params)
    with torch.no_grad():
        got = trunk(_nchw(x))
    assert len(got) == len(want) == 1
    assert got[0].shape[1] == trunk.out_channels == \
        fbnet.fbnet_out_channels(arch, "backbone", 0.25, 8)
    assert tuple(got[0].shape[2:]) == (4, 6)
    _close(_nhwc(got[0]), want[0], 1e-4)


@pytest.mark.parametrize("stride,se,bn_type", [
    (-2, False, "bn"), (2, True, "bn"), (1, False, "gn"), (-2, True, "gn")])
def test_irf_block_forms_match_jax(stride, se, bn_type):
    """The x2 upsample before a stride-1 depthwise conv, the
    squeeze-excitation (no shipped arch sets it), GN norms (K3's plain
    version: relu after pw, none after pwl), the residual."""
    x = np.random.RandomState(2).normal(0, 1, (2, 6, 8, 64)).astype(
        np.float32)
    jblock = jfbnet.IRFBlock(out_channels=64, expansion=2, stride=stride,
                             kernel=5, width_divisor=8, se=se,
                             bn_type=bn_type)
    params, want = _jax_module(jblock, x)
    block = load_jax_params(fbnet.IRFBlock(
        64, 64, 2, stride, kernel=5, width_divisor=8, bn_type=bn_type,
        se=se), params)
    assert block.use_res == (stride == 1)
    if bn_type == "gn":
        assert block.pw.gn.relu and not block.pwl.gn.relu
        assert isinstance(block.pw.gn, GroupNorm32)
    with torch.no_grad():
        got = block(_nchw(x))
    _close(_nhwc(got), want, 1e-4)


def _rois(seed, n):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, 80, (n, 2)).astype(np.float32)
    wh = rng.uniform(0.5, 60, (n, 2)).astype(np.float32)
    return (np.concatenate([xy, xy + wh], 1),
            rng.randint(0, 2, n).astype(np.int32))


@pytest.mark.parametrize("arch,use_deconv", [
    ("default", False), ("xirb16d_dsmask", False), ("default", True)])
def test_heads_match_jax(arch, use_deconv):
    """The RPN head, the box head (6 x 6 pools, the f32 mean and
    predictors) and the mask head (its stages upsample to 12; the 2x2
    deconv to 24 with another PREDICTOR) on a stride-16 map."""
    rng = np.random.RandomState(3)
    c = fbnet.fbnet_out_channels(arch, "backbone", 0.25, 8)
    feat = rng.normal(size=(2, 4, 6, c)).astype(np.float32)
    rois, bidx = _rois(4, 12)
    widths = dict(width_ratio=0.25, width_divisor=8)
    jargs = ([jnp.asarray(feat)], jnp.asarray(rois), jnp.asarray(bidx))
    args = ([_nchw(feat)], torch.from_numpy(rois),
            torch.from_numpy(bidx).long())
    for jhead, head, call in (
            (jfbnet.FBNetROIBoxHead(arch=arch, num_classes=5, resolution=6,
                                    **widths),
             fbnet.FBNetROIBoxHead(arch, c, 5, resolution=6, **widths),
             lambda m, a: m(*a)),
            (jfbnet.FBNetMaskHead(arch=arch, num_classes=4, resolution=6,
                                  use_deconv=use_deconv, **widths),
             fbnet.FBNetMaskHead(arch, c, 4, resolution=6,
                                 use_deconv=use_deconv, **widths),
             lambda m, a: (m(*a),)),
            (jfbnet.FBNetRPNHead(arch=arch, num_anchors=15, **widths),
             fbnet.FBNetRPNHead(arch, c, 15, **widths),
             lambda m, a: tuple(m(a[0]).values()))):
        is_rpn = isinstance(head, fbnet.FBNetRPNHead)
        jin = jargs[:1] if is_rpn else jargs
        shapes = jax.eval_shape(lambda: jhead.init(
            jax.random.PRNGKey(0), *jin))["params"]
        params = _seeded_params(shapes, rng)
        want = jhead.apply({"params": params}, *jin)
        want = tuple(want.values()) if is_rpn else (
            want if isinstance(want, tuple) else (want,))
        load_jax_params(head, params)
        with torch.no_grad():
            got = call(head, args)
        for g, w in zip(got, want):
            g = g.numpy() if g.dim() != 4 else _nhwc(g)
            _close(g, w, 1e-4)
        if isinstance(head, fbnet.FBNetMaskHead):
            assert got[0].shape[-1] == (24 if use_deconv else 12)
            assert got[0].dtype == torch.float32


# ---- the models -------------------------------------------------------------

def fbnet_params(shapes, rng):
    """``_seeded_params`` with the RPN's and the box predictors' kernels
    at their init's std (normal(0.01); bbox_pred normal(0.001)) and zero
    biases: at the kaiming scale the RPN's deltas clip the proposals
    flat, as tests/test_torch_port_two_stage_train.py's
    ``two_stage_params`` notes for R-50-FPN."""
    params = _seeded_params(shapes, rng)
    for head, layer, std in (("rpn_head", "cls_logits", 0.01),
                             ("rpn_head", "bbox_pred", 0.01),
                             ("box_head", "cls_score", 0.01),
                             ("box_head", "bbox_pred", 0.001)):
        leaves = params[head][layer]
        leaves["kernel"] = rng.normal(0, std, leaves["kernel"].shape
                                      ).astype(np.float32)
        leaves["bias"] = np.zeros_like(leaves["bias"])
    return params


def _cfgs(kind):
    return cfgs(os.path.join(ROOT, "configs", CONFIGS[kind]), NARROW)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    jcfg, cfg = _cfgs(request.param)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = fbnet_params(shapes, np.random.RandomState(0))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return request.param, jmodel, params, model


def test_fbnet_build_matches_jax(models):
    """One stride-16 level with 15 anchors per location, the trunk, RPN,
    box and mask heads of the arch; every tensor written from the JAX
    tree; no keypoint head."""
    kind, jmodel, params, model = models
    assert model.strides == jmodel.strides == (16,)
    anchors, counts = model.anchors_for(HW)
    want, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want)
    assert list(counts) == list(want_counts) == [4 * 6 * 15]
    m = model.module
    assert isinstance(m.backbone.body, fbnet.FBNetTrunk)
    assert (m.mask_head is None) == (kind == "faster")
    if m.mask_head is not None:
        assert m.mask_head.conv5_mask is None  # MaskRCNNConv1x1Predictor
    assert sum(v.size for v in jax.tree.leaves(params)) == sum(
        v.numel() for v in m.state_dict().values())


def test_fbnet_detect_matches_jax(models):
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
    assert ("masks" in got) == (kind != "faster")
    if kind != "faster":
        assert got["masks"].shape == (2, 10, 12, 12)
        np.testing.assert_allclose(got["masks"].numpy(),
                                   np.asarray(want["masks"]), rtol=0,
                                   atol=1e-4)


def _frozen_bn(module):
    return {f"{n}.{leaf}" for n, m in module.named_modules()
            if isinstance(m, FrozenBatchNorm)
            for leaf in ("weight", "bias", "running_mean", "running_var")}


@pytest.fixture(scope="module", params=["faster", "dsmask"])
def step(request):
    kind = request.param
    jcfg, cfg = _cfgs(kind)
    patches = [(jax_two_stage, "rpn_loss", rpn_loss_with_masks),
               (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples)]
    if kind == "faster":
        batch = two_stage_batch(2)
    else:
        batch = mask_batch(2)
        patches += [(jax_mask_head, "crop_gt_masks_for_rois",
                     crop_gt_masks_raw),
                    (jax_mask_head, "mask_loss", mask_loss_raw)]
    model, out = run_steps(jcfg, cfg, batch, 1, patches=patches,
                           seeded=fbnet_params)
    return kind, batch, model, out[0]


def test_fbnet_train_step_matches_jax(step):
    """One step of FBNet Faster R-CNN and of the xirb16d_dsmask Mask
    R-CNN: the sampled anchors and rois, num_pos and the losses; the 12 x
    12 mask targets; the gradients and the update of every tensor the
    port trains (the whole net: no stage of FBNet is frozen)."""
    kind, batch, model, out = step
    losses = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
              "loss_box_reg", "loss") + (() if kind == "faster" else
                                         ("loss_mask",))
    assert_step_matches(out["port"], out["jax"], batch, losses=losses)
    if kind != "faster":
        raw = out["jax"]["metrics"]["mask_raw"]
        assert raw.shape[-1] == 12
        targets = out["port"]["metrics"]["mask_targets"].reshape(raw.shape)
        near = np.abs(raw - 0.5) <= 1e-3
        np.testing.assert_array_equal(
            targets[~near], out["jax"]["metrics"]["mask_targets"][~near])
    want = in_port_layout(model, out["jax"]["grads"])
    got = out["port"]["grads"]
    frozen = _frozen_bn(model.module)
    assert len(got) > 60 and not set(got) & frozen
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    after = in_port_layout(model, out["jax"]["params"])
    for name, p in out["port"]["params"].items():
        np.testing.assert_allclose(p.numpy(), after[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert model.module.rpn_head.rpn_stages.block0.pw.conv.weight.grad \
        .abs().sum() > 0

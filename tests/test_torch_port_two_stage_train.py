"""Faster R-CNN training in the PyTorch port against the JAX package, on
the CPU, at the narrow config of tests/test_torch_port_two_stage.py
(R-50-FPN, BACKBONE_OUT_CHANNELS 64, 5 classes, MLP 64, 2 x 64 x 96
uint8 input) with a short RPN (PRE/POST/FPN_POST_NMS_TOP_N_TRAIN 100 /
50 / 100) and 64 rois per image, float32, the JAX params carried across
by ``load_jax_params``.

The sampler's draws: the JAX package draws its uniforms with
``jax.random`` (``fold_in(PRNGKey(TPU.SEED), step)``, split per image
for the RPN, and ``split(fold_in(rng, 1), B)`` for the rois, each image
splitting again for its positives and negatives). The port takes
uniforms as an argument; here ``replay_draws`` derives the same keys
with ``jax.random`` and hands the port the same uniforms, so that the
port's own selection (``balanced_sample``: masked priorities, top-k
with ties to the lower index) is what is compared.

Tolerances, each with its reason:
- integer outputs equal: sampled anchor and roi masks, labels, rois'
  GT indices, ``num_pos``;
- pieces fed the same inputs: the RPN's and the box head's losses
  within 1e-6 relative (the same float32 sums, in another order), their
  gradients within 1e-6 of each tensor's largest magnitude; rois and
  matched boxes equal, regression targets within 1e-5 (log and divide);
- whole steps: losses within 1e-4 relative (the forwards agree to 1e-4
  of each tensor's largest magnitude, tests/test_torch_port_two_stage.py),
  the gradient each step applied within 1e-3 of each tensor's largest
  magnitude (the box head's float32 fc6 sums 3,136 products, and the
  gradients of the RPN and the box head meet in the FPN), parameters
  after the update within 1e-6 absolute; the losses of the second and
  third steps, from parameters that already differ by that much, within
  1e-3 relative; in the first step, the regression targets (which
  identify the GT each roi matched) of the rois at least 2 px wide and
  high within 1e-3 of the largest (``later_step_tolerances``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import two_stage as jax_two_stage
from paa_tpu.modeling.matcher import match_anchors as jax_match_anchors
from paa_tpu.modeling.roi_box_head import ROIBoxConfig as JROIBoxConfig
from paa_tpu.modeling.roi_box_head import roi_box_loss as jax_roi_box_loss
from paa_tpu.modeling.roi_box_head import (
    subsample_proposals as jax_subsample)
from paa_tpu.modeling.rpn import RPNConfig as JRPNConfig
from paa_tpu.modeling.rpn import balanced_sample as jax_balanced_sample
from paa_tpu.modeling.rpn import rpn_loss as jax_rpn_loss
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.structures.boxes import box_iou as jax_box_iou
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.box_coder import encode_box
from paa_tpu_torch.modeling.roi_box_head import (
    ROIBoxConfig, roi_box_loss, sampling_width, subsample_proposals)
from paa_tpu_torch.modeling.rpn import (
    RPNConfig, balanced_sample, rpn_labels, rpn_loss)
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import _seeded_params
from test_torch_port_train import _applied_gradients, _to_np
from test_torch_port_two_stage import CONFIG
from test_torch_port_two_stage import OVERRIDES as MODEL_OVERRIDES

HW = (64, 96)
SEED = 0
TRAIN = [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 100,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 50,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 100,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
    "SOLVER.BASE_LR", 0.001,
    "SOLVER.WEIGHT_DECAY", 1e-4,
    "SOLVER.WARMUP_METHOD", "constant",
    "TPU.SEED", SEED,
]
STEPS = 3


def cfgs(config=CONFIG, extra=()):
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(config)
        cfg.merge_from_list(MODEL_OVERRIDES + TRAIN + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_uniforms(key, rows, n):
    """The uniforms ``balanced_sample`` draws from each row's key of
    ``split(key, rows)``: (u_pos, u_neg), each (rows, n)."""
    keys = jax.random.split(key, rows)
    pairs = [jax.random.split(k) for k in keys]
    return tuple(_t(np.stack([np.asarray(jax.random.uniform(p[j], (n,)))
                              for p in pairs])) for j in (0, 1))


def replay_draws(seed):
    """The port's ``draws(step)`` that replays the JAX package's keys:
    "rpn" from ``fold_in(PRNGKey(seed), step)``, "roi" from its
    ``fold_in(., 1)``."""
    def draws(step):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)

        def draw(name, shape):
            base = rng if name == "rpn" else jax.random.fold_in(rng, 1)
            return jax_uniforms(base, *shape)

        return draw

    return draws


def jax_rpn_masks(gt_boxes, gt_labels, anchors, rc, rng, image_sizes):
    """The JAX package's RPN labels and sampled masks, as its rpn_loss
    computes them (paa_tpu/modeling/rpn.py:201-254)."""
    matched = jax_match_anchors(
        jax_box_iou(gt_boxes.astype(jnp.float32), anchors[None]),
        gt_labels > 0, rc.fg_iou_threshold, rc.bg_iou_threshold,
        allow_low_quality_matches=True)
    labels = jnp.where(matched >= 0, 1,
                       jnp.where(matched == -2, -1, 0)).astype(jnp.int32)
    st = rc.straddle_thresh
    h = image_sizes[:, 0:1].astype(jnp.float32)
    w = image_sizes[:, 1:2].astype(jnp.float32)
    visible = ((anchors[None, :, 0] >= -st) & (anchors[None, :, 1] >= -st)
               & (anchors[None, :, 2] < w + st)
               & (anchors[None, :, 3] < h + st))
    labels = jnp.where(visible, labels, -1)
    pos, neg = jax.vmap(lambda lab, r: jax_balanced_sample(
        lab, r, rc.batch_size_per_image, rc.positive_fraction))(
        labels, jax.random.split(rng, labels.shape[0]))
    return labels, pos, neg


def rpn_loss_with_masks(outputs, gt_boxes, gt_labels, anchors, counts, rc,
                        rng, num_shards=1, image_sizes=None):
    """The JAX package's rpn_loss, with its sampled masks beside."""
    out = jax_rpn_loss(outputs, gt_boxes, gt_labels, anchors, counts, rc,
                       rng, num_shards, image_sizes=image_sizes)
    _, pos, neg = jax_rpn_masks(gt_boxes, gt_labels, anchors, rc, rng,
                                image_sizes)
    return {**out, "rpn_pos": pos, "rpn_neg": neg}


def roi_box_loss_with_samples(cls_logits, box_deltas, roi_labels,
                              reg_targets, roi_valid):
    """The JAX package's roi_box_loss, with the sampled rois' labels,
    validity and regression targets (the encoding of each roi's matched
    GT box) beside."""
    out = jax_roi_box_loss(cls_logits, box_deltas, roi_labels, reg_targets,
                           roi_valid)
    return {**out, "roi_labels": roi_labels, "roi_valid": roi_valid,
            "reg_targets": reg_targets}


# ---- the sampler ----------------------------------------------------------

def _sampler_labels(case):
    """(3, 600) labels: ``caps`` many positives and negatives (both caps
    bind), ``few_pos`` 20 positives (negatives fill the rest), ``ignore``
    a row of ignored anchors and a row without positives."""
    rng = np.random.RandomState(11)
    if case == "caps":
        return rng.choice([-1, 0, 1, 3], (3, 600), p=[.2, .4, .3, .1])
    if case == "few_pos":
        lab = rng.choice([-1, 0], (3, 600), p=[.5, .5])
        lab[:, rng.choice(600, 20, replace=False)] = 2
        return lab
    lab = rng.choice([-1, 0, 1], (3, 600))
    lab[0] = -1
    lab[1][lab[1] > 0] = 0
    return lab


@pytest.mark.parametrize("case", ["caps", "few_pos", "ignore"])
@pytest.mark.parametrize("batch,fraction", [(256, 0.5), (64, 0.25)])
def test_balanced_sample_matches_jax(case, batch, fraction):
    labels = _sampler_labels(case).astype(np.int32)
    key = jax.random.PRNGKey(4)
    want = jax.vmap(lambda lab, r: jax_balanced_sample(
        lab, r, batch, fraction))(jnp.asarray(labels),
                                  jax.random.split(key, 3))
    got = balanced_sample(_t(labels), *jax_uniforms(key, 3, 600), batch,
                          fraction)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pos, neg = (g.numpy() for g in got)
    assert (pos.sum(1) <= int(batch * fraction)).all()
    assert ((pos | neg).sum(1) <= batch).all()
    if case == "ignore":
        assert not (pos[0] | neg[0]).any() and not pos[1].any()
        assert neg[1].sum() == min(batch, (labels[1] == 0).sum())


# ---- the RPN loss -----------------------------------------------------------

def _rpn_case(anchors_np):
    """Random RPN outputs over the anchors, GTs for image 0 (two of them,
    one at the padded border) and none for image 1, whose true size is
    smaller than the padded input: anchors straddling it are ignored."""
    rng = np.random.RandomState(12)
    n = len(anchors_np)
    outputs = {"objectness": rng.normal(0, 2, (2, n)).astype(np.float32),
               "box_regression": rng.normal(0, 0.3, (2, n, 4)).astype(
                   np.float32)}
    gt_boxes = np.zeros((2, 3, 4), np.float32)
    gt_boxes[0, :2] = [[10, 8, 50, 40], [60, 30, 95, 63]]
    gt_labels = np.asarray([[2, 4, 0], [0, 0, 0]], np.int32)
    sizes = np.asarray([[64, 96], [50, 70]], np.float32)
    return outputs, gt_boxes, gt_labels, sizes


@pytest.fixture(scope="module")
def narrow():
    jcfg, cfg = cfgs()
    jmodel = jax_build(jcfg)
    model = build_detection_model(cfg, device="cpu")
    return jcfg, jmodel, cfg, model


def test_rpn_loss_labels_and_gradients_match_jax(narrow):
    jcfg, jmodel, cfg, model = narrow
    anchors_np, counts = jmodel.anchors_for(HW)
    outputs, gt_boxes, gt_labels, sizes = _rpn_case(anchors_np)
    jrc = JRPNConfig.from_cfg(jcfg, is_train=True)
    rc = RPNConfig.from_cfg(cfg, is_train=True)
    key = jax.random.PRNGKey(7)
    anchors_j = jnp.asarray(anchors_np, jnp.float32)

    def jloss(o):
        out = jax_rpn_loss(o, jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                           anchors_j, counts, jrc, key,
                           image_sizes=jnp.asarray(sizes))
        return out["loss_objectness"] + out["loss_rpn_box_reg"], out

    jo = {k: jnp.asarray(v) for k, v in outputs.items()}
    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jo)
    jlabels, jpos, jneg = jax_rpn_masks(
        jnp.asarray(gt_boxes), jnp.asarray(gt_labels), anchors_j, jrc, key,
        jnp.asarray(sizes))

    to = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    anchors = _t(anchors_np).float()
    labels, _ = rpn_labels(_t(gt_boxes), _t(gt_labels), anchors, rc,
                           _t(sizes))
    got = rpn_loss(to, _t(gt_boxes), _t(gt_labels), anchors, rc,
                   jax_uniforms(key, 2, len(anchors_np)),
                   image_sizes=_t(sizes), return_aux=True)
    (got["loss_objectness"] + got["loss_rpn_box_reg"]).backward()

    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    lab = labels.numpy()
    assert (lab[1] == 1).sum() == 0 and (lab[1] == 0).sum() > 0
    assert (lab[1] == -1).sum() > (lab[0] == -1).sum()  # the straddlers
    np.testing.assert_array_equal(got["rpn_pos"].numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(got["rpn_neg"].numpy(), np.asarray(jneg))
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in ("loss_objectness", "loss_rpn_box_reg"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    for k, g in jgrad.items():
        w = np.asarray(g)
        np.testing.assert_allclose(to[k].grad.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


# ---- the roi sampler and the box loss --------------------------------------

def _proposal_case(k):
    """Proposals around two GTs of image 0 (some at IoU >= 0.5), random
    ones elsewhere, the last quarter invalid; image 1 has one GT."""
    rng = np.random.RandomState(13)
    gt_boxes = np.zeros((2, 4, 4), np.float32)
    gt_boxes[0, :2] = [[10, 8, 50, 40], [60, 30, 95, 63]]
    gt_boxes[1, 0] = [20, 20, 70, 60]
    gt_labels = np.asarray([[1, 3, 0, 0], [4, 0, 0, 0]], np.int32)
    props = np.empty((2, k, 4), np.float32)
    for b in range(2):
        centre = gt_boxes[b, rng.randint(0, 2 - b, k)]
        jitter = rng.normal(0, 6, (k, 4))
        props[b] = np.where(rng.rand(k, 1) < 0.6, centre + jitter,
                            rng.uniform(0, 90, (k, 4)))
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 1)
    valid = np.ones((2, k), bool)
    valid[:, -k // 4:] = False
    return props, valid, gt_boxes, gt_labels


@pytest.mark.parametrize("k,batch", [(100, 64), (30, 512)])
def test_subsample_proposals_matches_jax(k, batch):
    """k=100 draws 64 of 104 candidates; k=30 pads the candidates with
    invalid slots to the 512 the draw needs (the JAX package's
    deficit)."""
    props, valid, gt_boxes, gt_labels = _proposal_case(k)
    jbc = JROIBoxConfig(num_classes=5, batch_size_per_image=batch)
    bc = ROIBoxConfig(num_classes=5, batch_size_per_image=batch)
    key = jax.random.PRNGKey(9)
    want = jax.vmap(lambda p, v, gb, gl, r: jax_subsample(
        p, v, gb, gl, jbc, r))(
        *map(jnp.asarray, (props, valid, gt_boxes, gt_labels)),
        jax.random.split(key, 2))
    width = sampling_width(k, 4, bc)
    got = subsample_proposals(*map(_t, (props, valid, gt_boxes, gt_labels)),
                              bc, jax_uniforms(key, 2, width))
    names = ("rois", "roi_labels", "reg_targets", "roi_valid", "roi_gt_idx",
             "matched_boxes")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        if name == "reg_targets":
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    labels, roi_valid = got[1].numpy(), got[3].numpy()
    assert (labels > 0).any() and ((labels == 0) & roi_valid).any()
    assert (labels[~roi_valid] == -1).all()


def test_roi_box_loss_and_gradients_match_jax():
    rng = np.random.RandomState(14)
    r, c = 40, 5
    cls = rng.normal(0, 2, (r, c)).astype(np.float32)
    deltas = rng.normal(0, 1, (r, c, 4)).astype(np.float32)
    labels = rng.randint(-1, c, r).astype(np.int32)
    targets = rng.normal(0, 1, (r, 4)).astype(np.float32)
    valid = rng.rand(r) < 0.8

    def jloss(cl, de):
        out = jax_roi_box_loss(cl, de, jnp.asarray(labels),
                               jnp.asarray(targets), jnp.asarray(valid))
        return out["loss_classifier"] + out["loss_box_reg"], out

    (_, want), (gc, gd) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(cls), jnp.asarray(deltas))
    tc, td = _t(cls).requires_grad_(), _t(deltas).requires_grad_()
    got = roi_box_loss(tc, td, _t(labels), _t(targets), _t(valid))
    (got["loss_classifier"] + got["loss_box_reg"]).backward()
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-6)
    for g, w in ((tc.grad, gc), (td.grad, gd)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())


# ---- whole train steps -----------------------------------------------------

def two_stage_batch(seed, num_classes=5, bsz=2, max_gt=4):
    """uint8 images (content 64x96 and 60x90), 3 and 2 valid GTs of
    20-50 px, labels 1..num_classes - 1, the other slots padding."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)[:bsz]
    gt_boxes = np.zeros((bsz, max_gt, 4), np.float32)
    gt_labels = np.zeros((bsz, max_gt), np.int32)
    for b, n in zip(range(bsz), (3, 2)):
        xy = rng.uniform(0, 40, (n, 2))
        wh = rng.uniform(20, 50, (n, 2))
        box = np.concatenate([xy, xy + wh], axis=1)
        box[:, 2] = np.minimum(box[:, 2], sizes[b, 1] - 1)
        box[:, 3] = np.minimum(box[:, 3], sizes[b, 0] - 1)
        gt_boxes[b, :n] = box
        gt_labels[b, :n] = rng.randint(1, num_classes, n)
    return {"images": images, "image_sizes": sizes, "gt_boxes": gt_boxes,
            "gt_labels": gt_labels}


def two_stage_params(shapes, rng):
    """``_seeded_params`` with the RPN head and the box predictors at the
    scale of their init (normal(0.01), cls_score normal(0.01), bbox_pred
    normal(0.001), biases 0): at the kaiming scale of the seeded body
    the RPN's deltas reach ~400 and both packages' box losses are NaN
    from the first step."""
    params = _seeded_params(shapes, rng)
    stds = {("rpn_head", "conv"): 0.01, ("rpn_head", "cls_logits"): 0.01,
            ("rpn_head", "bbox_pred"): 0.01,
            ("box_head", "cls_score"): 0.01,
            ("box_head", "bbox_pred"): 0.001}
    for (head, layer), std in stds.items():
        leaves = params[head][layer]
        leaves["kernel"] = rng.normal(0, std, leaves["kernel"].shape
                                      ).astype(np.float32)
        leaves["bias"] = np.zeros_like(leaves["bias"])
    return params


def run_steps(jcfg, cfg, batch, steps, patches=(),
              seeded=two_stage_params):
    """``steps`` steps of each package from the same seeded params
    (``seeded(shapes, rng)``) and batch, through each
    ``make_bucket_train_step`` (the JAX package's jitted, with
    ``patches`` (module, name, function) applied while it traces and
    runs; the port's with ``replay_draws`` and ``return_aux``). Per
    step: each side's metrics, the port's applied gradients and
    parameters, the JAX parameters; for the first step also the JAX
    gradients."""
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = seeded(shapes, np.random.RandomState(0))
    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    step = model.make_bucket_train_step(HW, draws=replay_draws(SEED),
                                        return_aux=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for module, name, fn in patches:
            mp.setattr(module, name, fn)
        jstep = jax.jit(jmodel.make_bucket_train_step(
            HW, param_label_tree=labels))
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
                                    model.module.named_parameters()}},
            })
            if i == 0:
                out[0]["jax"]["grads"] = _applied_gradients(
                    jstate.opt_state, jparams, labels, jcfg)
    return model, out


def in_port_layout(model, tree):
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree)
    return dict(scratch.module.state_dict())


LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier",
          "loss_box_reg", "loss")


def assert_step_matches(got, want, batch, losses=LOSSES, rtol=1e-4,
                        match_targets=True):
    """Sampled masks and num_pos equal; with ``match_targets`` the GT
    each roi at least 2 px wide and high matched is the JAX package's:
    its regression targets within 1e-3 of the largest (the rois are
    proposals that agree to ~1e-4 px); losses within ``rtol``."""
    g, w = got["metrics"], want["metrics"]
    assert int(g["num_pos"]) == int(w["num_pos"]) > 0
    for k in ("rpn_pos", "rpn_neg"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    np.testing.assert_array_equal(g["roi_labels"].reshape(-1),
                                  w["roi_labels"])
    np.testing.assert_array_equal(g["roi_valid"].reshape(-1),
                                  w["roi_valid"])
    assert (g["roi_labels"] > 0).any()
    for k in losses:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    if not match_targets:
        return
    gt = torch.from_numpy(batch["gt_boxes"])
    idx = torch.from_numpy(g["roi_gt_idx"])
    rois = torch.from_numpy(g["rois"])
    matched = gt.gather(1, idx[..., None].expand(*idx.shape, 4))
    targets = encode_box(matched, rois, weights=(10.0, 10.0, 5.0, 5.0))
    # a roi under 2 px (a proposal clipped flat at the image's edge) turns
    # its ~1e-4 px difference into any difference of its targets
    wide = ((rois[..., 2:] - rois[..., :2] + 1) >= 2).all(-1).reshape(-1)
    want_targets = w["reg_targets"][wide.numpy()]
    assert int(wide.sum()) >= 16  # the check is not vacuous
    np.testing.assert_allclose(targets.reshape(-1, 4)[wide].numpy(),
                               want_targets, rtol=0,
                               atol=1e-3 * np.abs(want_targets).max())


def later_step_tolerances(i):
    """``assert_step_matches``' limits for step ``i``: after the first
    update the parameters differ by ~1e-6, the losses agree within 1e-3
    and the proposals to ~0.5 px on the smallest boxes, whose targets
    (1 / width, log(width)) amplify it: those steps compare the sampled
    labels and validity, not the targets."""
    return {"rtol": 1e-4} if i == 0 else \
        {"rtol": 1e-3, "match_targets": False}


def assert_gradients_and_update_match(model, step, zero=None,
                                      min_tensors=60):
    """The gradient each package applied within 1e-3 of each tensor's
    largest magnitude (over more than ``min_tensors`` trained tensors),
    the updated parameters within 1e-6. ``zero``:
    {name: scale name} of tensors whose gradient is 0 exactly (a sum
    that cancels), so that both sides' are rounding: each held within
    1e-6 of the largest gradient magnitude of its scale tensor."""
    want = in_port_layout(model, step["jax"]["grads"])
    got = step["port"]["grads"]
    assert len(got) > min_tensors
    for name, g in got.items():
        w = want[name].numpy()
        if name in (zero or {}):
            scale = np.abs(want[zero[name]].numpy()).max()
            assert max(np.abs(w).max(), float(g.abs().max())) <= \
                1e-6 * scale, name
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(),
                                   err_msg=name)
    want = in_port_layout(model, step["jax"]["params"])
    for name, p in step["port"]["params"].items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg = cfgs()
    batch = two_stage_batch(2)
    return batch, *run_steps(jcfg, cfg, batch, STEPS, patches=(
        (jax_two_stage, "rpn_loss", rpn_loss_with_masks),
        (jax_two_stage, "roi_box_loss", roi_box_loss_with_samples)))


def test_first_step_samples_and_losses_match_jax(runs):
    batch, _, out = runs
    assert_step_matches(out[0]["port"], out[0]["jax"], batch)


def test_first_step_gradients_and_update_match_jax(runs):
    _, model, out = runs
    assert_gradients_and_update_match(model, out[0])


def test_three_steps_match_jax(runs):
    """Each step draws anew (the step folds into the key: at this size
    every background anchor is sampled, but the rois differ) and samples
    the same anchors and rois on both sides; the losses move."""
    batch, _, out = runs
    for i, step in enumerate(out):
        assert_step_matches(step["port"], step["jax"], batch,
                            **later_step_tolerances(i))
    assert not np.array_equal(out[0]["port"]["metrics"]["rois"],
                              out[1]["port"]["metrics"]["rois"])
    losses = [float(s["port"]["metrics"]["loss"]) for s in out]
    assert len(set(losses)) == STEPS and all(np.isfinite(losses))


def test_default_draws_repeat_per_step(narrow):
    """Without injected draws the uniforms come from TPU.SEED, the step
    and the rank: the same step draws the same, another step not."""
    from paa_tpu_torch.modeling.two_stage import seeded_draws

    a = seeded_draws(0, 5, "cpu")("rpn", (2, 7))
    b = seeded_draws(0, 5, "cpu")("rpn", (2, 7))
    c = seeded_draws(0, 6, "cpu")("rpn", (2, 7))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert float(a[0].min()) >= 0 and float(a[0].max()) < 1

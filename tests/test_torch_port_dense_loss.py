"""The ATSS, FCOS and RetinaNet training losses of the PyTorch port
against the JAX package, in float32 on the CPU: each assignment
(``atss_assign``, ``ssc_assign``, ``iou_assign``, ``fcos_assign``,
RetinaNet's matcher) and each loss with its gradients with respect to
the head outputs. Inputs come from numpy seeds and go through both.

The GT batch holds the edge cases: an image with no GT, a GT partly
off the image and a GT smaller than a stride that lies between the
anchor centres, two identical GTs of different classes, and beside them
GTs of every level's size. ``test_atss_threshold_tie_matches_jax``
places two candidates whose IoU is exactly the mean + std threshold.

Integer outputs are equal: labels, matched or assigned GTs, num_pos.
Floats, with the limits of tests/test_torch_port_loss.py: the losses
within 1e-5 relative (sums over every anchor and class in different
orders), their gradients within 1e-5 of each tensor's largest magnitude,
FCOS's regression targets within 1e-6 relative (the same float32
subtractions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.modeling import atss_loss as jatss
from paa_tpu.modeling import fcos_loss as jfcos
from paa_tpu.modeling import retinanet_head as jretina
from paa_tpu_torch.modeling import atss_loss as tatss
from paa_tpu_torch.modeling import fcos_loss as tfcos
from paa_tpu_torch.modeling import retinanet_head as tretina
from paa_tpu_torch.modeling.anchors import AnchorGenerator, LocationGenerator
from test_torch_port_loss import _close, _equal, _np, _t
from test_torch_port_train import _one_thread  # noqa: F401 (autouse)

# the levels of a 64 x 96 input at strides 8-128
LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
STRIDES = (8, 16, 32, 64, 128)
C = 6


def _gts():
    """(B=4, G=5) GT slots: image 0 with four GTs of different sizes (the
    last 5 x 4 px, between anchor centres); image 1 with none; image 2
    with a GT partly off the image and a large one; image 3 with two
    identical GTs of classes 2 and 5 and a third."""
    gt_boxes = np.zeros((4, 5, 4), np.float32)
    gt_labels = np.zeros((4, 5), np.int32)
    gt_boxes[0, :4] = [[6, 6, 40, 44], [30, 20, 90, 60], [50, 8, 80, 38],
                       [18.5, 37.5, 23.5, 41.5]]
    gt_labels[0, :4] = [1, 3, 2, 6]
    gt_boxes[2, :2] = [[-20, -12, 14, 18], [2, 4, 93, 61]]
    gt_labels[2, :2] = [4, 1]
    gt_boxes[3, :3] = [[20, 10, 70, 50], [20, 10, 70, 50], [60, 30, 95, 62]]
    gt_labels[3, :3] = [2, 5, 3]
    return gt_boxes, gt_labels


def _anchors(num_ratios_scales=1):
    """ATSS's one anchor per location (8 strides wide), or RetinaNet's
    nine (3 ratios x 3 octave scales of 4 strides)."""
    if num_ratios_scales == 1:
        gen = AnchorGenerator(tuple((8 * s,) for s in STRIDES), (1.0,),
                              STRIDES)
    else:
        sizes = tuple(tuple(4 * s * 2 ** (i / 3) for i in range(3))
                      for s in STRIDES)
        gen = AnchorGenerator(sizes, (0.5, 1.0, 2.0), STRIDES)
    return gen(LEVELS)


def _outputs(seed, n, branch=True, ltrb=False):
    rng = np.random.RandomState(seed)
    out = {"cls_logits": rng.normal(-3, 1.5, (4, n, C)).astype(np.float32)}
    if ltrb:  # exp/relu outputs of FCOS's head: positive distances
        out["box_regression"] = np.exp(
            rng.normal(1.5, 0.8, (4, n, 4))).astype(np.float32)
    else:
        out["box_regression"] = rng.normal(0, 0.4, (4, n, 4)).astype(
            np.float32)
    if branch:
        out["iou_pred"] = rng.normal(0, 1, (4, n)).astype(np.float32)
    return out


def _compare(jloss, tloss, outputs, gt_boxes, gt_labels, anchors, counts,
             jlc, lc):
    """Losses and their gradients (jax.value_and_grad, jitted) of both
    packages' loss functions; returns the port's losses."""
    def total(outs):
        losses = jloss(outs, jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                       jnp.asarray(anchors), counts, jlc)
        return sum(v for k, v in losses.items() if k.startswith("loss_")), \
            losses

    (_, want), want_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    outs = {k: _t(v).requires_grad_(True) for k, v in outputs.items()}
    got = tloss(outs, _t(gt_boxes), _t(gt_labels), _t(anchors), counts, lc)
    sum(v for k, v in got.items() if k.startswith("loss_")).backward()

    assert set(got) == set(want)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 0
    for k in want:
        if k.startswith("loss_"):
            _close(got[k], want[k], rtol=1e-5, atol=1e-7, what=k)
    for k, g in want_grads.items():
        g = np.asarray(g)
        if outs[k].grad is None:  # no loss reads it
            assert not g.any(), k
            continue
        _close(outs[k].grad, g, atol=1e-5 * max(np.abs(g).max(), 1e-12),
               what=f"d/d {k}")
    return got


# ---- assignments --------------------------------------------------------

@pytest.mark.parametrize("topk", [1, 4, 9])
def test_atss_assign_matches_jax(topk):
    gt_boxes, gt_labels = _gts()
    anchors, counts = _anchors()
    want = jatss.atss_assign(jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                             jnp.asarray(anchors), counts, topk)
    got = tatss.atss_assign(_t(gt_boxes), _t(gt_labels), _t(anchors),
                            counts, topk)
    for g, w, what in zip(got, want, ("labels", "assigned")):
        _equal(g, w, what)
    labels = _np(got[0])
    assert (labels[0] > 0).any() and not labels[1].any()
    # the identical GTs: their anchors go to the first (highest IoU, first
    # on the tie), class 2
    assert (labels[3] == 2).any() and not (labels[3] == 5).any()


def test_atss_threshold_tie_matches_jax():
    """Two candidates at the same distance from the GT's centre and of
    the same IoU x: mean x, std 0, so the threshold mean + std is x
    exactly, and ``>=`` keeps both (``>`` would keep neither)."""
    anchors = np.asarray([[0, 0, 15, 15], [16, 0, 31, 15],
                          [100, 100, 115, 115], [132, 100, 147, 115]],
                         np.float32)
    gt_boxes = np.asarray([[[4, 2, 27, 13]]], np.float32)
    gt_labels = np.asarray([[3]], np.int32)
    iou = _np(tatss.box_iou(_t(gt_boxes), _t(anchors)[None]))[0, 0, :2]
    mean = np.float32((iou[0] + iou[1]) / np.float32(2))
    assert iou[0] == iou[1] == mean  # the tie is there in float32
    want = jatss.atss_assign(jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                             jnp.asarray(anchors), [4], 2)
    got = tatss.atss_assign(_t(gt_boxes), _t(gt_labels), _t(anchors), [4], 2)
    for g, w, what in zip(got, want, ("labels", "assigned")):
        _equal(g, w, what)
    _equal(got[0], np.asarray([[3, 3, 0, 0]], np.int32), "labels")


def test_ssc_assign_matches_jax():
    gt_boxes, gt_labels = _gts()
    anchors, counts = _anchors()
    want = jatss.ssc_assign(jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                            jnp.asarray(anchors), counts)
    got = tatss.ssc_assign(_t(gt_boxes), _t(gt_labels), _t(anchors), counts)
    for g, w, what in zip(got, want, ("labels", "assigned")):
        _equal(g, w, what)
    assert (_np(got[0]) > 0).any()


@pytest.mark.parametrize("thresholds", [(0.5, 0.4), (0.3, 0.2)])
def test_iou_assign_matches_jax(thresholds):
    gt_boxes, gt_labels = _gts()
    anchors, counts = _anchors(9)
    want = jatss.iou_assign(jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                            jnp.asarray(anchors), *thresholds)
    got = tatss.iou_assign(_t(gt_boxes), _t(gt_labels), _t(anchors),
                           *thresholds)
    for g, w, what in zip(got, want, ("labels", "matched")):
        _equal(g, w, what)
    labels = _np(got[0])
    assert (labels > 0).any() and (labels == -1).any()


@pytest.mark.parametrize("radius", [0.0, 1.5])
def test_fcos_assign_matches_jax(radius):
    gt_boxes, gt_labels = _gts()
    points, counts = LocationGenerator(STRIDES)(LEVELS)
    jlc = jfcos.FCOSLossConfig(center_sampling_radius=radius)
    lc = tfcos.FCOSLossConfig(center_sampling_radius=radius)
    want = jfcos.fcos_assign(jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                             jnp.asarray(points[:, :2]), counts, jlc)
    got = tfcos.fcos_assign(_t(gt_boxes), _t(gt_labels), _t(points[:, :2]),
                            counts, lc)
    _equal(got[0], want[0], "labels")
    _close(got[1], want[1], rtol=1e-6, what="reg_targets")
    labels = _np(got[0])
    assert (labels[0] > 0).any() and not labels[1].any()


def test_retinanet_assign_matches_jax_matcher():
    """The port's ``retinanet_assign`` gives the labels and matches that
    ``retinanet_loss`` of the JAX package computes inline."""
    gt_boxes, gt_labels = _gts()
    anchors, _ = _anchors(9)
    matched = jretina.match_anchors(
        jretina.box_iou(jnp.asarray(gt_boxes), jnp.asarray(anchors)[None]),
        jnp.asarray(gt_labels) > 0, 0.5, 0.4,
        allow_low_quality_matches=True)
    clamped = np.maximum(np.asarray(matched), 0)
    want = np.where(np.asarray(matched) >= 0,
                    np.take_along_axis(gt_labels, clamped, axis=1),
                    np.where(np.asarray(matched) == -2, -1, 0))
    got = tretina.retinanet_assign(_t(gt_boxes), _t(gt_labels), _t(anchors),
                                   tretina.RetinaNetLossConfig())
    _equal(got[0], want.astype(np.int32), "labels")
    _equal(got[1], clamped, "matched")


# ---- losses and gradients -----------------------------------------------

@pytest.mark.parametrize("positive_type,branch,use_iou_pred", [
    ("ATSS", True, False),
    ("ATSS", True, True),
    ("ATSS", False, False),
    ("IoU", True, False),
    ("IoU", False, False),
    ("SSC", True, False),
])
def test_atss_loss_matches_jax(positive_type, branch, use_iou_pred):
    gt_boxes, gt_labels = _gts()
    anchors, counts = _anchors(9 if positive_type == "IoU" else 1)
    kw = dict(topk=4, positive_type=positive_type, use_iou_pred=use_iou_pred)
    got = _compare(jatss.atss_loss, tatss.atss_loss,
                   _outputs(3, anchors.shape[0], branch), gt_boxes,
                   gt_labels, anchors, counts, jatss.ATSSLossConfig(**kw),
                   tatss.ATSSLossConfig(**kw))
    assert ("loss_centerness" in got) == branch


@pytest.mark.parametrize("iou_loss_type", ["iou", "linear_iou", "giou"])
@pytest.mark.parametrize("norm_reg_targets,radius", [(False, 0.0),
                                                      (True, 1.5)])
def test_fcos_loss_matches_jax(iou_loss_type, norm_reg_targets, radius):
    gt_boxes, gt_labels = _gts()
    points, counts = LocationGenerator(STRIDES)(LEVELS)
    outputs = _outputs(4, points.shape[0], ltrb=True)
    if norm_reg_targets:  # in strides, as the head gives them then
        outputs["box_regression"] /= 8.0
    kw = dict(iou_loss_type=iou_loss_type, norm_reg_targets=norm_reg_targets,
              center_sampling_radius=radius)
    _compare(jfcos.fcos_loss, tfcos.fcos_loss, outputs, gt_boxes, gt_labels,
             points, counts, jfcos.FCOSLossConfig(**kw),
             tfcos.FCOSLossConfig(**kw))


@pytest.mark.parametrize("seed", [5, 6])
def test_retinanet_loss_matches_jax(seed):
    gt_boxes, gt_labels = _gts()
    anchors, counts = _anchors(9)
    _compare(jretina.retinanet_loss, tretina.retinanet_loss,
             _outputs(seed, anchors.shape[0], branch=False), gt_boxes,
             gt_labels, anchors, counts, jretina.RetinaNetLossConfig(),
             tretina.RetinaNetLossConfig())


@pytest.mark.parametrize("loss", ["atss", "fcos", "retinanet"])
def test_losses_of_a_batch_without_gts_match_jax(loss):
    """No valid GT anywhere: num_pos 0, the counts clamped; losses and
    gradients still equal."""
    gt_boxes, gt_labels = _gts()
    gt_labels = np.zeros_like(gt_labels)
    if loss == "fcos":
        anchors, counts = LocationGenerator(STRIDES)(LEVELS)
        fns = (jfcos.fcos_loss, tfcos.fcos_loss)
        cfgs = (jfcos.FCOSLossConfig(), tfcos.FCOSLossConfig())
    elif loss == "atss":
        anchors, counts = _anchors()
        fns = (jatss.atss_loss, tatss.atss_loss)
        cfgs = (jatss.ATSSLossConfig(topk=4), tatss.ATSSLossConfig(topk=4))
    else:
        anchors, counts = _anchors(9)
        fns = (jretina.retinanet_loss, tretina.retinanet_loss)
        cfgs = (jretina.RetinaNetLossConfig(), tretina.RetinaNetLossConfig())
    outputs = _outputs(7, anchors.shape[0], branch=loss != "retinanet",
                       ltrb=loss == "fcos")

    def total(outs):
        losses = fns[0](outs, jnp.asarray(gt_boxes), jnp.asarray(gt_labels),
                        jnp.asarray(anchors), counts, cfgs[0])
        return sum(v for k, v in losses.items() if k.startswith("loss_")), \
            losses

    (_, want), want_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    outs = {k: _t(v).requires_grad_(True) for k, v in outputs.items()}
    got = fns[1](outs, _t(gt_boxes), _t(gt_labels), _t(anchors), counts,
                 cfgs[1])
    sum(v for k, v in got.items() if k.startswith("loss_")).backward()
    assert int(got["num_pos"]) == int(want["num_pos"]) == 0
    for k in want:
        if k.startswith("loss_"):
            _close(got[k], want[k], rtol=1e-5, atol=1e-7, what=k)
    for k, g in want_grads.items():
        g = np.asarray(g)
        grad = outs[k].grad
        if grad is None:
            assert not g.any(), k
            continue
        _close(grad, g, atol=1e-5 * max(np.abs(g).max(), 1e-12),
               what=f"d/d {k}")


def test_fcos_iou_loss_types_match_jax():
    rng = np.random.RandomState(8)
    pred = np.exp(rng.normal(1, 1, (50, 4))).astype(np.float32)
    target = np.exp(rng.normal(1, 1, (50, 4))).astype(np.float32)
    for kind in ("iou", "linear_iou", "giou"):
        want = jfcos.iou_loss_ltrb(jnp.asarray(pred), jnp.asarray(target),
                                   kind)
        got = tfcos.iou_loss_ltrb(_t(pred), _t(target), kind)
        _close(got, want, rtol=1e-6, atol=1e-6, what=kind)
    with pytest.raises(NotImplementedError):
        tfcos.iou_loss_ltrb(_t(pred), _t(target), "l1")


def test_centerness_targets_match_jax():
    gt_boxes, _ = _gts()
    anchors, _ = _anchors()
    boxes = np.broadcast_to(gt_boxes[0, :1], anchors.shape).copy()
    from paa_tpu.modeling.box_coder import encode_box as jencode
    deltas = np.asarray(jencode(jnp.asarray(boxes), jnp.asarray(anchors)))
    want = jatss.compute_centerness_targets(jnp.asarray(deltas),
                                            jnp.asarray(anchors))
    got = tatss.compute_centerness_targets(_t(deltas), _t(anchors))
    _close(got, want, rtol=1e-5, atol=1e-6)
    ltrb = np.exp(np.random.RandomState(9).normal(1, 1, (30, 4))).astype(
        np.float32)
    _close(tfcos.compute_centerness_targets_ltrb(_t(ltrb)),
           jfcos.compute_centerness_targets_ltrb(jnp.asarray(ltrb)),
           rtol=1e-6, atol=1e-6)
    _close(tatss.pairwise_iou_aligned(_t(boxes), _t(anchors)),
           jatss._pairwise_iou_aligned(jnp.asarray(boxes),
                                       jnp.asarray(anchors)),
           rtol=1e-6, atol=1e-7)

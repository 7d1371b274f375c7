"""ATSS, FCOS and RetinaNet training in the PyTorch port against the JAX
package on the CPU in float32: one and three ``make_bucket_train_step``
steps of each package from the same params and batch, at the narrow
models of atss_R_50_FPN_1x, fcos_imprv_R_50_FPN_1x and
retinanet_R-50-FPN_1x (a ResNet-50 of an eighth of the widths, 64 FPN
channels, 2 tower convs; tests/test_torch_port_dense_heads.py), with
the configs' SGD and the batch of tests/test_torch_port_train.py. The
params come from a numpy seed, the head's at its init's scale
(``_head_init_scale``).

Each step's loss also reports its assignment's labels (the head's
assignment function on the step's batch). Limits, those of
tests/test_torch_port_train.py, for the same reasons: labels and
num_pos equal; losses within 1e-5 relative; the gradient each step
applied (the JAX one read from its momentum trace) within 1e-4 of each
tensor's largest magnitude, P7's conv within 1e-2 (its groups of 2
elements at 64 channels leave P7 a gradient that is the residue of a
cancellation); the parameters after the update within 1e-6 absolute;
over three steps the labels stay equal and the losses within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import atss_loss as jatss
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling import fcos_loss as jfcos
from paa_tpu.modeling import retinanet_head as jretina
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.modeling import atss_loss as tatss
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling import fcos_loss as tfcos
from paa_tpu_torch.modeling import retinanet_head as tretina
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_dense_heads import HW, _head_init_scale, narrow_cfgs
from test_torch_port_model import _seeded_params
from test_torch_port_train import (  # noqa: F401 (_one_thread: autouse)
    _applied_gradients, _batch, _one_thread, _to_np)

STEPS = 3
EXTRA = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
         "SOLVER.WEIGHT_DECAY", 1e-4]


def _jax_labels(kind):
    def labels(outputs, gt_boxes, gt_labels, anchors, counts, lc):
        gt_boxes = gt_boxes.astype(jnp.float32)
        anchors = jnp.asarray(anchors, jnp.float32)
        if kind == "atss":
            return jatss.atss_assign(gt_boxes, gt_labels, anchors, counts,
                                     lc.topk)[0]
        if kind == "fcos":
            return jfcos.fcos_assign(gt_boxes, gt_labels, anchors[:, :2],
                                     counts, lc)[0]
        matched = jretina.match_anchors(
            jretina.box_iou(gt_boxes, anchors[None]), gt_labels > 0,
            lc.fg_iou_threshold, lc.bg_iou_threshold,
            allow_low_quality_matches=True)
        return jnp.where(matched >= 0, jnp.take_along_axis(
            gt_labels, jnp.maximum(matched, 0), axis=1),
            jnp.where(matched == -2, -1, 0)).astype(jnp.int32)
    return labels


def _port_labels(kind):
    def labels(outputs, gt_boxes, gt_labels, anchors, counts, lc):
        gt_boxes = gt_boxes.to(torch.float32)
        if kind == "atss":
            return tatss.atss_assignment(gt_boxes, gt_labels, anchors,
                                         counts, lc)[0]
        if kind == "fcos":
            return tfcos.fcos_assign(gt_boxes, gt_labels, anchors[:, :2],
                                     counts, lc)[0]
        return tretina.retinanet_assign(gt_boxes, gt_labels, anchors, lc)[0]
    return labels


def _with_labels(loss, labels):
    """``loss`` that also reports its assignment's labels among the
    step's metrics (the train steps sum only the ``loss_*`` entries)."""
    def call(outputs, gt_boxes, gt_labels, anchors, counts, lc, **kwargs):
        out = loss(outputs, gt_boxes, gt_labels, anchors, counts, lc,
                   **kwargs)
        return {**out, "labels": labels(outputs, gt_boxes, gt_labels,
                                        anchors, counts, lc)}
    return call


@pytest.fixture(scope="module", params=["atss", "fcos", "retinanet"])
def runs(request):
    kind = request.param
    jcfg, cfg = narrow_cfgs(kind, EXTRA)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    _head_init_scale(params["head"], np.random.RandomState(1))
    batch = _batch(2)

    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    jloss, jlc = jmodel.loss_fn()
    jmodel.loss_fn = lambda: (_with_labels(jloss, _jax_labels(kind)), jlc)
    jstep = jax.jit(jmodel.make_bucket_train_step(
        HW, param_label_tree=labels))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    loss, lc = model.loss_fn()
    model.loss_fn = lambda: (_with_labels(loss, _port_labels(kind)), lc)
    optimizer, _ = make_optimizer(cfg, model.module)
    state = TrainState(model.module, optimizer)
    step = model.make_bucket_train_step(HW)

    out = []
    for i in range(STEPS):
        before = {n: p.detach().clone()
                  for n, p in model.module.named_parameters()}
        metrics = {k: v.numpy() for k, v in step(state, batch).items()}
        grads = {n: p.grad for n, p in model.module.named_parameters()
                 if p.requires_grad}
        jparams = jstate.params
        jstate, jmetrics = jstep(jstate, jbatch)
        jmetrics = jax.tree.map(np.asarray, jmetrics)
        out.append({
            "jax": {"labels": jmetrics.pop("labels"), "metrics": jmetrics,
                    "params": _to_np(jstate.params)},
            "port": {"labels": metrics.pop("labels"), "metrics": metrics,
                     "grads": grads, "before": before,
                     "params": {n: p.detach().clone() for n, p in
                                model.module.named_parameters()}},
        })
        if i == 0:
            out[0]["jax"]["grads"] = _applied_gradients(
                jstate.opt_state, jparams, labels, jcfg)
    return kind, model, out


def _in_port_layout(model, tree):
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree)
    return dict(scratch.module.state_dict())


def test_first_step_losses_and_assignment_match_jax(runs):
    _, _, out = runs
    want, got = out[0]["jax"], out[0]["port"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert int(got["metrics"]["num_pos"]) == \
        int(want["metrics"]["num_pos"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert int((got["labels"] > 0).sum()) == int(got["metrics"]["num_pos"])
    for k, v in want["metrics"].items():
        if k != "num_pos":
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)


def test_first_step_gradients_match_jax(runs):
    _, model, out = runs
    want = _in_port_layout(model, out[0]["jax"]["grads"])
    got = out[0]["port"]["grads"]
    trainable = {n for n, p in model.module.named_parameters()
                 if p.requires_grad}
    assert set(got) == trainable and len(trainable) > 60
    for name, g in got.items():
        w = want[name].numpy()
        share = 1e-2 if name.startswith("backbone.fpn.p7.") else 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max(),
                                   err_msg=name)


def test_first_step_update_matches_jax(runs):
    _, model, out = runs
    want = _in_port_layout(model, out[0]["jax"]["params"])
    got, before = out[0]["port"]["params"], out[0]["port"]["before"]
    moved = 0
    for name, p in model.module.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if p.requires_grad:
            moved += int(not torch.equal(got[name], before[name]))
        else:
            assert torch.equal(got[name], before[name]), name
    assert moved > 60


def test_labels_stay_equal_over_three_steps(runs):
    _, _, out = runs
    for i, o in enumerate(out):
        np.testing.assert_array_equal(o["port"]["labels"], o["jax"]["labels"],
                                      err_msg=f"step {i}")
        assert int(o["port"]["metrics"]["num_pos"]) == \
            int(o["jax"]["metrics"]["num_pos"])
    loss = [float(o["port"]["metrics"]["loss"]) for o in out]
    np.testing.assert_allclose(
        loss, [float(o["jax"]["metrics"]["loss"]) for o in out], rtol=1e-4)

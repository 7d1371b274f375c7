"""Training of the DCN / ResNeXt configs in the PyTorch port against the
JAX package, on the CPU, float32, at the narrow dcnv2 ResNeXt of
tests/test_torch_port_backbones.py (8 groups x 4, stem 16, res2 64,
64 FPN channels; modulated DCN as conv2 of every block of stages 3-5
and as the last conv of both head towers; FREEZE_CONV_BODY_AT 2, so the
first DCN stage is the first trained one) on the 2 x 64 x 96 batch of
tests/test_torch_port_train.py, with the JAX params carried across by
``load_jax_params`` and every DCN offset conv drawn from a seed (at its
zero init a DCN layer is a conv with a mask of 0.5). The JAX side
samples with ``TPU.DCN_MODE`` "gather"; the port trains through
``DeformConv2dFunction``. SOLVER.DCONV_OFFSETS_LR_FACTOR is 0.5, so the
offset convs take their own learning rate.

- One and three ``make_bucket_train_step`` steps of each package:
  losses within 1e-5 relative (the first step) and 1e-4 (three steps),
  ``num_pos`` and the positive masks equal; the first step's gradients
  within 1e-4 of each tensor's largest magnitude (P7's within 1e-2),
  the parameters after it within 1e-6 absolute: the limits of
  tests/test_torch_port_train.py, and why.
- ``param_labels`` of the narrow dcnv2 model against the JAX package's
  through the name map, the towers' DCN offsets included, and the
  optimizer's group of each label with its learning-rate factor.
- The X-152 dcnv2 config's multi-scale training input
  (MIN_SIZE_RANGE_TRAIN (640, 800), its eight-bucket TPU.TRAIN_BUCKETS
  ladder) through both loaders: every sample's predicted bucket over
  three epochs and the first batches equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.data import coco as jcoco
from paa_tpu.data import loader as jloader
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.paa_loss import PAALossConfig as JPAALossConfig
from paa_tpu.modeling.paa_loss import paa_loss as jax_paa_loss
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data import coco, loader
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.layers import DeformConv
from paa_tpu_torch.modeling.paa_loss import PAALossConfig, paa_loss
from paa_tpu_torch.solver import make_optimizer, param_labels
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_backbones import (  # noqa: F401
    CASES, NARROW, ROOT, _restore_jax_dcn_mode, _seed_offset_convs)
from test_torch_port_model import _seeded_params
from test_torch_port_train import OVERRIDES, _applied_gradients, _batch
from test_torch_port_train import _with_pos_mask, _to_np

HW = (64, 96)
X152_CONFIG = f"{ROOT}/configs/paa/paa_dcnv2_X_152_32x8d_FPN_2x.yaml"
DCN_TRAIN = OVERRIDES + NARROW + CASES["dcnv2_resnext"] + [
    "SOLVER.DCONV_OFFSETS_LR_FACTOR", 0.5]
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs():
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(DCN_TRAIN)
        cfg.freeze()
        out.append(cfg)
    return out


def _jax_params(jmodel):
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    return _seed_offset_convs(params, np.random.RandomState(3))


@pytest.fixture(scope="module")
def runs():
    """STEPS steps of each package from the same params and batch (see
    tests/test_torch_port_train.py's fixture of the same name)."""
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    params = _jax_params(jmodel)
    batch = _batch(2)

    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    jmodel.loss_fn = lambda: (_with_pos_mask(jax_paa_loss),
                              JPAALossConfig.from_cfg(jcfg))
    jstep = jax.jit(jmodel.make_bucket_train_step(
        HW, param_label_tree=labels))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    model.loss_fn = lambda: (_with_pos_mask(paa_loss),
                             PAALossConfig.from_cfg(cfg))
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
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
            "jax": {"pos_mask": jmetrics.pop("pos_mask"),
                    "metrics": jmetrics, "params": _to_np(jstate.params)},
            "port": {"pos_mask": metrics.pop("pos_mask"),
                     "metrics": metrics, "grads": grads, "before": before,
                     "params": {n: p.detach().clone() for n, p in
                                model.module.named_parameters()}},
        })
        if i == 0:
            out[0]["jax"]["grads"] = _applied_gradients(
                jstate.opt_state, jparams, labels, jcfg)
    return model, out


def _in_port_layout(model, tree):
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree)
    return dict(scratch.module.state_dict())


def test_dcn_layers_train_through_the_function(runs):
    """Every DeformConv of the narrow model (stages 3-5 and both towers)
    is trained: its sampled conv's weight and its offset conv received
    gradients in the first step, and its forward under autograd records
    ``DeformConv2dFunction``."""
    model, out = runs
    grads = out[0]["port"]["grads"]
    convs = {n: m for n, m in model.module.named_modules()
             if isinstance(m, DeformConv)}
    assert len(convs) == 4 + 6 + 3 + 2
    for n in convs:
        for leaf in ("weight", "offset.weight", "offset.bias"):
            assert float(grads[f"{n}.{leaf}"].abs().max()) > 0, (n, leaf)
    y = convs["head.cls_tower.conv3"](torch.zeros(1, 64, 8, 12))
    assert "DeformConv2dFunctionBackward" in {
        type(f).__name__ for f, _ in y.grad_fn.next_functions
        if f is not None}


def test_first_step_losses_and_assignment_match_jax(runs):
    _, out = runs
    want, got = out[0]["jax"], out[0]["port"]
    assert set(got["metrics"]) == set(want["metrics"])
    assert int(got["metrics"]["num_pos"]) == int(want["metrics"]["num_pos"])
    assert int(got["metrics"]["num_pos"]) > 0
    np.testing.assert_array_equal(got["pos_mask"], want["pos_mask"])
    for k, v in want["metrics"].items():
        if k != "num_pos":
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)


def test_first_step_gradients_match_jax(runs):
    model, out = runs
    want = _in_port_layout(model, out[0]["jax"]["grads"])
    got = out[0]["port"]["grads"]
    trainable = {n for n, p in model.module.named_parameters()
                 if p.requires_grad}
    assert set(got) == trainable
    assert sum(".offset." in n for n in trainable) == 2 * (4 + 6 + 3 + 2)
    for name, g in got.items():
        w = want[name].numpy()
        share = 1e-2 if name.startswith("backbone.fpn.p7.") else 1e-4
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max(),
                                   err_msg=name)


def test_first_step_update_matches_jax(runs):
    model, out = runs
    want = _in_port_layout(model, out[0]["jax"]["params"])
    got, before = out[0]["port"]["params"], out[0]["port"]["before"]
    for name, p in model.module.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if not p.requires_grad:
            assert name.startswith(("backbone.resnet.stem.",
                                    "backbone.resnet.layer1_")), name
            assert torch.equal(got[name], before[name])


def test_positive_sets_stay_equal_over_three_steps(runs):
    _, out = runs
    for i, o in enumerate(out):
        np.testing.assert_array_equal(o["port"]["pos_mask"],
                                      o["jax"]["pos_mask"],
                                      err_msg=f"step {i}")
        assert int(o["port"]["metrics"]["num_pos"]) == \
            int(o["jax"]["metrics"]["num_pos"])
    loss = [float(o["port"]["metrics"]["loss"]) for o in out]
    np.testing.assert_allclose(
        loss, [float(o["jax"]["metrics"]["loss"]) for o in out], rtol=1e-4)


def test_dcnv2_param_labels_and_groups_match_jax():
    """Every tensor of the narrow dcnv2 model (parameters and FrozenBN
    buffers) gets its JAX leaf's label through the name map (each JAX
    leaf filled with its own index); the offset convs of the backbone's
    DCN stages and of both towers are ``dcn_offset`` /
    ``dcn_offset_bias``, and ``make_optimizer`` gives those groups
    DCONV_OFFSETS_LR_FACTOR (times BIAS_LR_FACTOR for the biases)."""
    jcfg, cfg = _cfgs()
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
    for tower in ("cls_tower", "bbox_tower"):
        assert got[f"head.{tower}.conv3.offset.weight"] == "dcn_offset"
        assert got[f"head.{tower}.conv3.offset.bias"] == "dcn_offset_bias"
    optimizer, labels = make_optimizer(cfg, model.module)
    s = cfg.SOLVER
    factors = {g["label"]: g["lr_factor"] for g in optimizer.param_groups}
    assert factors == {"weight": 1.0, "bias": s.BIAS_LR_FACTOR,
                       "dcn_offset": 0.5,
                       "dcn_offset_bias": 0.5 * s.BIAS_LR_FACTOR}
    params = dict(model.module.named_parameters())
    for group in optimizer.param_groups:
        names = {n for n, p in params.items()
                 if any(p is q for q in group["params"])}
        assert {labels[n] for n in names} == {group["label"]}
    # the frozen stem and layer1 (FREEZE_CONV_BODY_AT 2) join no group
    assert sum(len(g["params"]) for g in optimizer.param_groups) == sum(
        p.requires_grad for p in params.values())


def test_x152_bucket_ladder_matches_jax(tmp_path):
    """The X-152 config's train stream through both loaders on 12
    synthetic images at COCO's common sizes: the predicted bucket of
    every sample in three epochs, and the first two batches of 2 (full
    size, up to 800 x 1333 in the ladder's buckets)."""
    cfgs = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(X152_CONFIG)
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER",
                             2, "DATALOADER.NUM_WORKERS", 2,
                             "TPU.MAX_GT", 20])
        cfg.freeze()
        cfgs.append(cfg)
    jcfg, cfg = cfgs
    assert len(cfg.TPU.TRAIN_BUCKETS) == 8
    assert tuple(cfg.INPUT.MIN_SIZE_RANGE_TRAIN) == (640, 800)
    ann_file, img_dir = synth_coco(str(tmp_path), 12, seed=4)
    got = loader.make_data_loader(cfg, coco.COCODataset(ann_file, img_dir),
                                  is_train=True, seed=6)
    want = jloader.make_data_loader(
        jcfg, jcoco.COCODataset(ann_file, img_dir), is_train=True, seed=6)
    assert got.transform.min_sizes == list(range(640, 801))
    buckets = set()
    for epoch in range(3):
        for idx in range(12):
            b = got._predicted_bucket(idx, epoch)
            assert b == want._predicted_bucket(idx, epoch)
            assert got._draws(epoch, idx) == want._draws(epoch, idx)
            buckets.add(tuple(b))
    assert buckets <= {tuple(b) for b in cfg.TPU.TRAIN_BUCKETS}
    assert len(buckets) >= 4
    got_batches, want_batches = list(got), list(want)
    assert len(got_batches) == len(want_batches) == 2
    for g, w in zip(got_batches, want_batches):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)

"""The MobileNetV2 body and FCOS-MNV2 in the PyTorch port against the JAX
package, on the CPU in float32 at 2 x 64 x 96: the body at its one width
(MobileNetV2 1.0: the JAX package reads no width from the config), and
configs/fcos/fcos_bn_bs16_MNV2_FPN_1x.yaml with 64 FPN channels and 2
tower convs, the JAX params from a numpy seed carried across by
``load_jax_params`` (the head's at its init's scale).

Limits, those of the existing port tests for the same outputs
(tests/test_torch_port_dense_heads.py, test_torch_port_dense_train.py):
features and head outputs within 1e-4 of each tensor's largest magnitude
(float32 convolutions summed in other orders), detections' labels and
valid equal, boxes and scores within 1e-3; a train step's labels and
num_pos equal, losses within 1e-5 relative, the gradient each side
applied within 1e-4 of each tensor's largest magnitude (P7's conv within
1e-2: at 64 channels its GN groups hold 2 elements), updated parameters
within 1e-6.

One divergence is pinned rather than matched: the JAX package's solver
tells FrozenBatchNorm by its flax name (``bn\\d``, ``downsample_bn``),
which the MobileNetV2 scopes (``stem_bn``, ``pw_bn``, ``dw_bn``,
``pw_linear_bn``) miss, so its step trains their four tensors; the port
keeps every FrozenBatchNorm frozen, as the JAX package's own docstrings
intend (ROADMAP.md section 3). The first step's losses, gradients and
updates of every other tensor still agree: the two sides start from the
same statistics.
"""

import contextlib
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.mobilenet import MobileNetV2 as JMobileNetV2
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.layers import FrozenBatchNorm, GroupNorm32
from paa_tpu_torch.modeling.mobilenet import MobileNetV2
from paa_tpu_torch.solver import make_optimizer, param_labels
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_dense_heads import _close, _head_init_scale
from test_torch_port_dense_train import (
    _jax_labels, _port_labels, _with_labels)
from test_torch_port_model import _seeded_params
from test_torch_port_train import (  # noqa: F401 (_one_thread: autouse)
    _applied_gradients, _batch, _one_thread, _to_np)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
CONFIG = os.path.join(ROOT, "configs", "fcos",
                      "fcos_bn_bs16_MNV2_FPN_1x.yaml")
NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
          "MODEL.FCOS.NUM_CONVS", 2, "TPU.FUSED_GN", True,
          "TEST.DETECTIONS_PER_IMG", 10, "SOLVER.WEIGHT_DECAY", 1e-4]


def cfgs(path=CONFIG, extra=()):
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_file(path)
        cfg.merge_from_list(NARROW + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


def test_mobilenet_v2_body_matches_jax():
    """The four features (24, 32, 96, 320 channels at strides 4-32) from
    the same seeded params; residuals, ReLU6 and the depthwise convs."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (2, *HW, 3)).astype(np.float32)
    jbody = JMobileNetV2()
    shapes = jax.eval_shape(lambda: jbody.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    params = _seeded_params(shapes, np.random.RandomState(1))
    want = jax.jit(lambda p, xx: jbody.apply({"params": p}, xx))(params, x)
    body = load_jax_params(MobileNetV2(), params)
    assert body.block3.dw.groups == 144 and body.block1.use_res is False
    assert body.block2.use_res is False and body.block3.use_res
    with torch.no_grad():
        got = body(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert [g.shape[1] for g in got] == list(
        MobileNetV2.feature_channels()) == list(
        JMobileNetV2.feature_channels())
    assert [tuple(g.shape[2:]) for g in got] == [(16, 24), (8, 12), (4, 6),
                                                 (2, 3)]
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)


@pytest.fixture(scope="module")
def fcos_mnv2():
    jcfg, cfg = cfgs()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    _head_init_scale(params["head"], np.random.RandomState(1), (-3.5, -2.5))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    return jcfg, jmodel, params, model


def test_fcos_mnv2_build_matches_jax(fcos_mnv2):
    """FPN on C3-C5 (32, 96, 320 channels), P6 from P5, P3-P7 at strides
    8-128; no SyncBN in the body whatever MODEL.USE_SYNCBN says."""
    _, jmodel, _, model = fcos_mnv2
    fpn = model.module.backbone.fpn
    assert [getattr(fpn, f"fpn_inner{k}").weight.shape[1]
            for k in (2, 3, 4)] == [32, 96, 320]
    assert fpn.p6.weight.shape[1] == 64
    assert model.strides == tuple(jmodel.strides) == (8, 16, 32, 64, 128)
    assert model.feature_shapes(HW) == jmodel.feature_shapes(HW)
    anchors, counts = model.anchors_for(HW)
    want, want_counts = jmodel.anchors_for(HW)
    np.testing.assert_array_equal(anchors.numpy(), want)
    assert list(counts) == list(want_counts)
    _, cfg = cfgs(extra=["MODEL.USE_SYNCBN", True])
    m = build_detection_model(cfg, device="cpu").module
    norms = {type(x) for x in m.backbone.resnet.modules()
             if isinstance(x, torch.nn.Module) and "Norm" in type(x).__name__}
    assert norms == {FrozenBatchNorm}


def test_fcos_mnv2_eval_matches_jax(fcos_mnv2):
    """uint8 in, detections out: the FPN features and head outputs within
    1e-4, labels and valid equal, boxes and scores within 1e-3."""
    from flax import linen as nn

    _, jmodel, params, model = fcos_mnv2
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)
    x = images.astype(np.float32) - np.asarray(model.cfg.INPUT.PIXEL_MEAN,
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
    assert len(got_f) == len(want_f) == 5
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


def _frozen_bn_names(module):
    return {f"{name}.{leaf}" for name, m in module.named_modules()
            if isinstance(m, FrozenBatchNorm)
            for leaf in ("weight", "bias", "running_mean", "running_var")}


def test_fcos_mnv2_labels_pin_the_frozen_bn_divergence(fcos_mnv2):
    """Every tensor's label equals its JAX leaf's but the body's
    FrozenBatchNorm tensors: "frozen" in the port, "weight" / "bias" in
    the JAX package, whose name rule misses the MobileNetV2 scopes."""
    jcfg, jmodel, params, model = fcos_mnv2
    leaves, treedef = jax.tree.flatten(params)
    ids = jax.tree.unflatten(treedef, [
        np.full(np.shape(v), i, np.float32) for i, v in enumerate(leaves)])
    want = jax.tree.leaves(jax_param_labels(ids, 0))
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, ids)
    got = param_labels(scratch.module, 0)
    state = scratch.module.state_dict()
    assert len(got) == len(leaves) == len(state)
    frozen = _frozen_bn_names(scratch.module)
    assert len(frozen) == 4 * 51  # the stem's, 2 + 16 * 3 in the blocks
    for name, t in state.items():
        jax_label = want[int(t.flatten()[0])]
        if name in frozen:
            assert got[name] == "frozen" and jax_label in ("weight", "bias")
        else:
            assert got[name] == jax_label, name


@contextlib.contextmanager
def pinned_relu6(record=None, pin=None):
    """Both packages' ``relu6``, patched: with ``record`` (a list) the
    port's appends each call's decisions (x <= 0, x >= 6) as NHWC numpy
    masks; with ``pin`` (such a list) the JAX package's k-th call (in
    trace order, the forward's) takes the k-th decisions instead of its
    own. The MobileNetV2 body's 34 ReLU6 layers hold elements within
    float32 rounding of a kink: the port's own float32 gradient misses
    its float64 gradient by 3.7e-3 of a tensor's largest magnitude, so
    the two packages' steps are compared at the same decisions."""
    from paa_tpu.modeling import mobilenet as jmobilenet
    from paa_tpu_torch.modeling import mobilenet

    calls = [0]

    def port_relu6(x):
        below, above = x <= 0, x >= 6
        record.append(tuple(m.permute(0, 2, 3, 1).numpy() for m in
                            (below, above)))
        return torch.where(below, 0.0, torch.where(above, 6.0, x))

    def jax_relu6(x):
        below, above = pin[calls[0]]
        calls[0] += 1
        return jnp.where(below, 0.0, jnp.where(above, 6.0, x))

    with pytest.MonkeyPatch.context() as mp:
        if record is not None:
            mp.setattr(mobilenet, "relu6", port_relu6)
        if pin is not None:
            mp.setattr(jmobilenet, "relu6", jax_relu6)
        yield calls


@pytest.fixture(scope="module")
def fcos_mnv2_step(fcos_mnv2):
    """One ``make_bucket_train_step`` step of each package from the same
    params and batch, each loss also reporting its assignment's labels,
    the JAX package's ReLU6 decisions pinned to the port's
    (``pinned_relu6``)."""
    jcfg, jmodel, params, model = fcos_mnv2
    batch = _batch(2)
    model = build_detection_model(model.cfg, device="cpu")
    load_jax_params(model.module, params)
    loss, lc = model.loss_fn()
    model.loss_fn = lambda: (_with_labels(loss, _port_labels("fcos")), lc)
    state = TrainState(model.module, make_optimizer(model.cfg,
                                                    model.module)[0])
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    decisions = []
    with pinned_relu6(record=decisions):
        metrics = {k: v.numpy() for k, v in model.make_bucket_train_step(
            HW)(state, batch).items()}
    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    jloss, jlc = jmodel.loss_fn()
    jmodel.loss_fn = lambda: (_with_labels(jloss, _jax_labels("fcos")), jlc)
    jparams = jstate.params
    with pinned_relu6(pin=decisions) as calls:
        jstep = jax.jit(jmodel.make_bucket_train_step(
            HW, param_label_tree=labels))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    assert calls[0] == len(decisions) == 34  # the stem, 1 + 16 * 2
    jmetrics = jax.tree.map(np.asarray, jmetrics)
    return {"jax": {"labels": jmetrics.pop("labels"), "metrics": jmetrics,
                    "grads": _applied_gradients(jstate.opt_state, jparams,
                                                labels, jcfg),
                    "params": _to_np(jstate.params)},
            "port": {"labels": metrics.pop("labels"), "metrics": metrics,
                     "before": before}, "model": model}


def _in_port_layout(model, tree):
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree)
    return dict(scratch.module.state_dict())


def test_fcos_mnv2_train_step_matches_jax(fcos_mnv2_step):
    got, want, model = (fcos_mnv2_step["port"], fcos_mnv2_step["jax"],
                        fcos_mnv2_step["model"])
    assert int(got["metrics"]["num_pos"]) == \
        int(want["metrics"]["num_pos"]) > 0
    np.testing.assert_array_equal(got["labels"], want["labels"])
    for k, v in want["metrics"].items():
        if k != "num_pos":
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
    grads = _in_port_layout(model, want["grads"])
    trainable = {n: p for n, p in model.module.named_parameters()
                 if p.requires_grad}
    assert len(trainable) == 94  # the whole body (FREEZE_CONV_BODY_AT 0)
    for name, p in trainable.items():
        w = grads[name].numpy()
        share = 1e-2 if name.startswith("backbone.fpn.p7.") else 1e-4
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max(),
                                   err_msg=name)
    after = _in_port_layout(model, want["params"])
    state = model.module.state_dict()
    frozen = _frozen_bn_names(model.module)
    for name, t in state.items():
        if name in frozen:  # the port's stay; the JAX package's moved
            assert torch.equal(t, got["before"][name]), name
            continue
        np.testing.assert_allclose(t.numpy(), after[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    moved = [n for n in frozen
             if not torch.equal(after[n], got["before"][n])]
    assert moved  # the JAX package's step trained them
    assert any(isinstance(m, GroupNorm32) for m in model.module.modules())


MNV2_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "fcos",
                                             "*MNV2*.yaml")))


@pytest.mark.parametrize("path", MNV2_CONFIGS,
                         ids=[os.path.basename(p) for p in MNV2_CONFIGS])
def test_every_mnv2_config_builds_as_jax(path):
    """The five MNV2 FCOS configs at full width: the parameter count and
    every tensor's shape equal to the JAX package's (FPN 256 or 128)."""
    jcfg, cfg = (jax_get_cfg(), get_cfg())
    for c in (jcfg, cfg):
        c.merge_from_file(path)
        c.freeze()
    shapes = jax.eval_shape(lambda: jax_build(jcfg).init(
        jax.random.PRNGKey(0), HW))["params"]
    model = build_detection_model(cfg, device="cpu")
    assert model.head_type == "fcos"
    state = model.module.state_dict()
    n = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
    assert model.module.backbone.fpn.p7.weight.shape[0] == n in (128, 256)
    assert sum(v.size for v in jax.tree.leaves(shapes)) == \
        sum(v.numel() for v in state.values())
    load_jax_params(model.module, jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))

"""PAA-R50 training in the PyTorch port against the JAX package, on the
CPU, at the narrow config of tests/test_torch_port_model.py (R-50 body,
BACKBONE_OUT_CHANNELS=64, 2 x 64 x 96 uint8 input) in float32, with the
JAX params carried across by ``load_jax_params``, and the config's SGD
(lr 0.01, constant warmup 1/3, weight decay 1e-4, momentum 0.9).

- One ``make_bucket_train_step`` step of each package from the same
  params and batch: losses, ``num_pos`` and the positive mask (each
  step's loss reports ``paa_loss(..., return_aux=True)``'s) equal or
  within 1e-5 relative (sums over every anchor and class in different
  orders); the gradient each step applied (the port's ``.grad``; the
  JAX step's momentum trace after its first update less the weight
  decay) for every trainable parameter within 1e-4 of that tensor's
  largest magnitude (a backward pass through 53
  convolutions whose float32 sums run in different orders on the two
  sides, as the features of tests/test_torch_port_model.py agree to
  1e-4), except P7's convolution, within 1e-2 of its own: at 64
  channels P7 (1 x 1 positions) normalizes groups of 2 elements, whose
  outputs are +-1 whatever the input, so the gradient that reaches P7
  is the residue of a cancellation, ~1e-3 of P6's, and keeps few
  digits; the parameters after the update within 1e-6 absolute (lr times
  that gradient error is below 1e-8; 1e-6 covers the largest weights'
  float32 rounding of the update); frozen parameters unchanged.
- Three consecutive steps: the positive sets stay equal.
- ``make_lr_schedule`` and ``param_labels`` against the JAX package's;
  the SGD's first two updates against the hand-computed torch rule.
- ``GroupNormReLU`` (the autograd Function around K3) with the plain
  forward in place of K3: its gradients equal autograd through the
  plain version, and the JAX package's custom VJP within 1e-5.
- ``do_train`` over 3 batches: checkpoints and the ``last_checkpoint``
  pointer, resuming from ``start_iter``, ``FloatingPointError`` on a NaN
  loss; and the entry points' default device.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.paa_loss import PAALossConfig as JPAALossConfig
from paa_tpu.modeling.paa_loss import paa_loss as jax_paa_loss
from paa_tpu.ops.fused_gn import fused_group_norm_relu
from paa_tpu.solver import make_lr_schedule as jax_schedule
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.engine import TrainState, do_train
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.paa_loss import PAALossConfig, paa_loss
from paa_tpu_torch.ops import group_norm as gn
from paa_tpu_torch.solver import (
    make_lr_schedule, make_optimizer, param_labels, set_lr)
from paa_tpu_torch.utils import load_jax_params
from paa_tpu_torch.utils.checkpoint import Checkpointer
from test_torch_port_model import OVERRIDES as MODEL_OVERRIDES
from test_torch_port_model import _seeded_params

HW = (64, 96)
# TPU.FUSED_GN: the JAX towers take fused_group_norm_relu, the TPU kernel
# K3 that the port's GroupNorm32 ports (two-pass variance, the VJP of
# its reference); flax's GroupNorm takes E[x^2] - E[x]^2, which loses
# most digits in P7's groups of 2 elements at 64 channels. The port
# ignores the key.
OVERRIDES = MODEL_OVERRIDES + [
    "TPU.FUSED_GN", True,
    "SOLVER.BASE_LR", 0.01,
    "SOLVER.WEIGHT_DECAY", 1e-4,
    "SOLVER.WARMUP_METHOD", "constant",
]
STEPS = 3


def _cfgs(extra=()):
    out = []
    for get in (jax_get_cfg, get_cfg):
        cfg = get()
        cfg.merge_from_list(OVERRIDES + list(extra))
        cfg.freeze()
        out.append(cfg)
    return out


def _batch(seed, bsz=2, max_gt=6):
    """uint8 images (content 64x96 and 60x90), 3 and 2 valid GTs of
    20-60 px (labels 1..80), the other slots padding."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)[:bsz]
    gt_boxes = np.zeros((bsz, max_gt, 4), np.float32)
    gt_labels = np.zeros((bsz, max_gt), np.int32)
    for b, n in zip(range(bsz), (3, 2)):
        xy = rng.uniform(0, 40, (n, 2))
        wh = rng.uniform(20, 60, (n, 2))
        box = np.concatenate([xy, xy + wh], axis=1)
        box[:, 2] = np.minimum(box[:, 2], sizes[b, 1] - 1)
        box[:, 3] = np.minimum(box[:, 3], sizes[b, 0] - 1)
        gt_boxes[b, :n] = box
        gt_labels[b, :n] = rng.randint(1, 81, n)
    return {"images": images, "image_sizes": sizes, "gt_boxes": gt_boxes,
            "gt_labels": gt_labels}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes: the test workers share
    the host's cores, where eight threads per op mostly wait for each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _applied_gradients(opt_state, params, labels, cfg):
    """The gradient the JAX step applied in its first update: each
    label's momentum trace then holds g + wd * p (``add_decayed_weights``
    before a trace that starts at zero), so g = trace - wd * p; frozen
    leaves take none."""
    s = cfg.SOLVER
    decay = {"weight": s.WEIGHT_DECAY, "bias": s.WEIGHT_DECAY_BIAS,
             "dcn_offset": s.WEIGHT_DECAY,
             "dcn_offset_bias": s.WEIGHT_DECAY_BIAS}
    order = sorted(decay)

    def trace(state):
        return next(t.trace for t in jax.tree.leaves(
            state, is_leaf=lambda x: isinstance(x, optax.TraceState))
            if isinstance(t, optax.TraceState))

    traces = [trace(opt_state.inner_states[k]) for k in order]

    def grad(p, label, *ts):
        p = np.asarray(p, np.float32)
        if label == "frozen":
            return np.zeros_like(p)
        t = np.asarray(ts[order.index(label)], np.float32)
        return t - np.float32(decay[label]) * p

    return jax.tree.map(grad, params, labels, *traces,
                        is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _with_pos_mask(loss):
    """``loss`` that also reports its positive mask among the step's
    metrics (the train steps sum only the ``loss_*`` entries)."""
    def call(*args, **kwargs):
        out, aux = loss(*args, return_aux=True, **kwargs)
        return {**out, "pos_mask": aux["pos_mask"]}
    return call


@pytest.fixture(scope="module")
def runs():
    """STEPS steps of each package from the same params and batch, each
    through its ``make_bucket_train_step`` (the JAX package's jitted),
    with a loss that also reports the positive mask; for the first step
    the gradients each applied."""
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
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
    """A JAX param-shaped tree as the port's named tensors, through
    ``load_jax_params`` into a scratch module."""
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree)
    return dict(scratch.module.state_dict())


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
    assert set(got) == trainable and len(trainable) > 100
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
    moved = 0
    for name, p in model.module.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        if p.requires_grad:
            moved += int(not torch.equal(got[name], before[name]))
        else:  # frozen: the stem and layer1 (FREEZE_CONV_BODY_AT 2)
            assert name.startswith(("backbone.resnet.stem.",
                                    "backbone.resnet.layer1_")), name
            assert p.grad is None and torch.equal(got[name], before[name])
    assert moved > 100


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


@pytest.mark.parametrize("method,points", [
    ("constant", [0, 499, 500, 60000, 80001]),
    ("linear", [0, 250, 499, 500, 60000, 80001]),
])
def test_lr_schedule_matches_jax(method, points):
    """The points of tests/test_train_step.py's schedule tests."""
    extra = ["SOLVER.BASE_LR", 0.01, "SOLVER.STEPS", (60000, 80000),
             "SOLVER.WARMUP_METHOD", method, "SOLVER.WARMUP_ITERS", 500]
    jcfg, cfg = _cfgs(extra)
    want, got = jax_schedule(jcfg), make_lr_schedule(cfg)
    for i in points:
        np.testing.assert_allclose(got(i), float(want(i)), rtol=1e-6,
                                   err_msg=f"{method} at {i}")


@pytest.mark.parametrize("freeze_at", [0, 2, 5])
def test_param_labels_match_jax(freeze_at):
    """Every port tensor (parameters and FrozenBN buffers) gets the label
    of its JAX leaf. The name map: each JAX leaf is filled with its own
    index and loaded into the port's module."""
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    leaves, treedef = jax.tree.flatten(shapes)
    ids = jax.tree.unflatten(treedef, [
        np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    want = jax.tree.leaves(jax_param_labels(ids, freeze_at))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, ids)
    state = model.module.state_dict()
    got = param_labels(model.module, freeze_at)
    assert len(got) == len(leaves)
    for name, t in state.items():
        assert got[name] == want[int(t.flatten()[0])], name


def test_sgd_matches_torch_rule():
    """Two updates of make_optimizer's SGD: v = g + wd * p (the trace
    starts at the first gradient), then v = mu * v + g + wd * p; p -= lr
    * v; biases at lr * BIAS_LR_FACTOR without decay."""
    _, cfg = _cfgs(["SOLVER.WEIGHT_DECAY", 0.01, "SOLVER.BASE_LR", 0.1,
                    "SOLVER.WARMUP_ITERS", 0])
    conv = torch.nn.Conv2d(1, 1, 1)
    with torch.no_grad():
        conv.weight.fill_(2.0)
        conv.bias.fill_(1.0)
    opt, labels = make_optimizer(cfg, conv)
    assert labels == {"weight": "weight", "bias": "bias"}
    state = TrainState(conv, opt)
    sched = make_lr_schedule(cfg)
    expect_w, expect_b, v_w, v_b = 2.0, 1.0, 0.0, 0.0
    for i in range(2):
        conv.weight.grad = torch.full_like(conv.weight, 0.5)
        conv.bias.grad = torch.full_like(conv.bias, 0.3)
        set_lr(opt, sched(state.step))
        opt.step()
        state.step += 1
        v_w = 0.9 * v_w + 0.5 + 0.01 * expect_w
        v_b = 0.9 * v_b + 0.3
        expect_w -= 0.1 * v_w
        expect_b -= 0.2 * v_b
        np.testing.assert_allclose(conv.weight.item(), expect_w, rtol=1e-6)
        np.testing.assert_allclose(conv.bias.item(), expect_b, rtol=1e-6)


# ---- the autograd Function around K3 ---------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 5, 7), (1, 256, 12, 10)])
def test_group_norm_function_backward_is_the_plain_vjp(shape, dtype):
    """``GroupNormReLU`` with the plain forward in place of K3: forward
    and gradients (x in its dtype, weight and bias in float32) equal
    autograd through ``group_norm_relu_plain``."""
    gen = torch.Generator().manual_seed(shape[1])
    x = (torch.randn(*shape, generator=gen) * 1.5 + 0.3).to(dtype)
    w = torch.rand(shape[1], generator=gen) + 0.5
    b = torch.randn(shape[1], generator=gen) * 0.2
    up = torch.randn(*shape, generator=gen).to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = gn.GroupNormReLU.apply(*ins, 32, 1e-5, gn.group_norm_relu_plain)
    y.backward(up)
    refs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y_ref = gn.group_norm_relu_plain(*refs)
    y_ref.backward(up)
    assert torch.equal(y, y_ref)
    for got, want in zip(ins, refs):
        assert got.grad.dtype == want.dtype
        assert torch.equal(got.grad, want.grad)
    assert ins[0].grad.dtype == dtype and ins[1].grad.dtype == torch.float32
    # only what needs a gradient gets one
    xo = x.clone().requires_grad_(True)
    gn.GroupNormReLU.apply(xo, w, b, 32, 1e-5,
                           gn.group_norm_relu_plain).sum().backward()
    assert xo.grad is not None and w.grad is None


def _gn_vjp_cases():
    """(name, x NHWC, scale, bias, upstream gradient): random inputs, and
    a group of zero variance with a zero bias (the ReLU input exactly 0,
    where the reference's ``jnp.maximum`` gives half the upstream
    gradient: d bias of channels 0-1 is half their upstream sum)."""
    rng = np.random.RandomState(0)
    x = rng.normal(0.3, 1.2, (2, 8, 10, 64)).astype(np.float32)
    s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.normal(0, 0.2, 64).astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    yield "random", x, s, b, g
    x = rng.normal(0.3, 1.2, (1, 4, 4, 64)).astype(np.float32)
    x[0, :, :, 0:2] = 1.0
    b = rng.normal(0, 0.2, 64).astype(np.float32)
    b[0:2] = 0.0
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    yield "zero_variance_tie", x, np.ones(64, np.float32), b, g


def test_group_norm_function_matches_jax_custom_vjp():
    """The port's gradient against the JAX package's custom VJP of
    ``fused_group_norm_relu`` (jax.vjp of its reference), float32, NHWC
    on the JAX side: within 1e-5 of the largest magnitude (the
    statistics' sums run in different orders). Both cases of
    ``_gn_vjp_cases``, the second a ReLU input of exactly 0."""
    for name, x, s, b, g in _gn_vjp_cases():
        _, vjp = jax.vjp(lambda *a: fused_group_norm_relu(*a, 32, 1e-5),
                         jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
        want = vjp(jnp.asarray(g))
        ins = [torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
               torch.from_numpy(s), torch.from_numpy(b)]
        ins = [t.requires_grad_(True) for t in ins]
        y = gn.GroupNormReLU.apply(*ins, 32, 1e-5, gn.group_norm_relu_plain)
        y.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
        got = [ins[0].grad.permute(0, 2, 3, 1), ins[1].grad, ins[2].grad]
        for gt, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(gt.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
        if name == "zero_variance_tie":
            half = 0.5 * g[0, :, :, 0:2].sum(axis=(0, 1))
            np.testing.assert_allclose(got[2][0:2].numpy(), half,
                                       rtol=1e-6)


# ---- the loop ---------------------------------------------------------

# the loop's tests need no parity: a ResNet of an eighth of R-50's
# widths keeps their steps and checkpoints small
SLIM = ["MODEL.RESNETS.WIDTH_PER_GROUP", 8,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 32]


def _port_run(tmp_path, max_iter, seeds, start_iter=0, resume=None,
              nan=False):
    """do_train over the batches of ``seeds`` from the seeded params of a
    slim PAA-R50; returns (state, lagged metrics by iteration)."""
    _, cfg = _cfgs(SLIM + ["SOLVER.MAX_ITER", max_iter,
                           "SOLVER.CHECKPOINT_PERIOD", 2])
    model = build_detection_model(cfg, device="cpu", seed=3)
    optimizer, _ = make_optimizer(cfg, model.module)
    state = TrainState(model.module, optimizer)
    ckpt = Checkpointer(str(tmp_path), logger=logging.getLogger("test"))
    if resume is not None:
        ckpt.load(state, resume)
    if nan:
        with torch.no_grad():
            model.module.head.cls_logits.bias[0] = float("nan")
    seen = {}
    do_train(cfg, model, state, [_batch(s) for s in seeds], ckpt,
             start_iter=start_iter,
             metric_hook=lambda i, m: seen.update({i: m}))
    return state, seen


def test_do_train_checkpoints_and_resumes(tmp_path):
    state, seen = _port_run(tmp_path, 3, [1, 2, 3])
    assert state.step == 3
    assert sorted(seen) == [1, 2, 3]  # the last once the loop ends
    assert all(np.isfinite(m["loss"]) and m["num_pos"] > 0
               for m in seen.values())
    assert sorted(os.listdir(tmp_path)) == [
        "last_checkpoint", "model_0000002", "model_final"]
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.has_checkpoint()
    assert ckpt.get_checkpoint_file() == "model_final"
    final = {k: v.clone() for k, v in state.module.state_dict().items()}

    # resume from the iteration-2 checkpoint: the third step again
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    again, _ = _port_run(resumed_dir, 3, [3], start_iter=2,
                         resume=str(tmp_path / "model_0000002"))
    assert again.step == 3
    for k, v in again.module.state_dict().items():
        torch.testing.assert_close(v, final[k], rtol=0, atol=1e-6)
    assert Checkpointer(str(resumed_dir)).get_checkpoint_file() == \
        "model_final"
    extra = Checkpointer(str(tmp_path)).load(again)  # the pointer's file
    assert extra == {"iteration": 3} and again.step == 3


def test_do_train_raises_on_a_nan_loss(tmp_path):
    with pytest.raises(FloatingPointError, match="iteration 1"):
        _port_run(tmp_path, 3, [1, 2, 3], nan=True)


def test_entry_points_need_a_card_unless_told_cpu():
    _, cfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detection_model(cfg)

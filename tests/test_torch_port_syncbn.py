"""SyncBatchNorm (MODEL.USE_SYNCBN) in the PyTorch port against the JAX
package, on the CPU: the layer against flax's ``nn.BatchNorm`` as the
JAX package configures it (paa_tpu/modeling/layers.py SyncBatchNorm), a
PAA-R50 train step on the narrow config of
tests/test_syncbn.py::test_syncbn_model_train_step (64 FPN channels, one
tower conv, 2 x 64 x 96), the train and eval modes a model goes through
(a step after an eval uses batch statistics again), the solver's labels
(a SyncBN affine trains, a FrozenBN tensor does not), ``load_jax_params``
of the ``batch_stats`` tree, checkpoints, and two gloo ranks of 2 images
against one process of 4 (tests/torch_port_dist_worker.py).

Limits, each with its reason:
- the layer: outputs, gradients and running statistics within 1e-5 of
  each tensor's largest magnitude (float32 sums of x and x^2 in other
  orders); under a bfloat16 input both sides return float32;
- the PAA step: num_pos and the positive mask equal, losses within 1e-5
  relative, updated parameters within 1e-6 (tests/test_torch_port_train.py's
  limits), the applied gradients within 1e-3 of each tensor's largest
  magnitude, P7's within 1e-2 (the two-stage tests' limit: BatchNorm's
  backward couples every element of a channel through its batch mean
  and variance, so the float32 summation orders of the two sides reach
  whole channels; the step's body ReLUs take the same decisions on both
  sides, ``pinned_body_relus``), the running statistics after the step
  within 1e-4 of each tensor's largest magnitude (they average the
  activations, which agree to 1e-4 as the features of
  tests/test_torch_port_model.py do);
- eval after train, checkpoints: equal bit for bit (the same process and
  arithmetic);
- two ranks against one, every rank's body ReLUs taking the one
  process's decisions on its rows (the all-reduce sums the ranks'
  partial sums in another order): tests/test_torch_port_distributed.py's
  limits (losses within 1e-5 relative, parameters within 1e-6), the
  running statistics and the normalized activations of a SyncBatchNorm
  within 1e-4 of their largest magnitude, every rank's statistics equal.
"""

import contextlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.layers import SyncBatchNorm as JSyncBatchNorm
from paa_tpu.modeling.paa_loss import PAALossConfig as JPAALossConfig
from paa_tpu.modeling.paa_loss import paa_loss as jax_paa_loss
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.solver import param_labels as jax_param_labels
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.layers import FrozenBatchNorm, SyncBatchNorm
from paa_tpu_torch.modeling.paa_loss import PAALossConfig, paa_loss
from paa_tpu_torch.solver import make_optimizer, param_labels
from paa_tpu_torch.utils import load_jax_params
from paa_tpu_torch.utils.checkpoint import Checkpointer, load_weights
from test_torch_port_dense_heads import _head_init_scale
from test_torch_port_distributed import WORLD, _global_batch, _spawn, _wait
from test_torch_port_model import _seeded_params
from test_torch_port_train import (  # noqa: F401 (_one_thread: autouse)
    HW, OVERRIDES, _applied_gradients, _batch, _cfgs, _in_port_layout,
    _one_thread, _to_np, _with_pos_mask)

SYNCBN = ["MODEL.USE_SYNCBN", True, "MODEL.PAA.NUM_CONVS", 1]


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _stats(tree, rng, path=()):
    """A flax ``batch_stats`` shape tree filled from ``rng``: means
    normal(0, 0.1), variances in [0.5, 2]."""
    if isinstance(tree, dict):
        return {k: _stats(v, rng, path + (k,)) for k, v in tree.items()}
    if path[-1] == "var":
        return rng.uniform(0.5, 2.0, tree.shape).astype(np.float32)
    return rng.normal(0.0, 0.1, tree.shape).astype(np.float32)


# ---- the layer --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sync_batch_norm_matches_flax(dtype):
    """Two training calls (batch statistics, the running ones moved by
    0.9 / 0.1 with the biased variance), then eval (the running ones):
    outputs, the gradients of x, scale and bias, and the running
    statistics against flax; the output float32 under a bfloat16 input
    on both sides."""
    rng = np.random.RandomState(0)
    xs = [rng.normal(2.0, 3.0, (4, 5, 6, 8)).astype(np.float32)
          for _ in range(3)]
    up = rng.normal(0, 1, (4, 5, 6, 8)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jbn = JSyncBatchNorm(8)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0], jdt))
    params = _seeded_params(jax.tree.map(np.asarray, variables["params"]),
                            rng)
    stats = _stats(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    bn = load_jax_params(SyncBatchNorm(8), {"bn": params["bn"]},
                         {"bn": stats["bn"]})
    bn.train()
    for x in xs[:2]:
        def f(p, xx, s=stats):
            y, mut = jbn.apply({"params": p, "batch_stats": s}, xx,
                               mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * up), (y, mut)
        jx = jnp.asarray(x, jdt)
        (_, (want, mut)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, jx)
        stats = jax.tree.map(np.asarray, mut["batch_stats"])
        tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(tdt)
        tx = tx.permute(0, 3, 1, 2).detach().requires_grad_()
        for p in bn.parameters():
            p.grad = None
        got = bn(tx)
        (got * torch.from_numpy(up).permute(0, 3, 1, 2)).sum().backward()
        assert want.dtype == jnp.float32 and got.dtype == torch.float32
        _close(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-5)
        _close(tx.grad.float().permute(0, 2, 3, 1).numpy(),
               np.asarray(gx, np.float32), 1e-5 if dtype == "float32"
               else 1e-2)  # the bf16 cotangent rounds on both sides
        _close(bn.weight.grad.numpy(), gp["bn"]["scale"], 1e-5)
        _close(bn.bias.grad.numpy(), gp["bn"]["bias"], 1e-5)
        _close(bn.running_mean.numpy(), stats["bn"]["mean"], 1e-6)
        _close(bn.running_var.numpy(), stats["bn"]["var"], 1e-6)
    bn.eval()
    jx = jnp.asarray(xs[2], jdt)
    want = jbn.apply({"params": params, "batch_stats": stats}, jx)
    with torch.no_grad():
        got = bn(torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
            tdt).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-5)
    assert "num_batches_tracked" not in bn.state_dict()


def test_load_jax_params_needs_the_batch_stats():
    jbn = JSyncBatchNorm(4)
    variables = jax.tree.map(np.asarray, jbn.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 2, 4))))
    with pytest.raises(KeyError, match="batch_stats"):
        load_jax_params(SyncBatchNorm(4), variables["params"])
    with pytest.raises(KeyError, match="mean"):
        load_jax_params(SyncBatchNorm(4), variables["params"],
                        {"bn": {"var": np.ones(4, np.float32)}})
    bn = load_jax_params(SyncBatchNorm(4), variables["params"],
                         variables["batch_stats"])
    assert torch.equal(bn.running_var, torch.ones(4))


# ---- the PAA-R50 step -------------------------------------------------------

def _seeded(jmodel):
    """Seeded params (the head's at its init's scale,
    ``_head_init_scale``: at the kaiming scale over the body's normalized
    features its cls loss is ~1e2 and its P6/P7 gradients keep few
    digits on either side) and running statistics."""
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))
    params = _seeded_params(variables["params"], np.random.RandomState(0))
    _head_init_scale(params["head"], np.random.RandomState(1))
    return params, _stats(variables["batch_stats"], np.random.RandomState(5))


def _port_model(cfg, params, stats):
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params, stats)
    return model


class _Proxy:
    """A module's namespace with some names replaced."""

    def __init__(self, base, **names):
        self._base = base
        self.__dict__.update(names)

    def __getattr__(self, name):
        return getattr(self._base, name)


@contextlib.contextmanager
def pinned_body_relus(record=None, pin=None):
    """The ResNet bodies' ReLUs, patched in both packages: with ``record``
    (a list) the port's append each call's decision (x <= 0) as an NHWC
    numpy mask; with ``pin`` (such a list) the JAX package's k-th call
    (in trace order, the forward's) takes the k-th decision. BatchNorm on
    batch statistics centres every ReLU input of the body at 0, so
    float32 rounding puts elements on either side of the kink on the
    two sides, and the BatchNorm backward spreads each such element's
    gradient over its whole channel: the steps are compared at the same
    decisions."""
    from flax import linen
    from paa_tpu.modeling import resnet as jresnet
    from paa_tpu_torch.modeling import resnet

    calls = [0]

    def port_relu(x):
        below = x <= 0
        record.append(below.permute(0, 2, 3, 1).numpy())
        return torch.where(below, 0.0, x)

    def jax_relu(x):
        below = pin[calls[0]]
        calls[0] += 1
        return jnp.where(below, 0.0, x)

    with pytest.MonkeyPatch.context() as mp:
        if record is not None:
            mp.setattr(resnet, "F", _Proxy(resnet.F, relu=port_relu))
        if pin is not None:
            mp.setattr(jresnet, "nn", _Proxy(linen, relu=jax_relu))
        yield calls


@pytest.fixture(scope="module")
def syncbn_step():
    """One ``make_bucket_train_step`` step of each package from the same
    params, running statistics and batch, each loss also reporting its
    positive mask."""
    jcfg, cfg = _cfgs(SYNCBN)
    jmodel = jax_build(jcfg)
    params, stats = _seeded(jmodel)
    batch = _batch(2)
    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx,
                                batch_stats=jax.tree.map(jnp.asarray, stats))
    jmodel.loss_fn = lambda: (_with_pos_mask(jax_paa_loss),
                              JPAALossConfig.from_cfg(jcfg))
    model = _port_model(cfg, params, stats)
    model.loss_fn = lambda: (_with_pos_mask(paa_loss),
                             PAALossConfig.from_cfg(cfg))
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    decisions = []
    with pinned_body_relus(record=decisions):
        metrics = {k: v.numpy() for k, v in model.make_bucket_train_step(
            HW)(state, batch).items()}
    jparams = jstate.params
    with pinned_body_relus(pin=decisions) as calls:
        jstep = jax.jit(jmodel.make_bucket_train_step(
            HW, param_label_tree=labels))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    assert calls[0] == len(decisions) == 49  # the stem, 16 blocks x 3
    jmetrics = jax.tree.map(np.asarray, jmetrics)
    return {"jax": {"pos_mask": jmetrics.pop("pos_mask"),
                    "metrics": jmetrics, "params": _to_np(jstate.params),
                    "stats": _to_np(jstate.batch_stats),
                    "grads": _applied_gradients(jstate.opt_state, jparams,
                                                labels, jcfg)},
            "port": {"pos_mask": metrics.pop("pos_mask"),
                     "metrics": metrics},
            "model": model, "params": params, "stats": stats}


def test_syncbn_paa_train_step_matches_jax(syncbn_step):
    got, want, model = (syncbn_step["port"], syncbn_step["jax"],
                        syncbn_step["model"])
    norms = [m for m in model.module.modules()
             if isinstance(m, SyncBatchNorm)]
    assert len(norms) == 53 and not any(
        isinstance(m, FrozenBatchNorm) for m in model.module.modules())
    assert int(got["metrics"]["num_pos"]) == \
        int(want["metrics"]["num_pos"]) > 0
    np.testing.assert_array_equal(got["pos_mask"], want["pos_mask"])
    for k, v in want["metrics"].items():
        if k != "num_pos":
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
    grads = _in_port_layout_stats(model, want["grads"], syncbn_step["stats"])
    trained = 0
    for name, p in model.module.named_parameters():
        if not p.requires_grad:
            assert name.startswith(("backbone.resnet.stem.",
                                    "backbone.resnet.layer1_")), name
            continue
        trained += 1
        w = grads[name].numpy()
        share = 1e-2 if name.startswith("backbone.fpn.p7.") else 1e-3
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=share * np.abs(w).max(),
                                   err_msg=name)
    assert trained > 150
    after = _in_port_layout_stats(model, want["params"], want["stats"])
    for name, t in model.module.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            _close(t.numpy(), after[name].numpy(), 1e-4)
        else:
            np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def _in_port_layout_stats(model, tree, stats):
    scratch = build_detection_model(model.cfg, device="cpu")
    load_jax_params(scratch.module, tree, stats)
    return dict(scratch.module.state_dict())


# ---- train and eval modes ---------------------------------------------------

def test_a_step_after_an_eval_uses_batch_statistics(syncbn_step):
    """Train, evaluate, train again: the second step equals a second step
    taken with no eval between (each step puts the module in training
    mode; each eval call in eval mode, whose outputs use the running
    statistics and move nothing)."""
    cfg = syncbn_step["model"].cfg
    params, stats = syncbn_step["params"], syncbn_step["stats"]
    batch = _batch(2)
    runs = []
    for with_eval in (False, True):
        model = _port_model(cfg, params, stats)
        state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
        step = model.make_bucket_train_step(HW)
        step(state, batch)
        assert model.module.training
        if with_eval:
            before = {k: v.clone() for k, v in
                      model.module.state_dict().items()}
            det = model.make_eval_fn()(torch.from_numpy(batch["images"]),
                                       torch.from_numpy(batch["image_sizes"]))
            assert not model.module.training
            assert all(torch.equal(v, before[k]) for k, v in
                       model.module.state_dict().items())
            assert det["boxes"].shape == (2, 10, 4)
        metrics = step(state, batch)
        assert model.module.training
        runs.append(({k: float(v) for k, v in metrics.items()},
                     model.module.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_eval_uses_the_running_statistics(syncbn_step):
    cfg = syncbn_step["model"].cfg
    model = _port_model(cfg, syncbn_step["params"], syncbn_step["stats"])
    bn = model.module.backbone.resnet.layer2_0.bn1
    seen = []
    bn.register_forward_hook(lambda m, i, o: seen.append((i[0], o)))
    batch = _batch(2)
    model.make_eval_fn()(torch.from_numpy(batch["images"]),
                         torch.from_numpy(batch["image_sizes"]))
    x, y = seen[0]
    scale = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
    want = (x - bn.running_mean[:, None, None]) * scale[:, None, None] \
        + bn.bias[:, None, None]
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)


# ---- labels -----------------------------------------------------------------

@pytest.mark.parametrize("syncbn", [True, False])
def test_syncbn_affine_trains_frozen_bn_does_not(syncbn):
    """Every labelled tensor's label equals its JAX leaf's, for the SyncBN
    body (``bnX.weight`` / ``.bias`` "weight" / "bias" outside the frozen
    stages, as ``bnX/bn/scale``; its running statistics, JAX
    ``batch_stats``, unlabelled and never in the optimizer) and the
    FrozenBN body (every ``bnX`` tensor "frozen"). A rule that calls a
    module with running statistics a FrozenBatchNorm would freeze the
    SyncBN affines."""
    jcfg, cfg = _cfgs(SYNCBN if syncbn else [])
    jmodel = jax_build(jcfg)
    variables = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))
    leaves, treedef = jax.tree.flatten(variables["params"])
    ids = jax.tree.unflatten(treedef, [
        np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    want = jax.tree.leaves(jax_param_labels(ids, 2))
    model = build_detection_model(cfg, device="cpu")
    stats = (jax.tree.map(lambda s: np.ones(s.shape, np.float32),
                          variables["batch_stats"]) if syncbn else None)
    load_jax_params(model.module, ids, stats)
    got = param_labels(model.module, 2)
    assert len(got) == len(leaves)
    state = model.module.state_dict()
    for name, label in got.items():
        assert label == want[int(state[name].flatten()[0])], name
    bn1 = "backbone.resnet.layer2_0.bn1"
    if syncbn:
        assert got[f"{bn1}.weight"] == "weight"
        assert got[f"{bn1}.bias"] == "bias"
        assert f"{bn1}.running_mean" not in got
        assert got["backbone.resnet.stem.bn1.weight"] == "frozen"
        optimizer, _ = make_optimizer(cfg, model.module)
        trained = {id(p) for g in optimizer.param_groups for p in g["params"]}
        assert id(model.module.backbone.resnet.layer3_0.bn3.weight) in trained
    else:
        assert got[f"{bn1}.weight"] == got[f"{bn1}.running_var"] == "frozen"


# ---- checkpoints ------------------------------------------------------------

def test_running_statistics_travel_in_checkpoints(tmp_path, syncbn_step):
    """A checkpoint of a trained SyncBN model holds its running
    statistics; ``load_weights`` (test_net's) brings them back, and the
    restored model evaluates as the trained one."""
    cfg = syncbn_step["model"].cfg
    model = _port_model(cfg, syncbn_step["params"], syncbn_step["stats"])
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    batch = _batch(2)
    model.make_bucket_train_step(HW)(state, batch)
    Checkpointer(str(tmp_path)).save("model_final", state, iteration=1)
    with open(tmp_path / "model_final", "rb") as f:
        saved = torch.load(f, weights_only=True)["model"]
    bn = "backbone.resnet.layer3_0.bn2"
    assert torch.equal(saved[f"{bn}.running_var"],
                       model.module.state_dict()[f"{bn}.running_var"])
    restored = build_detection_model(cfg, device="cpu", seed=3)
    assert load_weights(restored.module, str(tmp_path / "model_final")) == \
        {"iteration": 1}
    args = (torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["image_sizes"]))
    want, got = model.make_eval_fn()(*args), restored.make_eval_fn()(*args)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---- two ranks --------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, syncbn_step):
    """The two ranks' SyncBN step (2 images each, through
    torch_port_dist_worker.py) beside one process's on the 4 images,
    every rank's body ReLUs taking the one process's decisions on its
    rows (``pinned_body_relus``)."""
    root = str(tmp_path_factory.mktemp("port_syncbn_dist"))
    params, stats = syncbn_step["params"], syncbn_step["stats"]
    batch = _global_batch(2)
    record = "backbone.resnet.layer3_0.bn2"
    model = _port_model(syncbn_step["model"].cfg, params, stats)
    model.loss_fn = lambda: (_with_pos_mask(paa_loss),
                             PAALossConfig.from_cfg(model.cfg))
    seen = []
    model.module.get_submodule(record).register_forward_hook(
        lambda m, i, o: seen.append(o.detach().clone()))
    state = TrainState(model.module, make_optimizer(model.cfg,
                                                    model.module)[0])
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    decisions = []
    with pinned_body_relus(record=decisions):
        metrics = model.make_bucket_train_step(HW)(state, batch)
    one = {"metrics": {k: float(v) for k, v in metrics.items()
                       if k != "pos_mask"}, "before": before,
           "state": {k: v.clone() for k, v in
                     model.module.state_dict().items()},
           "normalized": seen[0]}
    job = {"train_overrides": OVERRIDES + SYNCBN, "params": params,
           "batch_stats": stats, "batch": batch,
           "ckpt_dir": os.path.join(root, "ckpt"), "record": record,
           "relu_pins": decisions}
    os.makedirs(job["ckpt_dir"])
    job_path, out_path = (os.path.join(root, "job.pkl"),
                          os.path.join(root, "out.pkl"))
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    _wait(_spawn(job_path, out_path))
    ranks = []
    for rank in range(WORLD):
        with open(f"{out_path}.{rank}", "rb") as f:
            ranks.append(pickle.load(f))
    return one, ranks


def test_two_ranks_sync_batch_statistics(two_ranks):
    """Two gloo ranks of 2 images give one process of 4's normalized
    activations (each rank's rows), running statistics, losses and
    update: the statistics are the global batch's."""
    one, ranks = two_ranks
    stats_names = [k for k in one["state"] if k.endswith("running_var")]
    assert len(stats_names) == 53
    for rank, out in enumerate(ranks):
        assert out["ddp"]
        _close(out["normalized"], one["normalized"][rank::WORLD].numpy(),
               1e-4)
        for k, v in one["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        for name, want in one["state"].items():
            got, before = out["state"][name], one["before"][name].numpy()
            if name.endswith(("running_mean", "running_var")):
                _close(got, want.numpy(), 1e-4)
            elif torch.equal(want, one["before"][name]):  # frozen
                np.testing.assert_array_equal(got, before, err_msg=name)
            else:
                np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                           atol=1e-6, err_msg=name)
    # every rank holds the same statistics (DDP's broadcast_buffers copies
    # rank 0's before each forward: equal values)
    for name in stats_names:
        np.testing.assert_array_equal(ranks[0]["state"][name],
                                      ranks[1]["state"][name])

"""The VOC C4 training step from the serving phases' lifted foreground
bias, in both packages (narrow, CPU, float32).

The full-width bf16 VOC C4 model at B=1, started with its 20 foreground
cls_score biases drawn in [25, 35] (chip_smoke.py's ``seeded_voc``), sent
its box loss to NaN within 4 steps on the card. Here both packages take
4 steps at B=1 from the same weights (tests/test_torch_port_c4.py's
``c4_params``) with the same lift, on the first 4 batches of the train +
val stream (equal in both packages' loaders), with the JAX package's
sampler draws replayed: every loss term agrees within 1e-5 relative
(float32 sums in different orders; they agreed within 1e-6 when this was
written), and the loss jumps more than 10-fold at step 2 in both. The
divergence is the lift's, in ``paa_tpu``'s step as in the port's; at
this width in float32 neither reaches NaN in 4 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.data import loader as jloader
from paa_tpu.data import voc as jvoc
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu_torch.data import loader
from paa_tpu_torch.data.synth import synth_voc
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_two_stage_train import SEED, TRAIN, replay_draws
from test_torch_port_voc import (
    HW, SIZES, TRAIN_SIZE, _assert_batches_equal, _c4_models, _cfgs,
    _train_set)

STEPS = 4
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lifted(params):
    """``params`` with the foreground cls_score biases from seed 1 in
    [25, 35], as chip_smoke.py's ``seeded_voc`` lifts them."""
    bias = np.array(params["box_head"]["cls_score"]["bias"])
    bias[1:] = torch.empty(bias.size - 1).uniform_(
        25.0, 35.0, generator=torch.Generator().manual_seed(1)).numpy()
    params["box_head"]["cls_score"]["bias"] = bias
    return params


@pytest.fixture(scope="module")
def lifted_steps(tmp_path_factory):
    root = synth_voc(str(tmp_path_factory.mktemp("voc_lift") / "VOC2007"),
                     8, seed=3, sizes=SIZES)
    jcfg, cfg = _cfgs(TRAIN + TRAIN_SIZE + ["SOLVER.MAX_ITER", STEPS,
                                            "SOLVER.IMS_PER_BATCH", 1])
    batches = []
    for got, want in zip(
            loader.make_data_loader(cfg, _train_set(root), True),
            jloader.make_data_loader(jcfg, _train_set(root, jvoc), True)):
        _assert_batches_equal([got], [want])
        batches.append({k: got[k] for k in ("images", "image_sizes",
                                            "gt_boxes", "gt_labels")})
    assert len(batches) == STEPS
    jmodel, params, model = _c4_models(jcfg, cfg)
    params = _lifted(params)
    load_jax_params(model.module, params)
    tx, labels = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply,
                                jax.tree.map(jnp.asarray, params), tx)
    jstep = jax.jit(jmodel.make_bucket_train_step(HW,
                                                  param_label_tree=labels))
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    step = model.make_bucket_train_step(HW, draws=replay_draws(SEED))
    got, want = [], []
    for batch in batches:
        got.append({k: float(v) for k, v in step(state, batch).items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        want.append({k: float(v) for k, v in jm.items()})
    return batches, got, want


def test_lifted_voc_steps_match_jax_and_diverge_in_both(lifted_steps):
    batches, got, want = lifted_steps
    assert (batches[0]["gt_labels"] > 0).sum() > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        assert g["num_pos"] == w["num_pos"], i
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=RTOL,
                                       err_msg=f"step {i + 1} {k}")
    # the lift puts the classifier's loss near 30 at the first step; the
    # second step's update sends it past 300 in both packages
    for losses in (got, want):
        assert losses[0]["loss_classifier"] > 20
        assert losses[1]["loss"] > 10 * losses[0]["loss"]
        assert all(np.isfinite(m["loss"]) for m in losses)

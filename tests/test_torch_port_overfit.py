"""The overfit gate of the port (paa_tpu_torch/tools/quick_overfit.py)
against the JAX tool (tools/quick_overfit.py), on the CPU.

- ``make_dataset``: the same json, and each PPM image equal to the array
  the JAX tool hands to ``cv2.imwrite`` (captured by a monkeypatch: the
  JAX tool writes JPEG, whose decode differs).
- ``overfit_cfg``: every key the JAX tool's ``overfit_cfg`` assigns (read
  from its source) has the same value in the port's.
- Three iterations of each package's ``do_train`` on the gate's dataset
  and config, with the body narrowed (as tests/test_torch_port_data.py's
  ``do_train`` test narrows it; 128 FPN channels, the gate's width) and
  the JAX init carried across by ``load_jax_params``: the loss and each
  of its terms within 1e-5 relative at every iteration (float32 sums in
  different orders on the two sides; they agreed within 2e-7 here),
  num_pos equal.
- The full gate (slow, as tests/test_overfit.py): 1,500 iterations on
  the CPU with tests/test_overfit.py's four thresholds.
"""

import ast
import importlib.util
import logging
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from paa_tpu.data.coco import COCODataset as JCOCODataset
from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.engine.trainer import do_train as jax_do_train
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu.utils.comm import get_data_mesh
from paa_tpu_torch.data.coco import COCODataset, read_ppm
from paa_tpu_torch.data.loader import make_data_loader
from paa_tpu_torch.engine import TrainState, do_train
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.tools import quick_overfit
from paa_tpu_torch.utils import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "quick_overfit.py")
NARROW = {"MODEL.RESNETS.WIDTH_PER_GROUP": 8,
          "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
          "MODEL.RESNETS.RES2_OUT_CHANNELS": 32}
ITERS = 3
LOSS_RTOL = 1e-5


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_quick_overfit",
                                                  JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes (the test workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_make_dataset_matches_jax(tmp_path, monkeypatch):
    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, arr: written.update(
        {os.path.basename(path): arr.copy()}) or True)
    want_ann, _ = _jax_tool().make_dataset(str(tmp_path / "jax"))
    got_ann, got_dir = quick_overfit.make_dataset(str(tmp_path / "port"))
    with open(want_ann) as f:
        want = f.read()
    with open(got_ann) as f:
        assert f.read() == want
    assert sorted(written) == sorted(os.listdir(got_dir)) == \
        [f"img{i}.jpg" for i in range(8)]
    for name, arr in written.items():
        np.testing.assert_array_equal(read_ppm(os.path.join(got_dir, name)),
                                      arr)


def _assigned_keys(func_name):
    """The dotted cfg keys that ``func_name`` of the JAX tool assigns."""
    tree = ast.parse(open(JAX_TOOL).read())
    func = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == func_name)
    keys = []
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            parts = []
            while isinstance(target, ast.Attribute):
                parts.append(target.attr)
                target = target.value
            if parts and isinstance(target, ast.Name) and \
                    target.id == "cfg":
                keys.append(".".join(reversed(parts)))
    return keys


def _value(cfg, key):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


@pytest.mark.parametrize("max_iter", [1500, 7])
def test_overfit_cfg_matches_jax(tmp_path, max_iter):
    keys = _assigned_keys("overfit_cfg")
    assert len(keys) == 25
    want = _jax_tool().overfit_cfg(str(tmp_path), max_iter)
    got = quick_overfit.overfit_cfg(str(tmp_path), max_iter)
    for key in keys:
        assert _value(got, key) == _value(want, key), key


def _narrow(cfg):
    cfg.merge_from_list([v for kv in NARROW.items() for v in kv])
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def three_iterations(tmp_path_factory):
    """ITERS + 1 iterations of each package's do_train from the JAX init
    (the JAX loop hands its hook each iteration's metrics one iteration
    late, and not the last one's)."""
    root = tmp_path_factory.mktemp("overfit")
    ann_file, img_dir = quick_overfit.make_dataset(str(root))
    jax_tool = _jax_tool()

    jcfg = jax_tool.overfit_cfg(str(root / "jax"), ITERS + 1)
    # the JAX towers take fused_group_norm_relu, the kernel the port's
    # GroupNorm32 ports (two-pass variance; flax's one-pass variance
    # loses digits in P7's 4-element groups)
    jcfg.TPU.FUSED_GN = True
    jcfg = _narrow(jcfg)
    jmodel = jax_build(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), (64, 96))["params"]
    # a host copy: the JAX train step donates the state's buffers
    init = jax.tree.map(lambda a: np.array(a, np.float32), params)
    tx, _ = jax_make_optimizer(jcfg, params)
    jstate = JTrainState.create(jmodel.module.apply, params, tx)
    want = {}
    jax_do_train(jcfg, jmodel, jstate, JCOCODataset(ann_file, img_dir),
                 get_data_mesh(1), logger=logging.getLogger("test"),
                 metric_hook=lambda i, m: want.update({i: m}))

    cfg = _narrow(quick_overfit.overfit_cfg(str(root / "port"), ITERS + 1))
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, init)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    got = {}
    do_train(cfg, model, state,
             make_data_loader(cfg, COCODataset(ann_file, img_dir),
                              is_train=True),
             logger=logging.getLogger("test"),
             metric_hook=lambda i, m: got.update({i: m}))
    return got, want


def test_three_iterations_match_jax(three_iterations):
    got, want = three_iterations
    assert sorted(want) == list(range(1, ITERS + 1))
    assert sorted(got) == list(range(1, ITERS + 2))
    for i in want:
        assert int(got[i]["num_pos"]) == int(want[i]["num_pos"]) > 0, i
        for k, v in want[i].items():
            if k.startswith("loss"):
                np.testing.assert_allclose(got[i][k], v, rtol=LOSS_RTOL,
                                           err_msg=f"iteration {i} {k}")
    # an untrained start, as the gate asks
    assert got[1]["loss"] > 1.5


@pytest.mark.slow
def test_overfit_converges(tmp_path):
    """The gate of tests/test_overfit.py, through the port on the CPU."""
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    r = quick_overfit.run(1500, str(tmp_path), device="cpu")
    assert r["first_loss"] > 1.5, r  # starts untrained
    assert r["final_loss"] < 0.35, r
    assert r["ap50"] >= 0.95, r
    assert r["ap"] >= 0.85, r

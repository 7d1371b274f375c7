"""The serving artifact of the PyTorch port (``paa_tpu_torch/serving.py``)
against the live model and the JAX package, on the CPU, at
tests/test_serving.py's narrow PAA config (R-50 body, 64 FPN channels,
DETECTIONS_PER_IMG 10) and 2 x 64 x 96 float32 normalized input; and the
kernels' custom ops under ``torch.library.opcheck``.

- Export, save, load: the served labels and valid equal the live eval
  fn's, boxes and scores within 1e-5 (tests/test_serving.py's limit),
  in each of the post-processing's three tiers (the artifact chooses
  with ``torch.cond``, the live model on the host): the cls bias and
  PRE_NMS_TOP_N set so that the levels have at most 128, at most
  PRE_NMS_TOP_N and more thresholded candidates.
- Served against the JAX package's live eval fn on the JAX params
  carried across: as tests/test_torch_port_model.py (labels and valid
  equal, boxes and scores within 1e-3).
- ``python -m paa_tpu_torch.tools.export_model`` writes an artifact that
  a process importing only torch and ``paa_tpu_torch.serving`` serves.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.ops import group_norm, nms
from paa_tpu_torch.serving import (
    export_inference, load_exported, save_exported)
from paa_tpu_torch.utils import load_jax_params
from test_torch_port_model import HW, OVERRIDES, _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = np.asarray([[64.0, 96.0], [60.0, 90.0]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(get, extra=()):
    cfg = get()
    cfg.merge_from_list(OVERRIDES + list(extra))
    cfg.freeze()
    return cfg


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-2, 2, (2, *HW, 3)).astype(
        np.float32))


def _tiers(model, images, pp):
    """The tier each level of ``images`` takes in the post-processing:
    "small" (at most 128 thresholded candidates in every image), "k" (at
    most PRE_NMS_TOP_N), "top_k"."""
    th = math.log(pp.pre_nms_thresh) - math.log1p(-pp.pre_nms_thresh)
    with torch.no_grad():
        out = model.module(images.permute(0, 3, 1, 2).contiguous())
    _, counts = model.anchors_for(HW)
    tiers, start = [], 0
    c = out["cls_logits"].shape[-1]
    for n in counts:
        cand = (out["cls_logits"][:, start:start + n].float() > th)
        most = int(cand.reshape(2, -1).sum(1).max())
        k = min(pp.pre_nms_top_n, n * c)
        tiers.append("small" if most <= min(128, k) else
                     "k" if most <= k else "top_k")
        start += n
    return tiers


# (PRE_NMS_TOP_N, the cls_logits bias): the tiers the levels take
TIER_CASES = {"small": (1000, -3.3), "k": (1000, -3.0), "top_k": (50, -2.0)}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_export_roundtrip(tmp_path, case):
    top_n, bias = TIER_CASES[case]
    cfg = _cfg(get_cfg, ["MODEL.PAA.PRE_NMS_TOP_N", top_n])
    model = build_detection_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        model.module.head.cls_logits.bias.fill_(bias)
    images = _images()
    assert case in _tiers(model, images, model.postprocess_config())

    exported, meta = export_inference(model, 2, HW)
    path = str(tmp_path / "model.paat")
    save_exported(path, exported, meta)
    call, meta2 = load_exported(path, device="cpu")
    assert meta2 == meta
    assert meta2["input_shape"] == [2, *HW, 3]
    assert meta2["sizes_shape"] == [2, 2]
    assert meta2["outputs"] == ["boxes", "scores", "labels", "valid"]
    assert meta2["device"] == "cpu"

    live = model.make_eval_fn()(images, torch.from_numpy(SIZES))
    served = call(images, SIZES)
    assert set(served) == set(live)
    assert int(live["valid"].sum()) > 0
    for k in ("labels", "valid"):
        assert served[k].dtype == live[k].dtype
        torch.testing.assert_close(served[k], live[k], rtol=0, atol=0)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(served[k].numpy(), live[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def carried():
    """The JAX model and params, and the port's artifact exported from
    the params carried across."""
    jcfg = _cfg(jax_get_cfg)
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    model = build_detection_model(_cfg(get_cfg), device="cpu", seed=1)
    load_jax_params(model.module, params)
    exported, _ = export_inference(model, 2, HW)
    return jmodel, params, exported


def test_export_records_the_kernels_as_ops(carried):
    """The artifact's graph calls the custom ops, not their plain
    versions: one NMS and the head towers' 40 GroupNorm+ReLU."""
    targets = [str(n.target) for n in carried[2].graph.nodes
               if n.op == "call_function"]
    assert targets.count("paa_tpu_torch.nms_batched.default") == 1
    assert targets.count("paa_tpu_torch.group_norm_relu.default") == 40


def test_served_matches_jax_live_eval(carried):
    jmodel, params, exported = carried
    with torch.no_grad():
        served = exported.module()(_images(2), torch.from_numpy(SIZES))
    want = jmodel.make_eval_fn({"params": params})(
        jnp.asarray(_images(2).numpy()), jnp.asarray(SIZES))
    assert int(served["valid"].sum()) > 0
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(served[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(served[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-3, err_msg=k)


# a process that serves an artifact with torch and paa_tpu_torch.serving
# alone: no config, no model code
SERVE = """
import json, sys
import numpy as np
import torch
from paa_tpu_torch.serving import load_exported
call, meta = load_exported(sys.argv[1], device="cpu")
images = torch.from_numpy(np.load(sys.argv[2]))
out = call(images, torch.tensor([[64.0, 96.0]]))
loaded = sorted(m for m in sys.modules if m.startswith("paa_tpu"))
print(json.dumps({"meta": meta, "loaded": loaded,
                  **{k: v.tolist() for k, v in out.items()}}))
"""


def test_export_cli_then_serve_without_model_code(tmp_path):
    out = str(tmp_path / "m.paat")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.export_model",
         "--config-file",
         os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml"),
         "--output", out, "--batch", "1", "--height", "64", "--width", "96",
         "--device", "cpu",
         "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "64",
         "MODEL.PAA.PRE_NMS_TOP_N", "50", "TEST.DETECTIONS_PER_IMG", "10"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote" in proc.stderr + proc.stdout
    np.save(tmp_path / "img.npy", _images(3).numpy()[:1])
    proc = subprocess.run(
        [sys.executable, "-c", SERVE, out, str(tmp_path / "img.npy")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["meta"]["config_file"] == "paa_R_50_FPN_1x.yaml"
    assert res["meta"]["input_shape"] == [1, 64, 96, 3]
    assert not [m for m in res["loaded"]
                if m.startswith(("paa_tpu_torch.modeling",
                                 "paa_tpu_torch.config",
                                 "paa_tpu_torch.data"))]
    assert "paa_tpu" not in res["loaded"]
    assert np.asarray(res["boxes"]).shape == (1, 10, 4)
    assert np.asarray(res["labels"]).shape == (1, 10)


def test_load_rejects_a_foreign_file(tmp_path):
    path = tmp_path / "model.paax"
    path.write_bytes(b"PAATPU01" + b"\0" * 64)
    with pytest.raises(ValueError, match="not a paa_tpu_torch serving"):
        load_exported(str(path), device="cpu")


def test_load_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported(str(tmp_path / "absent.paat"))


def _nms_inputs(seed, bsz=2, n=60):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (bsz, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (bsz, n, 2))], 2)
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 1, (bsz, n)).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 3, (bsz, n)).astype(np.int32)),
            torch.from_numpy(rng.rand(bsz, n) > 0.2))


@pytest.mark.parametrize("aware", [True, False])
def test_nms_ops_pass_opcheck(aware):
    boxes, scores, labels, valid = _nms_inputs(int(aware))
    torch.library.opcheck(torch.ops.paa_tpu_torch.nms_batched.default,
                          (boxes, scores, labels, valid, 0.5, 12, aware))
    torch.library.opcheck(torch.ops.paa_tpu_torch.nms.default,
                          (boxes[0], scores[0], labels[0], valid[0], 0.5, 12,
                           aware))
    got = nms.nms_batched(boxes, scores, labels, valid, 0.5, 12, aware)
    want = nms.nms_batched_plain(boxes, scores, labels, valid, 0.5, 12,
                                 aware)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("grad", [False, True])
def test_group_norm_relu_op_passes_opcheck(relu, grad):
    """The op's forward, fake, and (with inputs that require grad) its
    registered autograd: the VJP of the plain version, equal to plain
    autograd's gradients."""
    rng = np.random.RandomState(int(relu))
    x = torch.from_numpy(rng.normal(size=(2, 64, 5, 7)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    ins = [t.clone().requires_grad_(grad) for t in (x, w, b)]
    torch.library.opcheck(torch.ops.paa_tpu_torch.group_norm_relu.default,
                          (*ins, 32, 1e-5, relu))
    if grad:
        y = torch.ops.paa_tpu_torch.group_norm_relu(*ins, 32, 1e-5, relu)
        g = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
        got = torch.autograd.grad(y, ins, g)
        ref = [t.detach().clone().requires_grad_() for t in ins]
        want = torch.autograd.grad(group_norm.group_norm_relu_plain(
            *ref, 32, 1e-5, relu), ref, g)
        for a, e in zip(got, want):
            assert torch.equal(a, e)


def test_export_two_stage_roundtrip(tmp_path):
    """A narrow Faster R-CNN (test_torch_port_two_stage.py's config, every
    roi kept by ROI_HEADS.SCORE_THRESH 0): the artifact records the RPN's
    and the box head's NMS as ops and serves what the live eval fn
    gives (labels and valid equal, boxes and scores within 1e-5)."""
    from test_torch_port_two_stage import CONFIG
    from test_torch_port_two_stage import OVERRIDES as TWO_STAGE

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, CONFIG))
    cfg.merge_from_list(TWO_STAGE + ["MODEL.ROI_HEADS.SCORE_THRESH", 0.0])
    cfg.freeze()
    model = build_detection_model(cfg, device="cpu", seed=0)
    exported, meta = export_inference(model, 2, HW)
    targets = [str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count("paa_tpu_torch.nms_batched.default") == 2
    path = str(tmp_path / "frcnn.paat")
    save_exported(path, exported, meta)
    call, _ = load_exported(path, device="cpu")
    live = model.make_eval_fn()(_images(4), torch.from_numpy(SIZES))
    served = call(_images(4), SIZES)
    assert int(live["valid"].sum()) > 0
    for k in ("labels", "valid"):
        torch.testing.assert_close(served[k], live[k], rtol=0, atol=0)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(served[k].numpy(), live[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)

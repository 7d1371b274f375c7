"""The port's benchmark tools (paa_tpu_torch/tools/bench*.py) on the CPU,
held against the JAX package's (bench.py, tools/bench_*.py).

- The flagship at bench.py's overrides (read from bench.py's source), at
  full width: its parameters carried across from ``jax.eval_shape`` of
  ``paa_tpu``'s model by ``load_jax_params``, which requires every leaf
  used, every port tensor set and every shape equal; the counts equal,
  about 32.4M.
- The timed call (``DetectionModel.detect``, forward and PAA
  post-processing) at a narrow width (64 FPN channels, one tower conv,
  64x96, B=2, float32) on bench.py's seed-0 uniform(-128, 128) inputs,
  with and without the cls-bias lift, against ``paa_tpu``'s
  ``model.module.apply`` + ``paa_postprocess`` (bench.py:73-80) with
  ``paa_tpu``'s init carried across: labels and valid equal, boxes and
  scores within rtol and atol 1e-5 (tests/test_torch_port_postprocess.py's
  tolerance); the tool's detection count is the call's.
- The TTA bucket bound against tools/bench_tta.py's
  ``x152_compile_bound``: (26, 13, the same sorted shapes).
- The loader's dataset against tools/bench_loader.py's at the same
  seed: the same annotation json, images that decode to equal arrays;
  the CLI's last line without the "cores needed" keys unless both card
  rates are given.
- The loader CLI exits with both numbers named, before timing, when no
  training bucket gets a whole batch (the train loader would wait
  forever).
- The device rule: with no card each tool exits non-zero unless
  ``--device cpu`` is given; with it each prints its last line with the
  JAX tool's keys and ``device`` (the model tools at a narrow
  config).
- ``bench_dcnv2``'s train step at a narrow width: a finite loss.
"""

import ast
import contextlib
import importlib.util
import io
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.paa_inference import (
    PostProcessConfig as JaxPostProcessConfig,
    paa_postprocess as jax_paa_postprocess,
)
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.tools import bench, bench_dcnv2, bench_loader, bench_tta
from paa_tpu_torch.tools.bench_common import lift_cls_bias
from paa_tpu_torch.utils import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (64, 96)
NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
          "MODEL.PAA.NUM_CONVS", 1, "TPU.COMPUTE_DTYPE", "float32"]
# a narrow dcnv2 R-101: every stage's depth, thin widths
NARROW_BODY = ["MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
               "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
               "MODEL.RESNETS.RES2_OUT_CHANNELS", 32]
DCNV2_CONFIG = os.path.join(ROOT, "configs", "paa",
                            "paa_dcnv2_R_101_FPN_2x.yaml")
# the JAX tools' last-line keys (bench.py:104-114, tools/bench_dcnv2.py:
# 175-185, tools/bench_tta.py:121-128 less its compile keys,
# tools/bench_loader.py:209-225 less its "cores needed" keys)
JAX_KEYS = {
    "bench": ("metric", "value", "unit", "vs_baseline"),
    "bench_dcnv2": ("metric", "value", "unit", "batch", "first_call_s"),
    "bench_tta": ("metric", "value", "unit", "augs"),
    "bench_loader": ("stages_ms", "per_img_ms", "img_per_s_per_core",
                     "loader", "host_cores"),
}
CORES_KEYS = ("cores_for_eval", "cores_for_train")


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
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


def _bench_py_overrides():
    """{cfg key: value} of bench.py's ``cfg.X.Y = value`` lines whose
    value is a constant (BENCH_FUSED_GN's environment read is left out)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Constant)):
            target = ast.unparse(node.targets[0])
            if target.startswith("cfg."):
                out[target[len("cfg."):]] = node.value.value
    return out


def _narrow_bench_cfg(*extra, bench_cfg=bench.bench_cfg):
    cfg = bench_cfg()
    cfg.defrost()
    cfg.merge_from_list(NARROW + list(extra))
    cfg.freeze()
    return cfg


def _jax_cfg(opts):
    cfg = jax_get_cfg()
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def test_bench_overrides_are_bench_py_s():
    got = dict(zip(bench.OVERRIDES[::2], bench.OVERRIDES[1::2]))
    assert got == _bench_py_overrides()


def test_flagship_parameters_equal_paa_tpu_s():
    jmodel = jax_build(_jax_cfg(bench.OVERRIDES))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    model = build_detection_model(bench.bench_cfg(), device="cpu")
    load_jax_params(model.module, zeros)  # strict: names and shapes
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes))
    n_port = sum(t.numel() for t in model.module.state_dict().values())
    assert n_port == n_jax
    assert 32.3e6 < n_port < 32.5e6, n_port


@pytest.fixture(scope="module")
def narrow_pair():
    """The narrow bench model of each package, ``paa_tpu``'s init
    carried across, and bench.py's inputs."""
    cfg = _narrow_bench_cfg()
    jmodel = jax_build(_jax_cfg(bench.OVERRIDES + NARROW))
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0), HW)["params"])
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module, params)
    anchors, counts = jmodel.anchors_for(HW)
    pp = JaxPostProcessConfig.from_cfg(jmodel.cfg)

    @jax.jit
    def infer(variables, images, sizes):
        outputs = jmodel.module.apply(variables, images)
        return jax_paa_postprocess(outputs, sizes, jnp.asarray(anchors),
                                   counts, pp)

    return jmodel, params, model, infer


@pytest.mark.parametrize("lift", [False, True])
def test_timed_call_matches_bench_py_s(narrow_pair, lift):
    _, params, model, infer = narrow_pair
    params = dict(params, head=dict(params["head"]))
    if lift:
        lift_cls_bias(model)
        params["head"]["cls_logits"] = dict(
            params["head"]["cls_logits"],
            bias=model.module.head.cls_logits.bias.detach().numpy().copy())
    else:
        load_jax_params(model.module, params)
    images, sizes = bench.serving_inputs(2, HW, "cpu")
    rng = np.random.RandomState(0)
    want = infer({"params": params},
                 jnp.asarray(rng.uniform(-128, 128, (2, *HW, 3))
                             .astype(np.float32)),
                 jnp.asarray(sizes.numpy()))
    with torch.inference_mode():
        got = model.detect(images, sizes)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    if lift:
        assert int(np.asarray(want["valid"]).sum()) > 0
    r = bench.serve(model, HW, 2, 1, torch.device("cpu"))
    assert r["work_per_image"]["detections"] == \
        float(np.asarray(want["valid"]).sum()) / 2
    assert r["launches"] == {"nms_batched": 0, "nms_global": 0,
                             "group_norm_relu": 0,
                             "deform_im2col": 0,  # plain versions
                             "deform_col2im": 0,
                             "roi_align": 0,  # PAA pools no rois
                             "roi_align_rois": 0}


def test_tta_bucket_bound_equals_bench_tta_s(monkeypatch):
    monkeypatch.chdir(ROOT)  # the JAX tool reads its config relatively
    want = _load("jax_bench_tta", "tools/bench_tta.py").x152_compile_bound()
    got = bench_tta.x152_bucket_bound()
    assert got == want
    assert got[:2] == (26, 13)


def test_loader_dataset_equals_bench_loader_s(tmp_path):
    jax_tool = _load("jax_bench_loader", "tools/bench_loader.py")
    got_ann, got_dir = bench_loader.synth_dataset(str(tmp_path / "port"), 8)
    want_ann, want_dir = jax_tool.synth_dataset(str(tmp_path / "jax"), 8)
    with open(got_ann) as f, open(want_ann) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    for image in want["images"]:
        name = image["file_name"]
        a = cv2.imread(os.path.join(got_dir, name), cv2.IMREAD_COLOR)
        b = cv2.imread(os.path.join(want_dir, name), cv2.IMREAD_COLOR)
        assert a.shape == (image["height"], image["width"], 3)
        np.testing.assert_array_equal(a, b)


def _last_line(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("rates", [False, True])
def test_loader_cli_cores_keys_only_with_card_rates(tmp_path, rates):
    argv = ["--device", "cpu", "--images", "8", "--threads", "1,2",
            "--batches", "1", "--batch-size", "2", "--root", str(tmp_path)]
    if rates:
        argv += ["--card-eval-img-s", "200", "--card-train-img-s", "60"]
    r = _last_line(bench_loader.main, argv)
    assert all(k in r for k in JAX_KEYS["bench_loader"])
    assert set(r["loader"]) == {"1", "2"}
    assert r["value"] == r["img_per_s_per_core"] > 0
    assert r["device"]["name"] == "cpu"
    assert all((k in r) == rates for k in CORES_KEYS)
    if rates:
        assert r["cores_for_eval"] == pytest.approx(
            200 / r["img_per_s_per_core"])


def test_loader_cli_refuses_a_batch_no_bucket_fills(tmp_path):
    # 16 images at COCO_SIZES: 14 land in the 800 x 1344 bucket, 2 in
    # 1344 x 800, so no training batch of 16 ever forms
    argv = ["--device", "cpu", "--images", "16", "--threads", "1",
            "--batches", "1", "--batch-size", "16", "--root", str(tmp_path)]
    with pytest.raises(SystemExit, match="batch of 16 .* gets 14 of the 16"):
        bench_loader.main(argv)


def _narrow_dcnv2_yaml(path):
    cfg = bench_dcnv2.load_cfg(DCNV2_CONFIG)
    cfg.defrost()
    cfg.merge_from_list(NARROW + NARROW_BODY)
    with open(path, "w") as f:
        f.write(cfg.dump())
    return str(path)


@pytest.mark.parametrize("tool", ["bench", "bench_dcnv2", "bench_tta",
                                    "bench_loader"])
def test_device_rule(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "bench": ["--batch", "1", "--iters", "1"],
        "bench_dcnv2": ["--config-file", _narrow_dcnv2_yaml(
            tmp_path / "narrow.yaml"), "--batch", "1", "--iters", "1",
            "--hw", "64,96"],
        "bench_tta": ["--batch", "2", "--batches", "1"],
        "bench_loader": ["--images", "8", "--threads", "1",
                         "--batches", "1", "--batch-size", "2",
                         "--root", str(tmp_path)],
    }[tool]
    module = {"bench": bench, "bench_dcnv2": bench_dcnv2,
              "bench_tta": bench_tta, "bench_loader": bench_loader}[tool]
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code not in (0, None) and "CUDA" in str(exc.value.code)

    monkeypatch.setattr(bench, "HW", HW)
    monkeypatch.setattr(bench, "bench_cfg", _narrow_bench_cfg)
    tta_cfg = bench_tta.tta_cfg

    def narrow_tta_cfg():
        cfg = tta_cfg()
        cfg.defrost()
        cfg.merge_from_list(NARROW + [
            "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 160,
            "TEST.BBOX_AUG.SCALES", (64, 128),
            "TEST.BBOX_AUG.MAX_SIZE", 200])
        cfg.freeze()
        return cfg

    monkeypatch.setattr(bench_tta, "tta_cfg", narrow_tta_cfg)
    monkeypatch.setattr(bench_tta, "RAW_HW", ((48, 64), (42, 64)))
    r = _last_line(module.main, ["--device", "cpu", *argv])
    assert all(k in r for k in JAX_KEYS[tool] + ("metric", "value",
                                                   "unit", "device"))
    assert r["value"] > 0
    assert r["device"] == {"name": "cpu", "power_limit": "not measured"}
    if tool != "bench_loader":
        assert set(r["clocks"]) == {"start", "end"}


def test_bench_dcnv2_train_step_gives_a_finite_loss(tmp_path):
    cfg = bench_dcnv2.load_cfg(_narrow_dcnv2_yaml(tmp_path / "n.yaml"))
    r = bench_dcnv2.run(cfg, HW, 1, 1, torch.device("cpu"), train=True)
    assert np.isfinite(r["loss"]) and r["value"] > 0
    assert r["batch"] == 1 and r["first_call_s"] > 0
    assert r["launches"]["group_norm_relu"] == 0  # the plain version

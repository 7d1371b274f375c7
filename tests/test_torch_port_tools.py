"""The port's repo-root drivers on the CPU: the train-step profiler, the
demo predictor against the JAX package's (demo/predictor.py),
remove_solver_states, the Cityscapes converter against the JAX tool, and
test_net's TensorBoard scalars.

- ``profile_train_step``: the CLI at ``--device cpu --batch 1 --hw 64 96
  --steps 1`` on a slim PAA-R50; its span table names input, forward,
  backward and optimizer, and the spans' host ms outside their nested
  spans sum to at most the profiled wall time; device time "not
  measured". The span accounting on a step of nested spans, the kernel
  classes of H100 kernel names, and its synthetic batch driving slim
  Mask and Keypoint R-CNN steps.
- ``COCODemo.compute_prediction`` on one 60x90 image against the JAX
  package's, with the same seeded weights (tests/test_torch_port_model.py's
  ``_seeded_params``, whose cls biases are lifted from the focal prior
  so that there are detections): labels equal, boxes within 1e-3 and
  scores within 1e-4 absolute (the eval path's float32 tolerances of
  tests/test_torch_port_model.py); ``run_on_opencv_image`` with cv2.
- ``remove_solver_states``: the stripped file loads through
  ``load_weights``, ``COCODemo`` and ``test_net --ckpt`` with equal
  weights; a resume from it raises ``SolverStateStripped``.
- The Cityscapes converter: equal json to the JAX tool's on a two-image
  fake gtFine tree, read by ``COCODataset`` with its polygons and by the
  loader to ``gt_masks``.
- ``test_net``'s TensorBoard scalars: written through
  ``torch.utils.tensorboard`` when it imports, skipped when it does not;
  the watcher writes them at each checkpoint's iteration.
"""

import contextlib
import importlib.util
import io
import json
import logging
import os
import sys
import time
import types

import jax
import numpy as np
import pytest
import torch
from torch.profiler import record_function

from paa_tpu.config import get_cfg as jax_get_cfg
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data.coco import COCODataset, write_ppm
from paa_tpu_torch.data.loader import make_data_loader
from paa_tpu_torch.demo.predictor import COCODemo
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.engine import train_step as ts
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.ops import group_norm as gn
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.tools import profile_train_step, remove_solver_states
from paa_tpu_torch.tools import test_net
from paa_tpu_torch.tools.cityscapes import convert_cityscapes_to_coco
from paa_tpu_torch.utils import load_jax_params
from paa_tpu_torch.utils.checkpoint import (
    Checkpointer, SolverStateStripped, load_weights)
from test_torch_port_model import _seeded_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools", "synth_catalog.py")
SLIM = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 32,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
        "TPU.COMPUTE_DTYPE", "float32"]
# tests/test_demo.py's config, at test_torch_port_model.py's head sizes
DEMO = ["MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
        "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
        "MODEL.RETINANET.USE_C5", False,
        "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
        "MODEL.PAA.PRE_NMS_TOP_N", 50, "TEST.DETECTIONS_PER_IMG", 10,
        "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
        "TPU.TEST_BUCKETS", ((64, 96), (96, 64))]
DEMO_THRESHOLD = 0.3


def _load(name, relpath):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(*opts, config_file=None):
    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small shapes (the test workers share
    the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- profile_train_step ------------------------------------------------

def test_profile_train_step_cli_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = profile_train_step.main(
            ["--device", "cpu", "--batch", "1", "--hw", "64", "96",
             "--steps", "1", *[str(v) for v in SLIM], "TPU.MAX_GT", "8"])
    assert rc == 0
    text = out.getvalue()
    result = json.loads(text.strip().splitlines()[-1])
    spans = result["by_span"]
    for label in ("input", "forward", "backward", "optimizer"):
        assert label in spans and f"  {label}\n" in text, label
    assert {"assignment", "losses"} <= set(spans)
    assert sum(s["host_self_ms"] for s in spans.values()) <= \
        result["wall_ms_per_step"]
    assert result["device_time"] == "not measured"
    assert result["device"] == "cpu" and result["step_clock"] == "host"
    assert result["batch"] == 1 and result["hw"] == [64, 96]
    assert result["flops_per_step"] > 0 and result["dtype"] == "float32"
    assert "share_of_bf16_peak" not in result
    # on the CPU the kernels' plain versions run: no launch is counted;
    # ROIAlign's counters count on every device, and PAA pools no rois
    assert result["launches"] == {"nms_batched": 0, "nms_global": 0,
                                  "group_norm_relu": 0, "deform_im2col": 0,
                                  "deform_col2im": 0,
                                  "roi_align": 0, "roi_align_rois": 0}


def test_profile_steps_subtracts_nested_spans():
    """K3's backward recompute inside the backward span: the backward's
    self time excludes it, and every span's self time is at most its
    host time."""
    def step(state, batch):
        with record_function(ts.SPAN_INPUT):
            time.sleep(0.002)
        with record_function(ts.SPAN_BACKWARD):
            time.sleep(0.004)
            with record_function(gn.SPAN_BACKWARD):
                time.sleep(0.006)
        with record_function("not a train-step span"):
            time.sleep(0.002)

    r = profile_train_step.profile_steps(
        step, None, {"images": torch.zeros(2, 8, 16, 3)},
        torch.device("cpu"), steps=2)
    spans = r["by_span"]
    assert set(spans) == {"input", "backward", "gn_backward_recompute"}
    back, recompute = spans["backward"], spans["gn_backward_recompute"]
    assert back["host_ms"] >= 10 and recompute["host_ms"] >= 6
    assert back["host_self_ms"] == pytest.approx(
        back["host_ms"] - recompute["host_ms"], abs=1e-3)
    assert recompute["host_self_ms"] == recompute["host_ms"]
    assert sum(s["host_self_ms"] for s in spans.values()) <= \
        r["wall_ms_per_step"]
    assert r["device_time"] == "not measured"
    assert r["steps"] == 2 and r["batch"] == 2 and r["hw"] == [8, 16]


@pytest.mark.parametrize("config,extra,key,shape", [
    ("e2e_mask_rcnn_R_50_FPN_1x.yaml",
     ["MODEL.ROI_MASK_HEAD.CONV_LAYERS", (16, 16)], "gt_masks",
     (2, 8, 112, 112)),
    ("e2e_keypoint_rcnn_R_50_FPN_1x.yaml",
     ["MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", (16, 16)], "gt_keypoints",
     (2, 8, 17, 3)),
])
def test_profiler_batch_drives_mask_and_keypoint_steps(config, extra, key,
                                                       shape):
    """The profiler's synthetic batch carries the targets a two-stage
    model's step reads (octagon masks, keypoints inside the boxes), and
    one step of the slim model runs on it."""
    cfg = _cfg(*SLIM, "TPU.MAX_GT", 8, "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM",
               32, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 32, *extra,
               config_file=os.path.join(ROOT, "configs", config))
    model = build_detection_model(cfg, device="cpu")
    batch = profile_train_step.synthetic_batch(model, 2, (64, 96))
    assert batch[key].shape == shape
    valid = batch["gt_labels"] > 0
    assert valid.sum(dim=1).min() >= 3
    boxes = batch["gt_boxes"][valid]
    assert (boxes[:, 2:] > boxes[:, :2]).all() and boxes[:, 2].max() < 96
    assert boxes[:, 3].max() < 64
    if key == "gt_masks":
        assert all(m.any() for m in batch[key][valid])
    else:
        kps = batch[key][valid]  # (n, 17, 3), labelled where v > 0
        labelled = kps[..., 2] > 0
        x, y = kps[..., 0], kps[..., 1]
        inside = ((x >= boxes[:, None, 0] - 0.01) &
                  (x <= boxes[:, None, 2] + 0.01) &
                  (y >= boxes[:, None, 1] - 0.01) &
                  (y <= boxes[:, None, 3] + 0.01))
        assert labelled.any() and inside[labelled].all()
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    metrics = model.make_bucket_train_step((64, 96))(state, batch)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.parametrize("name,cls", [
    ("void nms_batched_kernel<1024>(...)", "nms_batched (K1)"),
    ("void nms_cluster_kernel(...)", "nms_global (K2)"),
    ("void gn_relu_cluster_kernel<__nv_bfloat16>(...)",
     "group_norm_relu (K3)"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16", "convolution"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "GEMM"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/layout"),
    ("void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16>(...)",
     "copy/layout"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
     "elementwise"),
    ("void at::native::reduce_kernel<512, 1>(...)", "reductions"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather/scatter/index"),
    ("void cub::DeviceRadixSortOnesweepKernel<...>", "sort (top-k)"),
    ("void some_kernel()", "other"),
])
def test_kernel_class(name, cls):
    assert profile_train_step.kernel_class(name) == cls


# ---- the demo ------------------------------------------------------------

@pytest.fixture(scope="module")
def demos():
    """paa_tpu's COCODemo and the port's, with the same seeded weights,
    on one 60x90 image."""
    predictor = _load("jax_demo_predictor", os.path.join("demo",
                                                         "predictor.py"))
    jcfg = jax_get_cfg()
    jcfg.merge_from_list(DEMO)
    jcfg.freeze()
    want_demo = predictor.COCODemo(jcfg, confidence_threshold=DEMO_THRESHOLD)
    params = _seeded_params(want_demo.variables["params"],
                            np.random.RandomState(0))
    want_demo.variables = {"params": jax.tree.map(jax.numpy.asarray,
                                                  params)}
    demo = COCODemo(_cfg(*DEMO), confidence_threshold=DEMO_THRESHOLD,
                    device="cpu")
    load_jax_params(demo.model.module, params)
    image = np.random.RandomState(3).randint(0, 256, (60, 90, 3)
                                             ).astype(np.uint8)
    return demo, want_demo, image


def test_demo_prediction_matches_jax(demos):
    demo, want_demo, image = demos
    got = demo.compute_prediction(image)
    want = want_demo.compute_prediction(image)
    boxes, scores, labels = got
    assert 3 <= len(labels) <= 10
    assert scores.min() >= DEMO_THRESHOLD
    np.testing.assert_array_equal(labels, want[2])
    np.testing.assert_allclose(scores, want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(boxes, want[0], rtol=0, atol=1e-3)
    # in the original image's coordinates, not the 64 x 96 input's
    assert boxes[:, 2].max() <= 90 and boxes[:, 3].max() <= 60


def test_demo_draws_with_cv2(demos):
    demo, _, image = demos
    out = demo.run_on_opencv_image(image)
    assert out.shape == image.shape and out.dtype == np.uint8
    assert (out != image).any()


def test_demo_cli_on_a_ppm(demos, tmp_path):
    _, _, image = demos
    write_ppm(tmp_path / "in.ppm", image)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = _demo_main(tmp_path, ["--confidence-threshold", "0.0"])
    assert rc == 0
    lines = out.getvalue().splitlines()
    dets = json.loads(lines[0])
    assert dets["input"] == str(tmp_path / "in.ppm")
    assert len(dets["boxes"]) == len(dets["scores"]) == len(dets["labels"])
    assert lines[-1] == f"wrote {tmp_path / 'out.jpg'}"
    assert (tmp_path / "out.jpg").stat().st_size > 0


def _demo_main(tmp_path, extra=()):
    from paa_tpu_torch.demo import demo as demo_cli

    return demo_cli.main(
        ["--config-file", CONFIG, "--input", str(tmp_path / "in.ppm"),
         "--output", str(tmp_path / "out.jpg"), "--device", "cpu", *extra,
         *[str(v) for v in SLIM], "INPUT.MIN_SIZE_TEST", "64",
         "INPUT.MAX_SIZE_TEST", "96"])


# ---- remove_solver_states ------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A Checkpointer file of a slim PAA-R50 after one SGD update (so the
    optimizer holds momentum buffers), and its stripped copy."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = _cfg(*SLIM, config_file=CONFIG)
    model = build_detection_model(cfg, device="cpu", seed=4)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    loss = sum((p.float() ** 2).sum() for p in model.module.parameters()
               if p.requires_grad)
    loss.backward()
    state.optimizer.step()
    state.step = 1
    Checkpointer(str(root)).save("model_0000001", state, iteration=1)
    path = str(root / "model_0000001")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert remove_solver_states.main([path]) == 0
    stripped = path + "_nosolver.pth"
    assert out.getvalue().strip() == f"wrote {stripped}"
    return cfg, model.module.state_dict(), path, stripped


def test_stripped_checkpoint_loads_equal_weights(checkpoint):
    cfg, weights, path, stripped = checkpoint
    assert os.path.getsize(stripped) < 0.7 * os.path.getsize(path)
    data = torch.load(stripped, weights_only=True)
    assert data["optimizer"] is None and data["step"] == 1
    assert data["extra"] == {"iteration": 1}
    fresh = build_detection_model(cfg, device="cpu", seed=9)
    assert load_weights(fresh.module, stripped) == {"iteration": 1}
    demo = COCODemo(cfg, stripped, device="cpu")
    for module in (fresh.module, demo.model.module):
        got = module.state_dict()
        assert set(got) == set(weights)
        for k, v in weights.items():
            assert torch.equal(got[k], v), k


def test_resume_from_a_stripped_checkpoint_raises(checkpoint):
    cfg, _, path, stripped = checkpoint
    model = build_detection_model(cfg, device="cpu")
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    with pytest.raises(SolverStateStripped, match="remove_solver_states"):
        Checkpointer().load(state, stripped)
    assert Checkpointer().load(state, path) == {"iteration": 1}
    assert state.step == 1


@pytest.mark.parametrize("name,want", [
    ("model_final", "model_final_nosolver.pth"),
    ("x/model_0001000.pth", "x/model_0001000_nosolver.pth"),
    ("a.b/c", "a.b/c_nosolver.pth"),
])
def test_stripped_path(name, want):
    assert remove_solver_states.stripped_path(name) == want


def test_test_net_reads_a_stripped_checkpoint(checkpoint, tmp_path,
                                              monkeypatch):
    """``test_net --ckpt`` evaluates the stripped file: the weights it
    evaluated are the checkpoint's."""
    cfg, weights, _, stripped = checkpoint
    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    evaluated = {}

    def spy(cfg, model, dataset, **kwargs):
        evaluated.update(model.module.state_dict())
        return {"AP": 0.0}

    monkeypatch.setattr("paa_tpu_torch.engine.inference.inference", spy)
    rc = test_net.main(
        ["--config-file", CONFIG, "--device", "cpu", "--ckpt", stripped,
         *[str(v) for v in SLIM], "PATHS_CATALOG", CATALOG,
         "DATASETS.TEST", "('synth_coco_2',)",
         "OUTPUT_DIR", str(tmp_path / "out")])
    assert rc == 0
    assert set(evaluated) == set(weights)
    for k, v in weights.items():
        assert torch.equal(evaluated[k], v), k


# ---- the Cityscapes converter --------------------------------------------

CITY_OBJECTS = [
    [{"label": "car", "polygon": [[4, 6], [40, 6], [44, 30], [6, 28]]},
     {"label": "road", "polygon": [[0, 40], [127, 40], [127, 63], [0, 63]]},
     {"label": "persongroup",
      "polygon": [[60, 10], [80, 10], [80, 50], [60, 50]]},
     {"label": "bicycle", "polygon": [[90, 20], [120, 22], [110, 50]]}],
    [{"label": "truck", "polygon": [[10, 10], [70, 12], [68, 55], [12, 50]]},
     {"label": "rider", "polygon": [[80, 5], [100, 5], [100, 45]]}],
]


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    """A two-image gtFine tree (train split, two cities), PPM bytes under
    the leftImg8bit .png names, converted by both tools."""
    root = tmp_path_factory.mktemp("cityscapes")
    rng = np.random.RandomState(0)
    for i, objects in enumerate(CITY_OBJECTS):
        city = ("aachen", "bochum")[i]
        base = f"{city}_000000_00001{i}"
        gt_dir = root / "gtFine" / "train" / city
        img_dir = root / "leftImg8bit" / "train" / city
        gt_dir.mkdir(parents=True)
        img_dir.mkdir(parents=True)
        with open(gt_dir / f"{base}_gtFine_polygons.json", "w") as f:
            json.dump({"imgHeight": 64, "imgWidth": 128,
                       "objects": objects}, f)
        write_ppm(img_dir / f"{base}_leftImg8bit.png",
                  rng.randint(0, 256, (64, 128, 3)).astype(np.uint8))
    outs = {}
    for side, main in (
            ("jax", _load("jax_cityscapes", os.path.join(
                "tools", "cityscapes", "convert_cityscapes_to_coco.py")
            ).main),
            ("port", convert_cityscapes_to_coco.main)):
        argv = ["--datadir", str(root), "--outdir", str(root / side)]
        with contextlib.redirect_stdout(io.StringIO()):
            if side == "jax":
                saved = sys.argv
                sys.argv = ["convert_cityscapes_to_coco.py", *argv]
                try:
                    main()
                finally:
                    sys.argv = saved
            else:
                main(argv)
        outs[side] = str(root / side /
                         "instancesonly_filtered_gtFine_train.json")
    return root, outs


def test_cityscapes_json_matches_jax(cityscapes):
    _, outs = cityscapes
    with open(outs["jax"]) as f:
        want = json.load(f)
    with open(outs["port"]) as f:
        got = json.load(f)
    assert got == want
    assert len(got["images"]) == 2
    # road is no instance class; persongroup is a crowd person
    assert [a["category_id"] for a in got["annotations"]] == [3, 1, 8, 4, 2]
    assert [a["iscrowd"] for a in got["annotations"]] == [0, 1, 0, 0, 0]


def test_cityscapes_output_reads_to_gt_masks(cityscapes):
    root, outs = cityscapes
    ds = COCODataset(outs["port"], str(root / "leftImg8bit" / "train"),
                     with_masks=True)
    assert [len(r.polygons) for r in ds.records] == [2, 2]  # crowd out
    assert ds.load_image(0).shape == (64, 128, 3)
    cfg = _cfg("INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 128,
               "TPU.TRAIN_BUCKETS", ((64, 128),), "TPU.MAX_GT", 4,
               "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 1,
               "MODEL.MASK_ON", True)
    batch = next(iter(make_data_loader(cfg, ds, is_train=True)))
    masks = batch["gt_masks"]
    assert masks.shape == (2, 4, 112, 112) and masks.dtype == np.uint8
    valid = batch["gt_labels"] > 0
    assert valid.sum() == 4
    assert all(masks[b, g].any() for b, g in zip(*np.nonzero(valid)))
    assert not masks[~valid].any()


# ---- test_net's TensorBoard scalars --------------------------------------

class _Writer:
    def __init__(self, log_dir):
        self.log_dir, self.scalars, self.closed = log_dir, [], False
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed = True


def _fake_tensorboard(monkeypatch):
    _Writer.made = []
    module = types.ModuleType("torch.utils.tensorboard")
    module.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", module)


def test_tensorboard_scalars_written(monkeypatch, tmp_path):
    _fake_tensorboard(monkeypatch)
    test_net._write_tb_scalars(
        str(tmp_path), ["coco_2017_val", "voc_2007_test"],
        [{"AP": 0.25, "AP50": 0.5, "note": "text"}, {"mAP": 0.75}], 2500)
    (writer,) = _Writer.made
    assert writer.log_dir == str(tmp_path) and writer.closed
    assert writer.scalars == [("coco_2017_val_AP", 0.25, 2500),
                              ("coco_2017_val_AP50", 0.5, 2500),
                              ("voc_2007_test_mAP", 0.75, 2500)]


def test_tensorboard_scalars_skipped_without_tensorboard(monkeypatch,
                                                         tmp_path):
    # a None entry makes the import raise ImportError
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    test_net._write_tb_scalars(str(tmp_path), ["coco_2017_val"],
                               [{"AP": 0.25}], 10)
    assert os.listdir(tmp_path) == []


def test_watcher_writes_scalars_at_each_checkpoints_iteration(
        monkeypatch, tmp_path):
    _fake_tensorboard(monkeypatch)
    for it in (20, 40):
        (tmp_path / f"model_{it:07d}").write_bytes(b"")
    seen = []

    def fake_inference(cfg, model, dataset, **kwargs):
        seen.append(kwargs["output_folder"])
        return {"AP": 0.1 * len(seen)}

    monkeypatch.setattr("paa_tpu_torch.utils.checkpoint.load_weights",
                        lambda module, path: {})
    monkeypatch.setattr("paa_tpu_torch.data.build.build_dataset",
                        lambda cfg, names, is_train: [object()])
    monkeypatch.setattr("paa_tpu_torch.engine.inference.inference",
                        fake_inference)
    cfg = _cfg("DATASETS.TEST", ("synth_coco_2",),
               "OUTPUT_DIR", str(tmp_path / "out"))
    test_net.watch_dir(cfg, types.SimpleNamespace(module=None),
                       str(tmp_path), logging.getLogger("test"), poll_s=0,
                       give_up_s=-1)
    assert len(seen) == 2
    assert [w.scalars for w in _Writer.made] == [
        [("synth_coco_2_AP", 0.1, 20)], [("synth_coco_2_AP", 0.2, 40)]]

"""The port's training and AP-gate CLIs on the CPU, at a slim PAA-R50
(BACKBONE_OUT_CHANNELS 64, an eighth of R-50's widths), float32, small
images (96 to 128 px in a 128 x 128 bucket).

- ``python -m paa_tpu_torch.tools.train_net`` on the synthetic PPM COCO
  ``synth_coco_32`` (tools/synth_catalog.py), from
  ``catalog://ImageNetPretrained/MSRA/R-50`` (a seeded Detectron pickle
  at the slim shapes under $PAA_TPU_WEIGHTS_DIR): two iterations with
  checkpoints, the imported body in the checkpoint (the frozen stem and
  first stage equal the pickle's blobs); then ``main`` again in process
  with MAX_ITER 3, which resumes from ``last_checkpoint`` at iteration 2,
  takes the third step and evaluates DATASETS.TEST to the AP table.
- ``python -m paa_tpu_torch.tools.reproduce_ap`` and its ``main``, as
  tests/test_reproduce_ap.py holds tools/reproduce_ap.py: exit 2 for
  missing weights, unreadable weights, --ann-file without --img-dir and
  a missing dataset; 1 when the AP misses 0.404 +/- 0.003 (random
  weights); 0 inside a tolerance that admits it, with the results
  written; and the catalog route through --data.
- ``train_net.main`` on the X-152 dcnv2 config at narrow widths (4
  groups x 4, stem 8, res2 32) from its own MODEL.WEIGHT,
  ``catalog://ImageNetPretrained/FAIR/20171220/X-101-32x8d`` (a seeded
  narrow X-101 pickle): two iterations through the config's loader
  path, finite losses, the frozen stem and first stage of the
  checkpoint equal to the pickle's blobs, the offset convs trained.
- ``python -m paa_tpu_torch.tools.test_net`` with TEST.BBOX_AUG.ENABLED
  (the identity, one scale, both flipped, soft-vote) on
  ``synth_coco_4`` from the seeded weights: exit 0, the 12 metrics and
  detections of every image written.
- The dense detectors' configs at the same slim body: ``train_net.main``
  on atss_R_50_FPN_1x for two iterations from its catalog R-50 pickle,
  then its test pass to the AP table; ``python -m
  paa_tpu_torch.tools.test_net`` on retinanet_R-50-FPN_1x (P6 from C5)
  and, with TEST.BBOX_AUG (no VOTE: the pooled candidates and one NMS),
  on fcos_imprv_R_50_FPN_1x with VOTE and atss_R_50_FPN_1x without:
  exit 0, the 12 metrics written.
- Mask R-CNN (e2e_mask_rcnn_R_50_FPN_1x) at the same slim body, with 64
  rois per image and 32-channel mask convs: ``train_net.main`` for two
  iterations from its catalog R-50 pickle on ``synth_coco_4``, whose
  annotations carry polygons (finite box and mask losses), then its test
  pass to the bbox and segm tables; and ``python -m
  paa_tpu_torch.tools.test_net`` from the seeded weights, which prints
  both tables.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import reference_layout as rl
from paa_tpu_torch.config import get_cfg
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.tools import reproduce_ap, train_net
from paa_tpu_torch.utils.checkpoint import Checkpointer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
CATALOG = os.path.join(ROOT, "paa_tpu_torch", "tools", "synth_catalog.py")
SLIM = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
        "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
        "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
        "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
        "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2]
SMALL = ["INPUT.MIN_SIZE_TRAIN", (96,), "INPUT.MAX_SIZE_TRAIN", 128,
         "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 128,
         "TPU.TRAIN_BUCKETS", ((128, 128),), "TPU.TEST_BUCKETS", ((128, 128),),
         "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 4,
         "SOLVER.CHECKPOINT_PERIOD", 1, "TPU.MAX_GT", 20]


def _opts(*pairs):
    return [str(v) for v in pairs]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slim_cfg():
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(SLIM)
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The first train_net run, as a subprocess: 2 iterations from the
    catalog pickle, no test pass."""
    root = tmp_path_factory.mktemp("train_net")
    weights = root / "weights"
    weights.mkdir()
    body = {k: v for k, v in rl.seeded_state_dict(
        rl.layout(_slim_cfg()), 11).items() if k.startswith("backbone.body.")}
    blobs = rl.c2_imagenet_blobs(body, seed=12)
    with open(weights / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    out = root / "out"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PAA_TPU_WEIGHTS_DIR": str(weights),
           "PAA_TPU_TORCH_SYNTH_DIR": str(root / "synth")}
    opts = _opts(*SLIM, *SMALL, "SOLVER.MAX_ITER", 2,
                 "PATHS_CATALOG", CATALOG,
                 "DATASETS.TRAIN", ("synth_coco_32",),
                 "DATASETS.TEST", ("synth_coco_32",), "OUTPUT_DIR", out)
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.train_net",
         "--config-file", CONFIG, "--device", "cpu", "--skip-test", *opts],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    return dict(proc=proc, out=out, blobs=blobs, opts=opts, env=env)


def test_train_net_imports_the_catalog_pickle_and_checkpoints(trained):
    proc, out, blobs = trained["proc"], trained["out"], trained["blobs"]
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "c2 import: matched" in proc.stdout
    assert "skipped 2" in proc.stdout  # the classifier, pred_w/pred_b
    assert sorted(os.listdir(out)) == [
        "config.yml", "last_checkpoint", "log.txt", "model_0000001",
        "model_0000002", "model_final"]
    ckpt = torch.load(out / "model_final", weights_only=True)
    assert ckpt["extra"] == {"iteration": 2} and ckpt["step"] == 2
    model = ckpt["model"]
    assert not any(k.startswith("module.") for k in model)
    # FREEZE_CONV_BODY_AT 2: the stem and the first stage do not train
    np.testing.assert_array_equal(
        model["backbone.resnet.stem.conv1.weight"].numpy(), blobs["conv1_w"])
    np.testing.assert_array_equal(
        model["backbone.resnet.layer1_2.conv3.weight"].numpy(),
        blobs["res2_2_branch2c_w"])
    # FrozenBatchNorm everywhere: s and b as imported, statistics 0 and 1
    np.testing.assert_array_equal(
        model["backbone.resnet.layer4_1.bn2.weight"].numpy(),
        blobs["res5_1_branch2b_bn_s"])
    assert bool((model["backbone.resnet.layer4_1.bn2.running_var"] == 1)
                .all())
    # the later stages did train
    assert not np.array_equal(
        model["backbone.resnet.layer3_0.conv1.weight"].numpy(),
        blobs["res4_0_branch2a_w"])


def test_train_net_resumes_and_evaluates(trained, monkeypatch):
    assert trained["proc"].returncode == 0
    out = trained["out"]
    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR",
                       trained["env"]["PAA_TPU_TORCH_SYNTH_DIR"])
    opts = list(trained["opts"])
    opts[opts.index("SOLVER.MAX_ITER") + 1] = "3"
    seen = {}
    rc = train_net.main(["--config-file", CONFIG, "--device", "cpu", *opts],
                        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0
    assert sorted(seen) == [3]  # resumed at iteration 2
    assert np.isfinite(seen[3]["loss"]) and seen[3]["num_pos"] > 0
    extra = Checkpointer(str(out)).get_checkpoint_file()
    assert extra == "model_final"
    ckpt = torch.load(out / "model_final", weights_only=True)
    assert ckpt["extra"] == {"iteration": 3} and ckpt["step"] == 3
    folder = out / "inference" / "synth_coco_32"
    with open(folder / "coco_results.json") as f:
        results = json.load(f)
    assert len(results) == 12 and all(np.isfinite(list(results.values())))
    assert (folder / "bbox.json").exists()


def test_train_net_missing_weights_exit_2(tmp_path, monkeypatch):
    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    from paa_tpu_torch.config.paths_catalog import ModelCatalog

    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    rc = train_net.main(["--config-file", CONFIG, "--device", "cpu",
                         *_opts(*SLIM, *SMALL, "OUTPUT_DIR", tmp_path / "o",
                                "PATHS_CATALOG", CATALOG,
                                "DATASETS.TRAIN", ("synth_coco_2",))])
    assert rc == 2


# ---- the AP gate -----------------------------------------------------------

# the narrow eval of tests/test_torch_port_eval.py at the slim body
GATE = SLIM + ["INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
               "TPU.TEST_BUCKETS", ((96, 96),), "TEST.IMS_PER_BATCH", 2]


X152 = os.path.join(ROOT, "configs", "paa",
                    "paa_dcnv2_X_152_32x8d_FPN_2x.yaml")
X152_NARROW = ["MODEL.RESNETS.NUM_GROUPS", 4,
               "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
               "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
               "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
               "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 64,
               "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", 2]


def test_train_net_x152_dcnv2_from_the_x101_catalog_pickle(tmp_path,
                                                           monkeypatch):
    from paa_tpu_torch.config.paths_catalog import ModelCatalog
    from paa_tpu_torch.utils.torch_import import torch_name_to_port_keys

    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    cfg = get_cfg()
    cfg.merge_from_file(X152)
    cfg.merge_from_list(X152_NARROW)
    assert cfg.MODEL.WEIGHT == \
        "catalog://ImageNetPretrained/FAIR/20171220/X-101-32x8d"
    r = cfg.MODEL.RESNETS
    body = rl.seeded_state_dict(rl.resnet_keys(
        rl.BLOCKS["R-101"], r.STEM_OUT_CHANNELS, r.RES2_OUT_CHANNELS,
        r.WIDTH_PER_GROUP, r.NUM_GROUPS), 21)
    with open(tmp_path / "X-101-32x8d.pkl", "wb") as f:
        pickle.dump({"blobs": rl.c2_imagenet_blobs(body, seed=22)}, f,
                    protocol=2)
    out = tmp_path / "out"
    opts = _opts(*X152_NARROW, *SMALL, "SOLVER.MAX_ITER", 2,
                 "PATHS_CATALOG", CATALOG,
                 "DATASETS.TRAIN", ("synth_coco_4",), "OUTPUT_DIR", out)
    seen = {}
    rc = train_net.main(["--config-file", X152, "--device", "cpu",
                         "--skip-test", *opts],
                        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0 and sorted(seen) == [1, 2]
    assert all(np.isfinite(list(m.values())).all() and m["num_pos"] > 0
               for m in seen.values())
    model = torch.load(out / "model_final", weights_only=True)["model"]
    frozen = 0
    for key, value in rl.fold_frozen_bn(body).items():
        port_key = torch_name_to_port_keys(key)[0][0]  # the FPN body's
        if port_key.startswith(("backbone.resnet.stem.",
                                "backbone.resnet.layer1_")):
            np.testing.assert_array_equal(model[port_key].numpy(), value,
                                          err_msg=port_key)
            frozen += 1
    assert frozen > 20
    # the offset convs start at zero (X-101 has none) and trained
    assert float(model["backbone.resnet.layer2_0.conv2.offset.weight"]
                 .abs().max()) > 0


def test_test_net_with_test_time_augmentation(tmp_path):
    out = tmp_path / "out"
    opts = _opts(*SLIM, *SMALL, "PATHS_CATALOG", CATALOG,
                 "DATASETS.TEST", ("synth_coco_4",), "OUTPUT_DIR", out,
                 "TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.H_FLIP", True,
                 "TEST.BBOX_AUG.SCALES", (64,),
                 "TEST.BBOX_AUG.SCALE_RANGES", ((0, 10000),),
                 "TEST.BBOX_AUG.SCALE_H_FLIP", True,
                 "TEST.BBOX_AUG.VOTE", True,
                 "TEST.BBOX_AUG.MERGE_TYPE", "soft-vote",
                 # the seeded head's class scores sit at the focal prior
                 # (0.01): a lower threshold lets candidates through
                 "MODEL.PAA.INFERENCE_TH", 0.005)
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--config-file", CONFIG, "--device", "cpu", *opts],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path / "synth")})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "TTA eval" in proc.stdout + proc.stderr
    folder = out / "inference" / "synth_coco_4"
    with open(folder / "coco_results.json") as f:
        assert sorted(json.load(f)) == sorted(
            ["AP", "AP50", "AP75", "APs", "APm", "APl",
             "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"])
    with open(folder / "bbox.json") as f:
        assert {d["image_id"] for d in json.load(f)} == {1, 2, 3, 4}


@pytest.fixture(scope="module")
def gate_inputs(tmp_path_factory):
    """A 4-image PPM COCO with COCO's 80 sparse category ids, and a
    seeded reference-format {"model": state_dict} .pth of the slim
    PAA-R50."""
    root = tmp_path_factory.mktemp("ap_gate")
    ann_file, img_dir = synth_coco(str(root / "coco"), 4, seed=3,
                                   sizes=((96, 64), (64, 96)))
    state = rl.seeded_state_dict(rl.layout(_slim_cfg()), seed=13)
    path = root / "PAA_R_50_FPN_1x.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in state.items()}},
               path)
    return ann_file, img_dir, str(path)


def _gate(argv):
    return reproduce_ap.main(["--config-file", CONFIG, "--device", "cpu",
                              *argv, *_opts(*GATE)])


def test_reproduce_ap_exit_2(gate_inputs, tmp_path):
    ann_file, img_dir, weights = gate_inputs
    common = ["--ann-file", ann_file, "--img-dir", img_dir]
    assert _gate(["--weights", str(tmp_path / "nope.pth"), *common,
                  "--output-dir", str(tmp_path / "a")]) == 2
    junk = tmp_path / "junk.pth"
    junk.write_bytes(b"not a checkpoint")
    assert _gate(["--weights", str(junk), *common,
                  "--output-dir", str(tmp_path / "b")]) == 2
    assert _gate(["--weights", weights, "--ann-file", ann_file,
                  "--output-dir", str(tmp_path / "c")]) == 2
    assert _gate(["--weights", weights, "--data", str(tmp_path / "empty"),
                  "--output-dir", str(tmp_path / "d")]) == 2


def test_reproduce_ap_exit_1_and_0(gate_inputs, tmp_path):
    ann_file, img_dir, weights = gate_inputs
    common = ["--weights", weights, "--ann-file", ann_file,
              "--img-dir", img_dir]
    # the real 40.4 gate fails on random weights
    assert _gate([*common, "--output-dir", str(tmp_path / "o1")]) == 1
    out0 = tmp_path / "o0"
    assert _gate([*common, "--expected", "0.0", "--tol", "1.5",
                  "--output-dir", str(out0)]) == 0
    with open(out0 / "inference" / "custom" / "coco_results.json") as f:
        assert "AP" in json.load(f)


def test_reproduce_ap_cli_through_the_catalog(gate_inputs, tmp_path):
    """--data routes DATASETS.TEST (coco_2017_val) through the catalog as
    a mounted COCO tree would, in a subprocess (python -m)."""
    ann_file, img_dir, weights = gate_inputs
    coco = tmp_path / "datasets" / "coco"
    (coco / "annotations").mkdir(parents=True)
    os.symlink(img_dir, coco / "val2017")
    os.symlink(ann_file, coco / "annotations" / "instances_val2017.json")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.reproduce_ap",
         "--config-file", CONFIG, "--device", "cpu", "--weights", weights,
         "--data", str(tmp_path / "datasets"), "--expected", "0.0",
         "--tol", "1.5", "--output-dir", str(out), *_opts(*GATE)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert "AP GATE PASSED" in proc.stdout
    assert (out / "inference" / "coco_2017_val" / "coco_results.json"
            ).exists()


# ---- the dense detectors' configs -------------------------------------------

DENSE_CONFIGS = {
    "atss": os.path.join(ROOT, "configs", "atss", "atss_R_50_FPN_1x.yaml"),
    "fcos": os.path.join(ROOT, "configs", "fcos",
                         "fcos_imprv_R_50_FPN_1x.yaml"),
    "retinanet": os.path.join(ROOT, "configs", "retinanet",
                              "retinanet_R-50-FPN_1x.yaml"),
}
METRICS = sorted(["AP", "AP50", "AP75", "APs", "APm", "APl",
                  "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"])


def test_train_net_atss_two_iterations_then_test(tmp_path, monkeypatch):
    from paa_tpu_torch.config.paths_catalog import ModelCatalog

    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    body = {k: v for k, v in rl.seeded_state_dict(
        rl.layout(_slim_cfg()), 11).items() if k.startswith("backbone.body.")}
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": rl.c2_imagenet_blobs(body, seed=12)}, f,
                    protocol=2)
    out = tmp_path / "out"
    seen = {}
    rc = train_net.main(
        ["--config-file", DENSE_CONFIGS["atss"], "--device", "cpu",
         *_opts(*SLIM, *SMALL, "SOLVER.MAX_ITER", 2, "PATHS_CATALOG",
                CATALOG, "DATASETS.TRAIN", ("synth_coco_4",),
                "DATASETS.TEST", ("synth_coco_4",), "OUTPUT_DIR", out)],
        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0 and sorted(seen) == [1, 2]
    assert all(np.isfinite(list(m.values())).all() and m["num_pos"] > 0
               and "loss_centerness" in m for m in seen.values())
    assert (out / "model_final").exists()
    with open(out / "inference" / "synth_coco_4" / "coco_results.json") as f:
        assert sorted(json.load(f)) == METRICS


@pytest.mark.parametrize("kind,extra", [
    ("retinanet", ["MODEL.RETINANET.INFERENCE_TH", 0.005]),
    ("fcos", ["MODEL.FCOS.INFERENCE_TH", 0.005,
              "TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.SCALES", (64,),
              "TEST.BBOX_AUG.VOTE", True]),
    ("atss", ["MODEL.ATSS.INFERENCE_TH", 0.005,
              "TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.H_FLIP", True,
              "TEST.BBOX_AUG.SCALES", (64,)]),
])
def test_test_net_dense_configs(kind, extra, tmp_path):
    """From the seeded weights (the seeded head's class scores sit at the
    focal prior, 0.01: a lower threshold lets candidates through)."""
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--config-file", DENSE_CONFIGS[kind], "--device", "cpu",
         *_opts(*SLIM, *SMALL, "PATHS_CATALOG", CATALOG,
                "DATASETS.TEST", ("synth_coco_4",), "OUTPUT_DIR", out,
                *extra)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path / "synth")})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert ("TTA eval" in proc.stdout + proc.stderr) == \
        ("TEST.BBOX_AUG.ENABLED" in extra)
    folder = out / "inference" / "synth_coco_4"
    with open(folder / "coco_results.json") as f:
        assert sorted(json.load(f)) == METRICS
    with open(folder / "bbox.json") as f:
        assert len(json.load(f)) > 0


# ---- Mask R-CNN -------------------------------------------------------------

MASK_CONFIG = os.path.join(ROOT, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
MASK_SLIM = ["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
             "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", 64,
             "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (32, 32, 32, 32),
             "SOLVER.BASE_LR", 0.001]


def _segm_results(folder):
    with open(folder / "coco_results.json") as f:
        results = json.load(f)
    assert sorted(k for k in results if "/" not in k) == METRICS
    assert sorted(k[5:] for k in results if k.startswith("segm/")) == METRICS
    return results


def test_train_net_mask_rcnn_two_iterations_then_test(tmp_path, monkeypatch):
    from paa_tpu_torch.config.paths_catalog import ModelCatalog

    monkeypatch.setenv("PAA_TPU_TORCH_SYNTH_DIR", str(tmp_path / "synth"))
    monkeypatch.setattr(ModelCatalog, "WEIGHTS_DIR", str(tmp_path))
    body = {k: v for k, v in rl.seeded_state_dict(
        rl.layout(_slim_cfg()), 11).items() if k.startswith("backbone.body.")}
    with open(tmp_path / "R-50.pkl", "wb") as f:
        pickle.dump({"blobs": rl.c2_imagenet_blobs(body, seed=12)}, f,
                    protocol=2)
    out = tmp_path / "out"
    seen = {}
    rc = train_net.main(
        ["--config-file", MASK_CONFIG, "--device", "cpu",
         *_opts(*SLIM, *SMALL, *MASK_SLIM, "SOLVER.MAX_ITER", 2,
                "PATHS_CATALOG", CATALOG, "DATASETS.TRAIN", ("synth_coco_4",),
                "DATASETS.TEST", ("synth_coco_4",), "OUTPUT_DIR", out)],
        metric_hook=lambda i, m: seen.update({i: m}))
    assert rc == 0 and sorted(seen) == [1, 2]
    for m in seen.values():
        assert np.isfinite(list(m.values())).all() and m["num_pos"] > 0
        assert {"loss_objectness", "loss_classifier", "loss_mask"} <= set(m)
        assert m["loss_mask"] > 0
    ckpt = torch.load(out / "model_final", weights_only=True)
    assert "mask_head.conv5_mask.weight" in ckpt["model"]
    _segm_results(out / "inference" / "synth_coco_4")


def test_test_net_mask_rcnn_prints_bbox_and_segm(tmp_path):
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "paa_tpu_torch.tools.test_net",
         "--config-file", MASK_CONFIG, "--device", "cpu",
         *_opts(*SLIM, *SMALL, *MASK_SLIM, "PATHS_CATALOG", CATALOG,
                "DATASETS.TEST", ("synth_coco_4",), "OUTPUT_DIR", out,
                # the seeded classifier's scores sit near 1/81: a lower
                # threshold keeps detections, so masks get pasted
                "MODEL.ROI_HEADS.SCORE_THRESH", 0.0)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path / "synth")})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    text = proc.stdout + proc.stderr
    assert "Task: bbox" in text and "Task: segm" in text
    results = _segm_results(out / "inference" / "synth_coco_4")
    assert all(np.isfinite(list(results.values())))
    with open(out / "inference" / "synth_coco_4" / "bbox.json") as f:
        assert len(json.load(f)) > 0

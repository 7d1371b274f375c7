"""The PyTorch port stands alone: it imports without JAX, and no module of
paa_tpu_torch (nor chip_smoke.py, kernel_ab.py, the NMS cases and the
reference checkpoint layouts they share with the tests,
tests/nms_cases.py and tests/reference_layout.py, nor the distributed
tests' worker) names jax, flax or paa_tpu in an import. Nor does any
import cv2 or PIL at module level (the machine with the card has
neither): the eval path, Mask R-CNN's train step and eval to the segm
table, Keypoint R-CNN's train step and eval to the keypoints table
(the heatmaps decoded without cv2), and a Pascal VOC evaluation to the
mAP, run on a PPM dataset with both blocked."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paa_tpu_torch")
FORBIDDEN = ("jax", "flax", "paa_tpu")


def _port_sources():
    out = []
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out) + [os.path.join(ROOT, f)
                          for f in ("chip_smoke.py", "kernel_ab.py",
                                    os.path.join("tests", "nms_cases.py"),
                                    os.path.join("tests",
                                                 "reference_layout.py"),
                                    os.path.join("tests",
                                                 "torch_port_dist_worker.py"))]


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    # exact top-level match: "paa_tpu_torch" is not "paa_tpu"
    return name.split(".")[0] in FORBIDDEN


def _module_level_imports(path):
    """Imports outside any function or class body."""
    tree = ast.parse(open(path).read(), filename=path)
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(node))


def test_no_jax_or_paa_tpu_imports():
    sources = _port_sources()
    assert len(sources) > 10
    rel = {os.path.relpath(p, PKG) for p in sources}
    for module in ("data/loader.py", "data/transforms.py", "data/coco.py",
                   "evaluation/coco_eval.py", "engine/inference.py",
                   "tools/test_net.py", "config/paths_catalog.py",
                   "utils/torch_import.py", "utils/comm.py", "utils/misc.py",
                   "tools/train_net.py", "tools/reproduce_ap.py",
                   "modeling/two_stage.py", "modeling/roi_mask_head.py",
                   "structures/masks.py", "evaluation/mask_rle.py",
                   "modeling/roi_keypoint_head.py",
                   "structures/keypoints.py", "modeling/roi_box_head.py",
                   "data/synth.py", "tools/synth_catalog.py",
                   "data/voc.py", "evaluation/voc_eval.py", "serving.py",
                   "tools/export_model.py", "ops/deform_pool.py",
                   "structures/segmentation.py", "utils/registry.py",
                   "utils/timer.py", "tools/quick_overfit.py",
                   "tools/profile_train_step.py", "demo/predictor.py",
                   "demo/demo.py", "demo/webcam.py",
                   "tools/remove_solver_states.py",
                   "tools/cityscapes/convert_cityscapes_to_coco.py",
                   "tools/bench.py", "tools/bench_dcnv2.py",
                   "tools/bench_tta.py", "tools/bench_loader.py",
                   "tools/bench_common.py"):
        assert module in rel, module
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in sources for m in _imported_modules(p) if _forbidden(m)
    ]
    assert not bad, bad


def test_no_module_level_cv2_or_pil_imports():
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in _port_sources() for m in _module_level_imports(p)
        if m.split(".")[0] in ("cv2", "PIL")
    ]
    assert not bad, bad


@pytest.mark.parametrize("name,expected", [
    ("paa_tpu", True), ("paa_tpu.ops.nms", True), ("jax.numpy", True),
    ("flax", True), ("paa_tpu_torch", False), ("paa_tpu_torch.ops", False),
    ("torch", False), ("jaxlib_like", False),
])
def test_forbidden_matches_module_names_exactly(name, expected):
    assert _forbidden(name) is expected


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'paa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import paa_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    paa_tpu_torch.__path__, 'paa_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert 'paa_tpu_torch.modeling.detector' in mods, mods\n"
        "print(len(mods))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_eval_path_runs_with_cv2_and_pil_blocked(tmp_path):
    """The card machine's situation: no cv2, no PIL (and no JAX). A
    synthetic PPM COCO goes through the port's eval path on the CPU, and
    a JPEG raises an ImportError that names the file and cv2."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'jax', 'flax', 'paa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from paa_tpu_torch.engine.inference import inference\n"
        "from paa_tpu_torch.config import get_cfg\n"
        "from paa_tpu_torch.data.coco import COCODataset, read_image\n"
        "from paa_tpu_torch.data.synth import synth_coco\n"
        "from paa_tpu_torch.modeling import build_detection_model\n"
        "cfg = get_cfg()\n"
        "cfg.merge_from_list(['MODEL.PAA_ON', True, 'MODEL.RPN_ONLY', True,\n"
        "    'MODEL.BACKBONE.CONV_BODY', 'R-50-FPN-RETINANET',\n"
        "    'MODEL.RETINANET.USE_C5', False,\n"
        "    'MODEL.RESNETS.BACKBONE_OUT_CHANNELS', 32,\n"
        "    'MODEL.RESNETS.WIDTH_PER_GROUP', 8,\n"
        "    'MODEL.RESNETS.STEM_OUT_CHANNELS', 8,\n"
        "    'MODEL.RESNETS.RES2_OUT_CHANNELS', 32,\n"
        "    'TPU.COMPUTE_DTYPE', 'float32', 'INPUT.MIN_SIZE_TEST', 64,\n"
        "    'INPUT.MAX_SIZE_TEST', 96, 'TPU.TEST_BUCKETS', ((96, 96),),\n"
        "    'TEST.IMS_PER_BATCH', 2])\n"
        "model = build_detection_model(cfg, device='cpu')\n"
        f"root = {str(tmp_path)!r}\n"
        "ann, imgs = synth_coco(root, 3, sizes=((96, 64), (64, 96)))\n"
        "r = inference(cfg, model, COCODataset(ann, imgs, False))\n"
        "assert len(r) == 12, r\n"
        "open(root + '/x.jpg', 'wb').write(b'\\xff\\xd8\\xff\\xe0')\n"
        "try:\n"
        "    read_image(root + '/x.jpg')\n"
        "except ImportError as e:\n"
        "    assert 'x.jpg' in str(e) and 'cv2' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('a JPEG decoded without cv2')\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_mask_path_runs_with_cv2_and_pil_blocked(tmp_path):
    """Mask R-CNN on the card machine's terms: with cv2, PIL and JAX
    blocked, a slim Mask R-CNN takes a train step from the loader's
    batch (polygons rasterized without cv2) and evaluates a synthetic
    PPM COCO to the bbox and segm tables (masks pasted without cv2)."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'jax', 'flax', 'paa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from paa_tpu_torch.config import get_cfg\n"
        "from paa_tpu_torch.data.coco import COCODataset\n"
        "from paa_tpu_torch.data.loader import make_data_loader\n"
        "from paa_tpu_torch.data.synth import synth_coco\n"
        "from paa_tpu_torch.engine import TrainState\n"
        "from paa_tpu_torch.engine.inference import inference\n"
        "from paa_tpu_torch.modeling import build_detection_model\n"
        "from paa_tpu_torch.solver import make_optimizer\n"
        "cfg = get_cfg()\n"
        "cfg.merge_from_file('configs/e2e_mask_rcnn_R_50_FPN_1x.yaml')\n"
        "cfg.merge_from_list([\n"
        "    'MODEL.RESNETS.BACKBONE_OUT_CHANNELS', 32,\n"
        "    'MODEL.RESNETS.WIDTH_PER_GROUP', 8,\n"
        "    'MODEL.RESNETS.STEM_OUT_CHANNELS', 8,\n"
        "    'MODEL.RESNETS.RES2_OUT_CHANNELS', 32,\n"
        "    'MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM', 32,\n"
        "    'MODEL.ROI_MASK_HEAD.CONV_LAYERS', (16, 16),\n"
        "    'MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE', 32,\n"
        "    'MODEL.ROI_HEADS.SCORE_THRESH', 0.0,\n"
        "    'TPU.COMPUTE_DTYPE', 'float32', 'INPUT.MIN_SIZE_TEST', 64,\n"
        "    'INPUT.MAX_SIZE_TEST', 96, 'TPU.TEST_BUCKETS', ((96, 96),),\n"
        "    'INPUT.MIN_SIZE_TRAIN', (64,), 'INPUT.MAX_SIZE_TRAIN', 96,\n"
        "    'TPU.TRAIN_BUCKETS', ((96, 96),), 'SOLVER.IMS_PER_BATCH', 2,\n"
        "    'SOLVER.MAX_ITER', 1, 'TPU.MAX_GT', 16,\n"
        "    'TEST.IMS_PER_BATCH', 2, 'SOLVER.BASE_LR', 0.001])\n"
        "cfg.freeze()\n"
        "model = build_detection_model(cfg, device='cpu')\n"
        f"root = {str(tmp_path)!r}\n"
        "ann, imgs = synth_coco(root, 3, sizes=((96, 64), (64, 96)))\n"
        "batch = next(iter(make_data_loader(\n"
        "    cfg, COCODataset(ann, imgs, True, with_masks=True))))\n"
        "assert batch['gt_masks'].any()\n"
        "state = TrainState(model.module,\n"
        "                   make_optimizer(cfg, model.module)[0])\n"
        "step = model.make_bucket_train_step(batch['images'].shape[1:3])\n"
        "m = step(state, {k: batch[k] for k in model.train_batch_keys})\n"
        "assert torch.isfinite(m['loss_mask']) and float(m['loss_mask']) > 0\n"
        "r = inference(cfg, model, COCODataset(ann, imgs, False))\n"
        "assert len(r) == 24 and 'segm/AP' in r, r\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_keypoint_path_runs_with_cv2_and_pil_blocked(tmp_path):
    """Keypoint R-CNN on the card machine's terms: with cv2, PIL and JAX
    blocked, a slim Keypoint R-CNN takes a train step from the loader's
    batch (its 'gt_keypoints') and evaluates a synthetic person-keypoint
    PPM COCO to the bbox and keypoints tables (the heatmaps resized
    without cv2)."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'PIL', 'jax', 'flax', 'paa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from paa_tpu_torch.config import get_cfg\n"
        "from paa_tpu_torch.data.coco import COCODataset\n"
        "from paa_tpu_torch.data.loader import make_data_loader\n"
        "from paa_tpu_torch.data.synth import synth_coco\n"
        "from paa_tpu_torch.engine import TrainState\n"
        "from paa_tpu_torch.engine.inference import inference\n"
        "from paa_tpu_torch.modeling import build_detection_model\n"
        "from paa_tpu_torch.solver import make_optimizer\n"
        "cfg = get_cfg()\n"
        "cfg.merge_from_file('configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml')\n"
        "cfg.merge_from_list([\n"
        "    'MODEL.RESNETS.BACKBONE_OUT_CHANNELS', 32,\n"
        "    'MODEL.RESNETS.WIDTH_PER_GROUP', 8,\n"
        "    'MODEL.RESNETS.STEM_OUT_CHANNELS', 8,\n"
        "    'MODEL.RESNETS.RES2_OUT_CHANNELS', 32,\n"
        "    'MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM', 32,\n"
        "    'MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS', (16, 16),\n"
        "    'MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE', 32,\n"
        "    'MODEL.ROI_HEADS.DETECTIONS_PER_IMG', 20,\n"
        "    'TPU.COMPUTE_DTYPE', 'float32', 'INPUT.MIN_SIZE_TEST', 64,\n"
        "    'INPUT.MAX_SIZE_TEST', 96, 'TPU.TEST_BUCKETS', ((96, 96),),\n"
        "    'INPUT.MIN_SIZE_TRAIN', (64,), 'INPUT.MAX_SIZE_TRAIN', 96,\n"
        "    'TPU.TRAIN_BUCKETS', ((96, 96),), 'SOLVER.IMS_PER_BATCH', 2,\n"
        "    'SOLVER.MAX_ITER', 1, 'TPU.MAX_GT', 16,\n"
        "    'TEST.IMS_PER_BATCH', 2, 'SOLVER.BASE_LR', 0.001])\n"
        "cfg.freeze()\n"
        "model = build_detection_model(cfg, device='cpu')\n"
        f"root = {str(tmp_path)!r}\n"
        "ann, imgs = synth_coco(root, 3, sizes=((96, 64), (64, 96)),\n"
        "                       person_keypoints=True)\n"
        "batch = next(iter(make_data_loader(\n"
        "    cfg, COCODataset(ann, imgs, True, with_keypoints=True))))\n"
        "assert batch['gt_keypoints'][..., 2].any()\n"
        "state = TrainState(model.module,\n"
        "                   make_optimizer(cfg, model.module)[0])\n"
        "step = model.make_bucket_train_step(batch['images'].shape[1:3])\n"
        "m = step(state, {k: batch[k] for k in model.train_batch_keys})\n"
        "assert torch.isfinite(m['loss_kp']) and float(m['loss_kp']) > 0\n"
        "r = inference(cfg, model, COCODataset(ann, imgs, False))\n"
        "assert len(r) == 22 and 'keypoints/AP' in r, r\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")


def test_voc_path_runs_with_cv2_and_pil_blocked(tmp_path):
    """Pascal VOC on the card machine's terms: with cv2, PIL and JAX
    blocked, a synthetic VOC tree (PPM bytes under .jpg names) goes
    through the catalog, the loader, ``compute_on_dataset`` and
    ``do_voc_evaluation`` of a slim 21-class PAA model."""
    code = (
        "import math, sys\n"
        "for m in ('cv2', 'PIL', 'jax', 'flax', 'paa_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from paa_tpu_torch.config import get_cfg\n"
        "from paa_tpu_torch.data.build import build_dataset\n"
        "from paa_tpu_torch.data.loader import make_data_loader\n"
        "from paa_tpu_torch.engine.inference import compute_on_dataset\n"
        "from paa_tpu_torch.evaluation import voc_eval\n"
        "from paa_tpu_torch.modeling import build_detection_model\n"
        "cfg = get_cfg()\n"
        "cfg.merge_from_list(['MODEL.PAA_ON', True, 'MODEL.RPN_ONLY', True,\n"
        "    'MODEL.BACKBONE.CONV_BODY', 'R-50-FPN-RETINANET',\n"
        "    'MODEL.RETINANET.USE_C5', False, 'MODEL.PAA.NUM_CLASSES', 21,\n"
        "    'MODEL.RESNETS.BACKBONE_OUT_CHANNELS', 32,\n"
        "    'MODEL.RESNETS.WIDTH_PER_GROUP', 8,\n"
        "    'MODEL.RESNETS.STEM_OUT_CHANNELS', 8,\n"
        "    'MODEL.RESNETS.RES2_OUT_CHANNELS', 32,\n"
        "    'TPU.COMPUTE_DTYPE', 'float32', 'INPUT.MIN_SIZE_TEST', 64,\n"
        "    'INPUT.MAX_SIZE_TEST', 96, 'TPU.TEST_BUCKETS', ((96, 96),),\n"
        "    'TEST.IMS_PER_BATCH', 2,\n"
        "    'PATHS_CATALOG', 'paa_tpu_torch/tools/synth_catalog.py'])\n"
        "cfg.freeze()\n"
        "model = build_detection_model(cfg, device='cpu')\n"
        "ds = build_dataset(cfg, ('synth_voc_4_test',), is_train=False)\n"
        "preds, *_ = compute_on_dataset(\n"
        "    model, make_data_loader(cfg, ds, is_train=False))\n"
        "r = voc_eval.do_voc_evaluation(\n"
        "    ds, voc_eval.predictions_from_xywh(preds))\n"
        "assert r['ap'].shape == (21,) and len(preds) == 4, r\n"
        "assert not math.isnan(r['map']) or not any(\n"
        "    len(p['labels']) for p in preds.values())\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PAA_TPU_TORCH_SYNTH_DIR": str(tmp_path)},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("ok")

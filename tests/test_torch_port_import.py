"""The PyTorch port stands alone: it imports without JAX, and no module of
paa_tpu_torch (nor chip_smoke.py, kernel_ab.py, the NMS cases and the
reference checkpoint layouts they share with the tests,
tests/nms_cases.py and tests/reference_layout.py, nor the distributed
tests' worker) names jax, flax or paa_tpu in an import. Nor does any
import cv2 or PIL at module level (the machine with the card has
neither): the eval path runs on a PPM dataset with both blocked."""

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
                   "tools/train_net.py", "tools/reproduce_ap.py"):
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

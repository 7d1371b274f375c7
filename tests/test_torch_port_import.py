"""The PyTorch port stands alone: it imports without JAX, and no module of
paa_tpu_torch (nor chip_smoke.py, kernel_ab.py or the NMS cases they
share with the tests, tests/nms_cases.py) names jax, flax or paa_tpu in
an import."""

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
                                    os.path.join("tests", "nms_cases.py"))]


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


def test_no_jax_or_paa_tpu_imports():
    sources = _port_sources()
    assert len(sources) > 10
    bad = [
        (os.path.relpath(p, ROOT), m)
        for p in sources for m in _imported_modules(p) if _forbidden(m)
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

"""Nothing the benchmark runs imports JAX or the JAX package: a narrow
run of the harness's CPU-side path in a fresh process, its detector
family loaded, loads no module whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or ``paa_tpu`` (``paa_tpu_torch``, the
program, is another name). And the plain reference and the families
that hold the program to it import nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark.harness import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "paa_tpu"}

SCRIPT = r"""
import io, json, sys, tempfile
import torch
torch.set_num_threads(2)
from benchmark.harness import main
from benchmark.tests import tiny
spec = [("n.serve", tiny.narrow_config("paa_x152_dcnv2_2x"),
         tiny.narrow_traffic("serve")),
        ("n.train", tiny.narrow_config("paa_r50_1x"),
         tiny.narrow_traffic("train"))]
root = tiny.make_root(tempfile.mkdtemp(), spec)
for cell in ("n.serve", "n.train"):
    for trace in (False, True):
        out = io.StringIO()
        rc = main.run_cell(cell, 2**31 + 1, 0.3, trace,
                           torch.device("cpu"), root=root, out=out,
                           err=io.StringIO())
        assert rc == 0, rc
        json.loads(out.getvalue().strip().splitlines()[-1])
from benchmark.harness import cells
assert cells.load_cell("n.serve", root).family.__name__ == "bench_family_paa"
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_harness_run_loads_no_jax():
    repo = os.path.dirname(cells.HERE)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    loaded = set(__import__("json").loads(r.stdout.strip().splitlines()[-1]))
    assert "paa_tpu_torch" in loaded and not loaded & FORBIDDEN


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(cells.HERE, "reference")
    for path in _sources(ref):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"paa_tpu_torch", "benchmark"}), \
            path


def test_families_import_nothing_of_the_program_or_jax():
    """A family reaches the program only through what the runner hands
    it (the model, its outputs); it imports neither the program nor
    JAX."""
    paths = list(_sources(os.path.join(cells.HERE, "families")))
    assert any(p.endswith("paa.py") for p in paths)
    for path in paths:
        assert not set(_imports(path)) & (FORBIDDEN | {"paa_tpu_torch"}), \
            path


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources(cells.HERE):
        assert not set(_imports(path)) & FORBIDDEN, path

"""Finds everything a cell needs by the names in ``BENCHMARK.json``, so
that a cell, configuration, traffic mix or per-layer metric is added by
adding files:

- the configuration: the file its entry names (``configs/<name>.json``);
- the detector family that the configuration's ``"family"`` key names:
  ``benchmark/families/<family>.py``, whose functions give the runner
  what depends on the model (the reference's weights' shapes and
  FLOPs, the pools, what to capture, the comparisons, the control);
- the traffic mix: ``benchmark/traffic/<traffic>.json``;
- a per-layer metric: its reader ``benchmark/metrics/<metric>.py``;
- the limits of the correctness check: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
BENCH_DIR = os.path.basename(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's content
    traffic: dict  # the traffic mix's parameters
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict = field(default_factory=dict)
    root: str = REPO
    family: object = None  # the module families/<family>.py

    @property
    def kind(self):
        return self.traffic["kind"]


def read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=REPO):
    return read_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name, root=REPO):
    """The cell ``name`` of ``root``'s BENCHMARK.json. Raises KeyError
    for a name the file does not hold, ValueError for a configuration
    whose ``family`` is missing or names no file of ``families/``."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = read_json(os.path.join(root, conf["file"]))
    limits_path = os.path.join(root, BENCH_DIR, "limits", f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=read_json(os.path.join(root, BENCH_DIR, "traffic",
                                       f"{w['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        limits=(read_json(limits_path) if os.path.exists(limits_path)
                else {}),
        root=root, family=load_family(config.get("family"), root))


def _load(path, module_name):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_family(name, root=REPO):
    """The module ``families/<name>.py`` of ``root``. Raises ValueError,
    naming the families there, for a missing or unknown name."""
    folder = os.path.join(root, BENCH_DIR, "families")
    found = sorted(f[:-3] for f in os.listdir(folder)
                   if f.endswith(".py") and not f.startswith("_"))
    if name not in found:
        raise ValueError(f"configuration family {name!r} is not one of "
                         f"the families in {folder}: {found}")
    return _load(os.path.join(folder, f"{name}.py"), f"bench_family_{name}")


def metric_reader(name, root=REPO):
    """The ``read(view)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, BENCH_DIR, "metrics", f"{name}.py")
    return _load(path, f"bench_metric_{name.replace('.', '_')}").read

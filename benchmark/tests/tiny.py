"""Narrow copies of the benchmark's configurations and traffic, and a
throwaway benchmark root holding them, for runs of the harness on the
CPU in tests. The real configuration files stay as they are: a narrow
one is written beside them in a temporary copy."""

from __future__ import annotations

import copy
import json
import os
import shutil

from benchmark.harness import cells

NARROW = {  # program key: value, reference section path: value
    "MODEL.RESNETS.STEM_OUT_CHANNELS": (16, ("body", "stem_out")),
    "MODEL.RESNETS.RES2_OUT_CHANNELS": (32, ("body", "res2_out")),
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS": (32, ("fpn", "out_channels")),
    "MODEL.PAA.NUM_CLASSES": (6, ("head", "num_classes")),
}
HW, CONTENT = [64, 96], [64, 90]


def narrow_config(name, dtype="float32"):
    """The configuration ``name`` at test widths: 16/32-channel body
    stages (WIDTH_PER_GROUP scaled with them), a 32-channel FPN and head,
    5 classes, computed in ``dtype``."""
    path = os.path.join(cells.HERE, "configs", f"{name}.json")
    conf = copy.deepcopy(cells.read_json(path))
    conf["name"] = f"{name}_narrow"
    for key, (value, (sec, field)) in NARROW.items():
        conf["cfg"][key] = value
        ref_value = value - 1 if key.endswith("NUM_CLASSES") else value
        conf["reference"][sec][field] = ref_value
    width = max(1, conf["reference"]["body"]["width_per_group"] // 8)
    conf["cfg"]["MODEL.RESNETS.WIDTH_PER_GROUP"] = width
    conf["reference"]["body"]["width_per_group"] = width
    conf["cfg"]["TPU.COMPUTE_DTYPE"] = dtype
    return conf


def narrow_traffic(kind, batch=2, pool=2):
    t = {"kind": kind, "batch": batch, "hw": HW, "content_hw": CONTENT,
         "pool": pool, "reference_block": 1}
    if kind == "serve":
        t["trace_calls"] = 2
    else:
        t.update(slots=6, gt_counts=[1, 2, 3], gt_side=[8, 0.6],
                 gt_aspect=[0.5, 2.0], trace_steps=2, reference_steps=2)
    return t


def make_root(tmp, cells_spec, limits=None):
    """A benchmark root under ``tmp``: a copy of the benchmark folder and
    a BENCHMARK.json whose workloads are ``cells_spec`` [(cell, config
    dict, traffic dict)], each with the real metrics that apply to its
    kind. Returns the root."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(cells.HERE, os.path.join(root, cells.BENCH_DIR),
                    ignore=shutil.ignore_patterns("__pycache__"))
    real = cells.load_benchmark()
    bench = {k: copy.deepcopy(v) for k, v in real.items()}
    bench["configs"], bench["workloads"] = [], []
    names = {"serve": [], "train": []}
    for cell, conf, traffic in cells_spec:
        kind = traffic["kind"]
        base = os.path.join(root, cells.BENCH_DIR)
        with open(os.path.join(base, "configs", conf["name"] + ".json"),
                  "w") as f:
            json.dump(conf, f)
        with open(os.path.join(base, "traffic", cell + ".json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(base, "limits", cell + ".json"), "w") as f:
            json.dump(limits or {}, f)
        if conf["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({
                "name": conf["name"], "source": conf["source"],
                "file": f"{cells.BENCH_DIR}/configs/{conf['name']}.json",
                "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": conf["name"],
                                   "traffic": cell, "chips": 1,
                                   "why": "test"})
        names[kind].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "train" if m["name"].startswith("train") else "serve"
            m["workloads"] = list(names[kind])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root

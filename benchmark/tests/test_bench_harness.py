"""The harness: cells, configurations, traffic mixes and metrics found by
their names in BENCHMARK.json, so that adding one adds files only; the
same seed giving the same inputs and weights; the result line and the
names under the benchmark's character rules; no result without a card;
and ``correct`` false when the program under the timed path is broken
(a detection altered, half the batch left out, a train step that leaves
its state unchanged, a step on half its batch)."""

import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark.families import paa
from benchmark.harness import cells, main, program, weights as W
from benchmark.tests import tiny

CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _limits(cell):
    return cells.read_json(os.path.join(cells.HERE, "limits",
                                        f"{cell}.json"))


@pytest.fixture
def root(tmp_path):
    """Narrow serving and training cells of both configurations, held
    to the real cells' limits; the reference's batch in one block, as
    the program's."""
    spec = [
        ("n.serve_r50", tiny.narrow_config("paa_r50_1x"),
         dict(tiny.narrow_traffic("serve"), reference_block=2)),
        ("n.serve_x152", tiny.narrow_config("paa_x152_dcnv2_2x"),
         dict(tiny.narrow_traffic("serve"), reference_block=2)),
        ("n.train_r50", tiny.narrow_config("paa_r50_1x"),
         dict(tiny.narrow_traffic("train"), reference_block=2)),
        ("n.train_x152", tiny.narrow_config("paa_x152_dcnv2_2x"),
         dict(tiny.narrow_traffic("train"), reference_block=2)),
    ]
    r = tiny.make_root(tmp_path, spec)
    for cell, real in (("n.serve_r50", "paa_r50_1x.serve_b48"),
                       ("n.serve_x152", "paa_x152_dcnv2_2x.serve_b8"),
                       ("n.train_r50", "paa_r50_1x.train_b16"),
                       ("n.train_x152", "paa_x152_dcnv2_2x.train_b8")):
        with open(os.path.join(r, cells.BENCH_DIR, "limits",
                               f"{cell}.json"), "w") as f:
            json.dump(_limits(real), f)
    return r


def _limits_of(root, cell):
    return cells.read_json(os.path.join(root, cells.BENCH_DIR, "limits",
                                        f"{cell}.json"))


def _run(root, cell, trace=False, seed=2**31 + 5):
    out, err = io.StringIO(), io.StringIO()
    rc = main.run_cell(cell, seed, 0.5, trace, CPU, root=root, out=out,
                       err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()


def test_benchmark_json_follows_the_rules():
    bench = cells.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    cell_names = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(cell_names) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cell_names)) <= set(cell_names)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = e2e[m["moves"]].get("workloads", cell_names)
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = cells.load_cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        assert os.path.exists(os.path.join(cells.HERE, "limits",
                                           w["name"] + ".json"))
    for c in bench["configs"]:
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_same_seed_same_inputs_and_weights():
    conf = tiny.narrow_config("paa_x152_dcnv2_2x")
    shapes = paa.state_shapes(conf)
    seed = 2**31 + 99
    a = W.make_weights(shapes, conf["weights"], seed, CPU)
    b = W.make_weights(shapes, conf["weights"], seed, CPU)
    c = W.make_weights(shapes, conf["weights"], seed + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.cls_tower.conv0.weight"],
                           c["head.cls_tower.conv0.weight"])
    lift = a["head.cls_logits.bias"]
    assert float(lift.min()) >= -3.5 and float(lift.max()) <= -2.5
    tr = tiny.narrow_traffic("train")
    for make in (lambda s: W.image_pool(tr, s, CPU),
                 lambda s: W.gt_pool(tr, s, 5)):
        x, y, z = make(seed), make(seed), make(seed + 1)
        assert all(torch.equal(p, q) for u, v in zip(x, y)
                   for p, q in zip(u, v))
        assert not torch.equal(x[0][0], z[0][0])
    # every seed gets the same number of GTs, in another order
    counts = [sorted(int((l > 0).sum()) for l in torch.cat(
        [g[1] for g in W.gt_pool(tr, s, 5)])) for s in (1, 2, 3)]
    assert counts[0] == counts[1] == counts[2]


# A second family, in a file of its own: the PAA model judged on two of
# its head outputs alone, captured by a hook on the submodule named
# "head", and on two loss terms and the positives.
FAMILY = '''
import contextlib

from benchmark.families import paa
from benchmark.harness import checks

HEADS = ("cls_logits", "iou_pred")
STEP_RECORDS = ("loss_cls", "loss", "num_pos")
state_shapes, flops, serve_pool, train_pool, reference_run = (
    paa.state_shapes, paa.flops, paa.serve_pool, paa.train_pool,
    paa.reference_run)


@contextlib.contextmanager
def capture(model):
    heads = []
    module = dict(model.module.named_modules())["head"]
    hook = module.register_forward_hook(
        lambda m, i, o: heads.append({k: o[k].cpu() for k in HEADS}))
    try:
        yield heads
    finally:
        hook.remove()


def judge(cell, wts, pool, heads, calls, outputs, device):
    ref = paa.reference_heads(cell, wts, pool, device, "float32", HEADS)
    _, counts = paa.reference_anchors(cell.config["reference"],
                                      cell.traffic["hw"], "cpu")
    gap = checks.HeadGap(HEADS, len(counts))
    for p, r in zip(heads, ref):
        for k in HEADS:
            for li, sl in enumerate(paa.level_slices(counts)):
                gap.add(k, li, p[k][:, sl], r[k][:, sl])
    return {"head_gap": gap.worst()}, {"head_gap_by_level": gap.values()}, 0


def train_judge(records, grad, change, ref_run):
    return paa.train_judge(records, grad, change, ref_run,
                           ("loss_cls", "loss"))
'''
RUNNER = ("run.py", "control.py", *(f"harness/{f}" for f in sorted(
    os.listdir(os.path.join(cells.HERE, "harness"))) if f.endswith(".py")))


def _runner_bytes():
    return {p: open(os.path.join(cells.HERE, p), "rb").read()
            for p in RUNNER}


def _add(root, cells_spec, metric=None):
    """Adds files and entries to ``root``'s benchmark: [(cell, config,
    traffic, limits)] and a per-layer metric (name, source, workloads)."""
    bench_dir = os.path.join(root, cells.BENCH_DIR)
    path = os.path.join(root, "BENCHMARK.json")
    bench = cells.read_json(path)
    for cell, conf, traffic, limits in cells_spec:
        with open(os.path.join(bench_dir, "configs",
                               f"{conf['name']}.json"), "w") as f:
            json.dump(conf, f)
        with open(os.path.join(bench_dir, "traffic", f"{cell}.mix.json"),
                  "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(bench_dir, "limits", f"{cell}.json"),
                  "w") as f:
            json.dump(limits, f)
        if conf["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({
                "name": conf["name"], "source": "test",
                "file": f"{cells.BENCH_DIR}/configs/{conf['name']}.json",
                "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": conf["name"],
                                   "traffic": f"{cell}.mix", "chips": 1,
                                   "why": "test"})
        moves = f"{traffic['kind']}_img_per_s"
        for m in bench["end_to_end"]:
            if m["name"] == moves:
                m["workloads"].append(cell)
    if metric:
        name, source, workloads = metric
        with open(os.path.join(bench_dir, "metrics", f"{name}.py"),
                  "w") as f:
            f.write(source)
        bench["per_layer"].append({
            "name": name, "unit": "calls", "better": "higher",
            "source": "program_counter", "layer": "test",
            "moves": "serve_img_per_s", "workloads": workloads})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_added_cell_config_traffic_and_metric_found_by_name(root):
    """New cells of new configurations under new traffic mixes, one of
    them of a new detector family, with a new per-layer metric, each a
    file added beside the others: the harness finds and runs them, its
    runner (``harness/``, ``run.py``, ``control.py``) editing none."""
    before = _runner_bytes()
    conf = tiny.narrow_config("paa_r50_1x")
    conf["name"] = "added_config"
    other = dict(tiny.narrow_config("paa_r50_1x"), name="other_config",
                 family="paa_two_heads")
    with open(os.path.join(root, cells.BENCH_DIR, "families",
                           "paa_two_heads.py"), "w") as f:
        f.write(FAMILY)
    serve_limits = _limits("paa_r50_1x.serve_b48")
    _add(root, [
        ("added.cell", conf, dict(tiny.narrow_traffic("serve", batch=1,
                                                      pool=3),
                                  reference_block=1), serve_limits),
        ("other.serve", other, tiny.narrow_traffic("serve"),
         {"head_gap": serve_limits["head_gap"]}),
        ("other.train", other, tiny.narrow_traffic("train"),
         _limits("paa_r50_1x.train_b16"))],
        ("serve.calls_seen", "def read(view):\n"
         "    return float(view.calls)\n", ["added.cell", "other.serve"]))
    cell = cells.load_cell("added.cell", root)
    assert cell.traffic["pool"] == 3 and cell.config["name"] == "added_config"
    assert cells.load_cell("other.train", root).family.STEP_RECORDS == (
        "loss_cls", "loss", "num_pos")
    rc, res, _ = _run(root, "added.cell", trace=True)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["serve.calls_seen"]["value"] == 2.0

    out, err = io.StringIO(), io.StringIO()
    for name in ("other.serve", "other.train"):
        assert main.run_cell(name, 2**31 + 5, 0.5, False, CPU, root=root,
                             out=out, err=err) == 0
    lines = [json.loads(x) for x in out.getvalue().strip().splitlines()]
    serve_info, serve_res, train_info, train_res = lines
    assert serve_res["correct"] and train_res["correct"]
    assert list(serve_res["checks"]) == ["head_gap"]
    assert set(serve_info["detail"]["head_gap_by_level"]) == {
        f"{k}.P{l}" for k in ("cls_logits", "iou_pred") for l in range(3, 8)}
    assert all(set(r) == {"loss_cls", "loss", "num_pos"}
               for r in train_info["detail"]["losses"])
    assert set(train_res["checks"]) == set(_limits("paa_r50_1x.train_b16"))
    assert before == _runner_bytes()


@pytest.mark.parametrize("family", [None, "no_such_family"])
def test_missing_or_unknown_family_names_the_families(root, family):
    conf = dict(tiny.narrow_config("paa_r50_1x"), name="orphan",
                family=family)
    if family is None:
        del conf["family"]
    _add(root, [("orphan.serve", conf, tiny.narrow_traffic("serve"),
                 _limits("paa_r50_1x.serve_b48"))])
    with pytest.raises(ValueError, match=r"\['paa'\]") as e:
        cells.load_cell("orphan.serve", root)
    assert repr(family) in str(e.value)


@pytest.mark.parametrize("cell", ["n.serve_r50", "n.serve_x152",
                                  "n.train_r50", "n.train_x152"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_its_line_has_the_contract_keys(
        root, cell, trace):
    rc, res, err = _run(root, cell, trace)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert set(res) == KEYS | ({"breakdown"} if trace else set())
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1
    bench = cells.load_benchmark(root)
    want = {m["name"]: m["unit"] for m in
            (bench["per_layer"] if trace else bench["end_to_end"])
            if cell in m.get("workloads", [cell])}
    for name, m in res["metrics"].items():
        assert want[name] == m["unit"] and isinstance(m["value"], float)
    if not trace:  # on the CPU the device readers find nothing
        assert set(res["metrics"]) == set(want)
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)
    assert set(res["checks"]) == set(_limits_of(root, cell))
    for n, c in res["checks"].items():
        assert c["value"] <= c["limit"]


def _break_detections(monkeypatch):
    from paa_tpu_torch.modeling import detector

    real = detector.paa_postprocess

    def altered(*args, **kwargs):
        out = dict(real(*args, **kwargs))
        out["boxes"] = out["boxes"] + 1.0 * out["valid"][..., None]
        return out

    monkeypatch.setattr(detector, "paa_postprocess", altered)


def _half_batch_serving(monkeypatch):
    """The second half of each batch left without detections."""
    from paa_tpu_torch.modeling import detector

    real = detector.paa_postprocess

    def half(*args, **kwargs):
        out = real(*args, **kwargs)
        n = out["valid"].shape[0] // 2
        return {k: torch.cat([v[:n], torch.zeros_like(v[n:])])
                for k, v in out.items()}

    monkeypatch.setattr(detector, "paa_postprocess", half)


def _state_unchanged(monkeypatch):
    real = program.train_state

    def frozen(model):
        state = real(model)
        step = state.optimizer.step

        def no_move(*a, **k):
            keep = [p.detach().clone() for p in model.module.parameters()]
            step(*a, **k)
            with torch.no_grad():
                for p, k0 in zip(model.module.parameters(), keep):
                    p.copy_(k0)

        state.optimizer.step = no_move
        return state

    monkeypatch.setattr(program, "train_state", frozen)


def _half_batch_training(monkeypatch):
    from paa_tpu_torch.modeling.detector import DetectionModel

    real = DetectionModel.make_bucket_train_step

    def half_step(self, hw):
        step = real(self, hw)

        def on_half(state, batch):
            n = batch["images"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})

        return on_half

    monkeypatch.setattr(DetectionModel, "make_bucket_train_step", half_step)


@pytest.mark.parametrize("cell,fault", [
    ("n.serve_r50", _break_detections),
    ("n.serve_r50", _half_batch_serving),
    ("n.serve_x152", _break_detections),
    ("n.train_r50", _state_unchanged),
    ("n.train_r50", _half_batch_training),
    ("n.train_x152", _state_unchanged),
    ("n.train_x152", _half_batch_training),
])
def test_broken_program_is_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, res, _ = _run(root, cell)
    assert rc == 0 and res["correct"] is False and res["failed"] >= 1


def test_control_fails_at_test_size(root):
    """The fp8 control, and each planted fault of training, in the
    program's place fails the real cells' limits at the narrow size."""
    from benchmark.harness import checks, control

    for cell_name in ("n.serve_r50", "n.serve_x152", "n.train_r50",
                      "n.train_x152"):
        cell = cells.load_cell(cell_name, root)
        got = control.readings(cell, [2**31 + 11], CPU, lambda m: None)
        for fault, numbers in got[2**31 + 11].items():
            nums = {k: v for k, v in numbers.items() if k in cell.limits}
            assert not checks.verdict(nums, cell.limits)[0], (cell_name,
                                                              fault)


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero, printing no
    result (here, where torch has no CUDA)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    repo = os.path.dirname(cells.HERE)
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "paa_r50_1x.serve_b48", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=repo, capture_output=True, text=True,
        timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["paa_r50_1x.serve_b48",
                                  "paa_r50_1x.train_b16"])
def test_cell_on_the_card(card, cell):
    out, err = io.StringIO(), io.StringIO()
    assert main.run_cell(cell, 2**31 + 77, 2.0, False, card, out=out,
                         err=err) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


def test_jax_in_the_process_stops_the_run(root, monkeypatch):
    """A JAX module loaded by the time the window has closed: exit
    non-zero, no result; the port's own name does not count."""
    import types

    assert main.forbidden_modules() == []  # paa_tpu_torch is loaded
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    rc = main.run_cell("n.serve_r50", 2**31 + 5, 0.2, False, CPU,
                       root=root, out=out, err=err)
    assert rc != 0 and out.getvalue() == "" and "jax" in err.getvalue()

"""Data parallelism of the PyTorch port over two real processes (gloo on
the CPU, launched as torchrun launches them, JAX blocked in them; after
tests/test_distributed_2proc.py), at the narrow config of
tests/test_torch_port_train.py.

Each rank (tests/torch_port_dist_worker.py) joins through
``init_distributed``, gathers a payload with ``all_gather_pickled``,
takes one ``make_bucket_train_step`` step on its interleaved half of a
global batch of 4 (DistributedDataParallel, the loss's positive count
and IoU sum summed over the ranks) and evaluates a 5-image PPM dataset
through ``inference`` (round-robin batches, predictions gathered).

- The two-rank step equals the one-process port step on the same global
  batch, and the JAX package's step on it: ``num_pos`` and the positive
  mask equal, the losses within 1e-5 relative, the updated parameters
  within 1e-6 absolute (test_torch_port_train.py's limits);
- the two-rank eval gives the one-process eval's detections (bbox.json)
  and AP table, written by the main process only;
- a checkpoint saved under DDP has no ``module.`` prefix and loads into
  one process;
- ``all_gather_pickled`` returns every rank's object in rank order; in
  one process, the object alone.

The global batch is seed 2's. On seed 4's, the two packages' steps
differ by one positive anchor, and the test of that batch shows why: fed
the same candidate losses the two assignments agree, and the GT at fault
has a two-candidate foreground whose GMM scores differ by 2.8e-6, so
float32 rounding decides which is its maximum (ROADMAP.md section 3).

The workers run under a deadline: a hang fails the test and kills both.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paa_tpu.engine.train_step import TrainState as JTrainState
from paa_tpu.modeling import build_detection_model as jax_build
from paa_tpu.modeling.paa_loss import PAALossConfig as JPAALossConfig
from paa_tpu.modeling.paa_loss import paa_loss as jax_paa_loss
from paa_tpu.solver import make_optimizer as jax_make_optimizer
from paa_tpu_torch.data.coco import COCODataset
from paa_tpu_torch.data.synth import synth_coco
from paa_tpu_torch.engine import TrainState
from paa_tpu_torch.engine.inference import inference
from paa_tpu_torch.modeling import build_detection_model
from paa_tpu_torch.modeling.paa_loss import PAALossConfig, paa_loss
from paa_tpu_torch.solver import make_optimizer
from paa_tpu_torch.utils import comm, load_jax_params
from paa_tpu_torch.utils.checkpoint import load_weights
from test_torch_port_eval import EVAL, SIZES
from test_torch_port_model import _seeded_params
from test_torch_port_train import (
    HW, OVERRIDES, _cfgs, _in_port_layout, _to_np, _with_pos_mask)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_dist_worker.py")
WORLD = 2
BATCH_SEED, TIE_SEED = 2, 4
DEADLINE_S = 600


def _global_batch(seed, bsz=4, max_gt=6):
    """uint8 images (content within 64x96) with 2-4 valid GTs of 20-60 px
    each (labels 1..80), the other slots padding."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (bsz, *HW, 3)).astype(np.uint8)
    sizes = np.asarray([[64.0, 96.0], [60.0, 90.0], [64.0, 80.0],
                        [56.0, 96.0]], np.float32)[:bsz]
    gt_boxes = np.zeros((bsz, max_gt, 4), np.float32)
    gt_labels = np.zeros((bsz, max_gt), np.int32)
    for b, n in zip(range(bsz), (3, 2, 4, 2)):
        xy = rng.uniform(0, 30, (n, 2))
        box = np.concatenate([xy, xy + rng.uniform(20, 60, (n, 2))], axis=1)
        box[:, 2] = np.minimum(box[:, 2], sizes[b, 1] - 1)
        box[:, 3] = np.minimum(box[:, 3], sizes[b, 0] - 1)
        gt_boxes[b, :n] = box
        gt_labels[b, :n] = rng.randint(1, 81, n)
    return {"images": images, "image_sizes": sizes, "gt_boxes": gt_boxes,
            "gt_labels": gt_labels}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(job_path, out_path):
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "WORLD_SIZE": str(WORLD),
               "RANK": str(rank), "LOCAL_RANK": str(rank),
               "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, job_path, out_path], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs):
    """Both workers' logs; fails (and kills the survivor) when one exits
    non-zero or the deadline passes."""
    deadline = time.time() + DEADLINE_S
    failure = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failure = "a worker exited non-zero"
            break
        if time.time() > deadline:
            failure = "the distributed workers timed out"
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    logs = [p.communicate()[0] or "" for p in procs]
    if failure or any(p.returncode for p in procs):
        pytest.fail(f"{failure}" + "".join(
            f"\n--- rank {i} (rc={p.returncode}) ---\n{log[-4000:]}"
            for i, (p, log) in enumerate(zip(procs, logs))))


def _top3_dataset(root, cfg, model):
    """5 images whose ground truth is one process's three best
    detections of each on a first pass (so that the AP is far from 0)."""
    ann_file, img_dir = synth_coco(os.path.join(root, "coco"), 5, seed=7,
                                   sizes=SIZES)
    first = os.path.join(root, "first")
    inference(cfg, model, COCODataset(ann_file, img_dir, False),
              output_folder=first)
    with open(ann_file) as f:
        data = json.load(f)
    with open(os.path.join(first, "bbox.json")) as f:
        dets = json.load(f)
    data["annotations"] = []
    for img in data["images"]:
        mine = sorted((d for d in dets if d["image_id"] == img["id"]),
                      key=lambda d: -d["score"])[:3]
        for d in mine:
            data["annotations"].append(dict(
                id=len(data["annotations"]) + 1, image_id=img["id"],
                bbox=d["bbox"], area=d["bbox"][2] * d["bbox"][3],
                category_id=d["category_id"], iscrowd=0))
    ann_file = os.path.join(root, "top3.json")
    with open(ann_file, "w") as f:
        json.dump(data, f)
    return ann_file, img_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' outputs beside one process's (the port's and the
    JAX package's) on the same inputs; the one-process work runs while
    the workers do."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("port_dist"))
    jcfg, cfg = _cfgs()
    jmodel = jax_build(jcfg)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    params = _seeded_params(shapes, np.random.RandomState(0))
    batch = _global_batch(BATCH_SEED)

    ecfg = _cfgs(EVAL)[1]
    emodel = build_detection_model(ecfg, device="cpu", seed=1)
    load_jax_params(emodel.module, params)
    ann_file, img_dir = _top3_dataset(root, ecfg, emodel)

    job = {"train_overrides": OVERRIDES, "params": params, "batch": batch,
           "eval_overrides": OVERRIDES + EVAL, "ann_file": ann_file,
           "img_dir": img_dir, "ckpt_dir": os.path.join(root, "ckpt"),
           "eval_dir": os.path.join(root, "eval_2p")}
    os.makedirs(job["ckpt_dir"])
    job_path, out_path = os.path.join(root, "job.pkl"), os.path.join(
        root, "out.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    procs = _spawn(job_path, out_path)
    try:
        one = {}
        # the port in one process, the same global batch
        model = build_detection_model(cfg, device="cpu")
        load_jax_params(model.module, params)
        model.loss_fn = lambda: (_with_pos_mask(paa_loss),
                                 PAALossConfig.from_cfg(cfg))
        state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
        metrics = model.make_bucket_train_step(HW)(state, batch)
        one["port"] = {
            "pos_mask": metrics.pop("pos_mask").numpy(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.detach().clone()
                       for n, p in model.module.named_parameters()}}
        # the JAX package's step
        tx, labels = jax_make_optimizer(jcfg, params)
        jstate = JTrainState.create(jmodel.module.apply,
                                    jax.tree.map(jnp.asarray, params), tx)
        jmodel.loss_fn = lambda: (_with_pos_mask(jax_paa_loss),
                                  JPAALossConfig.from_cfg(jcfg))
        jstep = jax.jit(jmodel.make_bucket_train_step(
            HW, param_label_tree=labels))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        jmetrics = jax.tree.map(np.asarray, jmetrics)
        one["jax"] = {
            "pos_mask": jmetrics.pop("pos_mask"),
            "metrics": {k: float(v) for k, v in jmetrics.items()},
            "params": _in_port_layout(model, _to_np(jstate.params))}
        # the eval in one process
        eval_dir = os.path.join(root, "eval_1p")
        one["eval"] = inference(ecfg, emodel,
                                COCODataset(ann_file, img_dir, False),
                                output_folder=eval_dir)
        with open(os.path.join(eval_dir, "bbox.json")) as f:
            one["bbox"] = json.load(f)
    finally:
        _wait(procs)
        torch.set_num_threads(threads)
    ranks = []
    for rank in range(WORLD):
        with open(f"{out_path}.{rank}", "rb") as f:
            ranks.append(pickle.load(f))
    with open(os.path.join(job["eval_dir"], "bbox.json")) as f:
        two_bbox = json.load(f)
    return dict(one=one, ranks=ranks, two_bbox=two_bbox, job=job, cfg=cfg)


def _global_pos_mask(ranks):
    """The ranks' positive masks back in the global batch's image order
    (rank r held images r, r + WORLD, ...)."""
    local = [r["pos_mask"] for r in ranks]
    out = np.zeros((sum(m.shape[0] for m in local),) + local[0].shape[1:],
                   bool)
    for rank, m in enumerate(local):
        out[rank::WORLD] = m
    return out


def test_ranks_joined_with_gloo_and_gathered(runs):
    for rank, out in enumerate(runs["ranks"]):
        assert (out["rank"], out["world"], out["backend"], out["device"]) \
            == (rank, WORLD, "gloo", "cpu")
        assert out["ddp"]
        gathered = out["gathered"]
        assert [g["rank"] for g in gathered] == list(range(WORLD))
        assert [g["items"] for g in gathered] == [[0, 1, 2], [0, 1, 2, 3]]
        for r, g in enumerate(gathered):
            np.testing.assert_array_equal(g["array"], np.arange(r + 1))


def test_all_gather_pickled_in_one_process():
    assert not comm.is_initialized()
    obj = {"a": np.arange(3)}
    assert comm.all_gather_pickled(obj)[0] is obj
    assert (comm.get_world_size(), comm.get_rank()) == (1, 0)
    assert comm.is_main_process()
    comm.synchronize()  # a no-op
    t = torch.ones(2)
    assert comm.all_reduce_sum(t) is t
    assert comm.init_distributed("cpu") == torch.device("cpu")


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_ddp_step_matches_one_process(runs, reference):
    want = runs["one"][reference]
    ranks = runs["ranks"]
    mask = _global_pos_mask(ranks)
    np.testing.assert_array_equal(mask, want["pos_mask"])
    assert mask.sum() > 4
    for out in ranks:
        assert int(out["metrics"]["num_pos"]) == \
            int(want["metrics"]["num_pos"]) == int(mask.sum())
        assert set(out["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
    assert len(ranks[0]["params"]) > 100
    for name in ranks[0]["params"]:
        for out in ranks:
            np.testing.assert_allclose(out["params"][name],
                                       want["params"][name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    # the ranks hold one model
    for name, value in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][name], value)


def test_two_process_eval_matches_one_process(runs):
    one, two = runs["one"], runs["ranks"]
    assert two[1]["eval"] == {}
    results = two[0]["eval"]
    assert list(results) == list(one["eval"])
    for k, v in one["eval"].items():
        assert results[k] == v, (k, results[k], v)
    assert 0.3 < results["AP"] < 1.0
    key = lambda d: (d["image_id"], -d["score"], d["category_id"])  # noqa
    got, want = sorted(runs["two_bbox"], key=key), sorted(one["bbox"],
                                                          key=key)
    assert [(d["image_id"], d["category_id"]) for d in got] == \
        [(d["image_id"], d["category_id"]) for d in want]
    np.testing.assert_array_equal([d["bbox"] for d in got],
                                  [d["bbox"] for d in want])
    np.testing.assert_array_equal([d["score"] for d in got],
                                  [d["score"] for d in want])


def test_ddp_checkpoint_has_no_module_prefix(runs):
    ckpt_dir = runs["job"]["ckpt_dir"]
    assert sorted(os.listdir(ckpt_dir)) == ["last_checkpoint", "model_ddp"]
    data = torch.load(os.path.join(ckpt_dir, "model_ddp"),
                      weights_only=True)
    assert not any(k.startswith("module.") for k in data["model"])
    model = build_detection_model(runs["cfg"], device="cpu", seed=5)
    assert load_weights(model.module, os.path.join(ckpt_dir, "model_ddp")) \
        == {"iteration": 1}
    for name, p in model.module.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      runs["ranks"][0]["params"][name])


def test_assignment_tie_is_float_rounding():
    """Seed 4's batch, where the two packages' train steps differ by one
    positive anchor (image 2, anchor 3): given the port's combined loss
    and candidates, the JAX package's assignment gives the port's mask;
    the anchor's GT has two foreground candidates whose GMM scores (each
    package's, on the same values) are within 1e-5, so a one-ulp change
    of a candidate's loss can move the foreground maximum."""
    import paa_tpu.modeling.paa_loss as jpl
    from paa_tpu.ops.gmm import gmm_fit_predict as jax_gmm
    from paa_tpu_torch.modeling import paa_loss as pl
    from paa_tpu_torch.modeling.matcher import match_anchors
    from paa_tpu_torch.ops.gmm import gmm_fit_predict
    from paa_tpu_torch.ops.image_norm import maybe_device_normalize
    from paa_tpu_torch.structures.boxes import box_iou

    _, cfg = _cfgs()
    jmodel = jax_build(_cfgs()[0])
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), HW))["params"]
    model = build_detection_model(cfg, device="cpu")
    load_jax_params(model.module,
                    _seeded_params(shapes, np.random.RandomState(0)))
    b = {k: torch.from_numpy(v) for k, v in _global_batch(TIE_SEED).items()}
    x = maybe_device_normalize(b["images"], b["image_sizes"],
                               cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)
    with torch.no_grad():
        out = model.module(x.permute(0, 3, 1, 2).contiguous())
    anchors, counts = model.anchors_for(HW)
    lc = PAALossConfig.from_cfg(cfg)
    _, aux = paa_loss(out, b["gt_boxes"], b["gt_labels"], anchors, counts,
                      lc, return_aux=True)
    matched = match_anchors(box_iou(b["gt_boxes"], anchors[None]),
                            b["gt_labels"] > 0, lc.iou_threshold,
                            lc.iou_threshold)
    cl = aux["combined_loss"]
    cidx, cval = pl._select_candidates(cl, matched, aux["iou_labels"],
                                       counts, b["gt_boxes"].shape[1],
                                       lc.topk)
    want = jpl._paa_positive_mask(jnp.asarray(cl.numpy()),
                                  jnp.asarray(cidx.numpy()),
                                  jnp.asarray(cval.numpy()), lc.gmm_iters)
    np.testing.assert_array_equal(aux["pos_mask"].numpy(), np.asarray(want))

    g = int(matched[2, 3])
    cand = torch.where(cval[2, g], cl[2][cidx[2, g]],
                       torch.full((), pl.INF))
    values, order = torch.sort(cand, stable=True)
    valid = cval[2, g][order]
    comps, scores = gmm_fit_predict(values[None], valid[None],
                                    num_iters=lc.gmm_iters)
    jcomps, jscores = jax_gmm(jnp.asarray(values.numpy()[None]),
                              jnp.asarray(valid.numpy()[None]),
                              num_iters=lc.gmm_iters)
    assert comps[0].tolist()[:3] == np.asarray(jcomps)[0].tolist()[:3] \
        == [0, 0, 1]
    for s in (scores[0].numpy(), np.asarray(jscores)[0]):
        assert abs(s[0] - s[1]) < 1e-5

"""Serving or training throughput of a PAA config on the card, the dcnv2
family by default (port of tools/bench_dcnv2.py).

    python -m paa_tpu_torch.tools.bench_dcnv2 \\
        [--config-file configs/paa/paa_dcnv2_R_101_FPN_2x.yaml] \\
        [--batch 8] [--iters 10] [--hw 800,1344] [--train] [--device cpu]

The config's model in bfloat16 (MODEL.WEIGHT "", weights from seed 0).
Serving is timed as ``tools/bench.py`` times it (``bench.serve``:
forward, PAA post-processing with K1 and score voting, on seed-0
uniform(-128, 128) images, two warm-up calls, ``--iters`` calls back to
back). ``--train`` times the train step instead (forward, assignment,
losses, backward, SGD: ``make_bucket_train_step``) on seed-0
uniform(-128, 128) images with two fixed GTs per image (boxes [20, 30,
300, 400] and [350, 200, 700, 640], labels 5 and 17), as the JAX tool's:
its first call alone (``first_call_s``), then ``--iters`` steps.

The JAX tool's ``--dcn-mode`` chose a TPU lowering of DCN and has no
counterpart. The last line is the JAX tool's JSON (metric, value in
img/s, unit, batch, first_call_s) with the device's name and power
limit, the card's clocks at the start and end of the timed window and
the kernels' launches. Runs on the card unless ``--device cpu`` is
given; with no card it exits non-zero.
"""

import argparse
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# tools/bench_dcnv2.py:96-103: two GTs per image
TRAIN_GT_BOXES = [[20, 30, 300, 400], [350, 200, 700, 640]]
TRAIN_GT_LABELS = [5, 17]


def load_cfg(config_file):
    """The config file with MODEL.WEIGHT "" in bfloat16, frozen."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(config_file)
    cfg.MODEL.WEIGHT = ""
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    return cfg


def train_batch(batch, hw, device, seed=0):
    """The JAX tool's train batch on ``device``: uniform(-128, 128)
    float32 images from ``seed`` (normalized already, so the step does
    not normalize them) and the two fixed GTs of each image."""
    import torch

    rng = np.random.RandomState(seed)
    images = rng.uniform(-128, 128, (batch, *hw, 3)).astype(np.float32)
    out = {"images": torch.from_numpy(images),
           "gt_boxes": torch.tensor([TRAIN_GT_BOXES] * batch,
                                    dtype=torch.float32),
           "gt_labels": torch.tensor([TRAIN_GT_LABELS] * batch,
                                     dtype=torch.int32)}
    return {k: v.to(device) for k, v in out.items()}


def time_train_step(cfg, hw, batch, iters, device):
    """Times the train step of ``cfg``'s model (``timed_window``: its
    first call alone, then ``iters`` steps). Returns the timing, img/s on
    the host clock, the last step's loss and the kernels' launches."""
    from ..ops import launch_counts
    from .bench_common import timed_window
    from .profile_train_step import model_and_state

    model, state = model_and_state(cfg, device)
    step = model.make_bucket_train_step(hw)
    data = train_batch(batch, hw, device)
    metrics = {}

    def call():
        metrics.update(step(state, data))

    before = launch_counts()
    r = timed_window(call, iters, device, warmup=1)
    r["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    r["img_per_s"] = batch * iters / r["host_s"]
    r["loss"] = float(metrics["loss"])
    return r


def run(cfg, hw, batch, iters, device, train=False):
    """The JAX tool's measurement of ``cfg`` at ``hw`` on ``device``:
    serving (``bench.serve``) or, with ``train``, the train step.
    Returns the last line's dict without its metric name."""
    from ..modeling import build_detection_model
    from .bench import serve
    from .bench_common import card_identity

    if train:
        r = time_train_step(cfg, hw, batch, iters, device)
    else:
        r = serve(build_detection_model(cfg, device=device, seed=0), hw,
                  batch, iters, device)
    out = {"value": r["img_per_s"], "unit": "images/sec/chip",
           "batch": batch, "iters": iters,
           "first_call_s": r["first_call_s"],
           "ms_per_call": r["ms_per_call"], "clock": r["clock"],
           "host_s": r["host_s"], "device": card_identity(device),
           "clocks": r["clocks"], "launches": r["launches"]}
    if train:
        out["loss"] = r["loss"]
    else:
        out["work_per_image"] = r["work_per_image"]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch PAA serving / train-step throughput")
    parser.add_argument("--config-file", default=os.path.join(
        ROOT, "configs", "paa", "paa_dcnv2_R_101_FPN_2x.yaml"))
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--hw", default="800,1344")
    parser.add_argument("--train", action="store_true",
                        help="time the train step (fwd + assignment + "
                             "losses + bwd + SGD) instead of inference")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from .bench_common import device_or_exit

    device = device_or_exit(args.device, "bench_dcnv2")
    cfg = load_cfg(args.config_file)
    hw = tuple(int(x) for x in args.hw.split(","))
    r = run(cfg, hw, args.batch, args.iters, device, train=args.train)
    name = os.path.basename(args.config_file).replace(".yaml", "")
    what = ("train-step throughput", "fwd+assign+bwd+SGD") if args.train \
        else ("inference throughput", "incl. NMS+score-voting")
    print(json.dumps({
        "metric": f"{name} {what[0]} ({hw[0]}x{hw[1]}, "
                  f"{cfg.TPU.COMPUTE_DTYPE}, {what[1]})", **r}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

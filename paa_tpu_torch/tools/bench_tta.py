"""Test-time augmentation throughput on the card (port of
tools/bench_tta.py).

    python -m paa_tpu_torch.tools.bench_tta [--batch 8] [--batches 3] \\
        [--device cpu]

First the static bucket bound of the reference's X-152 TTA recipe
(configs/paa/paa_dcnv2_X_152_32x8d_FPN_2x.yaml: 12 scales and the
identity, each with its horizontal flip): each augmentation pads its
batch into the bucket (``_ceil32(min(scale, max_size))``,
``_ceil32(max_size)``) of ``engine/bbox_aug.py``, so a scale and its
flip share one, and 26 augmentations need 13 padded input shapes. In
the port a new shape is no compile: it is a new set of cuDNN algorithm
choices and a new anchor-cache entry.

Then the whole TEST.BBOX_AUG path (``TTAEngine.detect_batch``: per-aug
resize and flip on the host, forward and post-processing with K1 and
score voting on the device, the host's vote merge) of PAA-R50 in
bfloat16 with weights from seed 0 and the cls bias lifted around the
score threshold (``bench_common.lift_cls_bias``: at the seeded head's
focal prior no logit of a random image passes it, and the check below
would fail), scales (400, 1000) with MAX_SIZE
1667, H_FLIP, SCALE_H_FLIP, VOTE and soft-vote (6 augmentations), on
``--batch`` seed-0 random raw images alternating 480 x 640 and 426 x
640: the first pass (``first_pass_s``, the JAX tool's ``compile_s``),
the distinct padded shapes the batch reached (``input_shapes``, its
``compiled_programs``), then ``--batches`` passes (original img/s on the
host clock). Every image must get detections, else it raises.

The last line is the JAX tool's JSON (metric, value in img/s, unit,
augs) with those two in place of its compile keys, the device's name
and power limit, the card's clocks at the start and end of the timed
passes and the kernels' launches. Runs on the card unless ``--device
cpu`` is given; with no card it exits non-zero.
"""

import argparse
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
X152_CONFIG = os.path.join(ROOT, "configs", "paa",
                           "paa_dcnv2_X_152_32x8d_FPN_2x.yaml")
R50_CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
# the raw images' (h, w), in turns (tools/bench_tta.py:89-93)
RAW_HW = ((480, 640), (426, 640))


def x152_bucket_bound():
    """(augmentations, padded input shapes, the sorted shapes) of the
    X-152 config's TTA recipe."""
    from ..config import get_cfg
    from ..engine.bbox_aug import _ceil32, build_aug_list

    cfg = get_cfg()
    cfg.merge_from_file(X152_CONFIG)
    cfg.TEST.BBOX_AUG.ENABLED = True
    augs = build_aug_list(cfg)
    buckets = {(_ceil32(min(scale, mx)), _ceil32(mx))
               for scale, mx, _, _ in augs}
    return len(augs), len(buckets), sorted(buckets)


def tta_cfg():
    """PAA-R50 with the JAX tool's TTA recipe, bfloat16, frozen."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(R50_CONFIG)
    cfg.TEST.BBOX_AUG.ENABLED = True
    cfg.TEST.BBOX_AUG.H_FLIP = True
    cfg.TEST.BBOX_AUG.SCALES = (400, 1000)
    cfg.TEST.BBOX_AUG.MAX_SIZE = 1667
    cfg.TEST.BBOX_AUG.SCALE_H_FLIP = True
    cfg.TEST.BBOX_AUG.VOTE = True
    cfg.TEST.BBOX_AUG.MERGE_TYPE = "soft-vote"
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.freeze()
    return cfg


def build_engine(device):
    """The ``TTAEngine`` of PAA-R50 at ``tta_cfg`` on ``device``, weights
    from seed 0 and the cls bias lifted (``lift_cls_bias``)."""
    from ..engine.bbox_aug import TTAEngine
    from ..modeling import build_detection_model
    from .bench_common import lift_cls_bias

    cfg = tta_cfg()
    model = lift_cls_bias(build_detection_model(cfg, device=device, seed=0))
    return TTAEngine(cfg, model)


def raw_images(n, seed=0):
    """``n`` random uint8 images, RAW_HW's sizes in turns."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (*RAW_HW[i % 2], 3), np.uint8)
            for i in range(n)]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch TTA throughput")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--batches", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from ..engine.bbox_aug import build_aug_list
    from ..ops import launch_counts
    from .bench_common import card_identity, clocks, device_or_exit

    device = device_or_exit(args.device, "bench_tta")
    n_augs, n_buckets, buckets = x152_bucket_bound()
    print(f"X-152 TTA bound: {n_augs} augmentations -> {n_buckets} padded "
          f"input shapes (hflip reuses each scale's shape)")
    print(f"  buckets: {buckets}")

    engine = build_engine(device)
    model = engine.model
    augs = build_aug_list(engine.cfg)
    print(f"R-50 aug list ({len(augs)} augs): {augs}")
    raw = raw_images(args.batch)

    before = launch_counts()
    t0 = time.perf_counter()
    engine.detect_batch(raw)  # detections on the host: the pass is done
    first_pass_s = time.perf_counter() - t0
    shapes = len(model._anchors)  # one anchor-cache entry per input shape
    print(f"first pass: {first_pass_s:.1f} s, {shapes} padded input "
          f"shapes for {len(augs)} augs")

    start = clocks(device)
    t0 = time.perf_counter()
    for _ in range(args.batches):
        results = engine.detect_batch(raw)
    dt = time.perf_counter() - t0
    end = clocks(device)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    n_img = args.batches * len(raw)
    img_s = n_img / dt
    print(f"steady-state TTA: {img_s:.2f} original-img/s "
          f"({dt / n_img:.3f} s/img across {len(augs)} augs; "
          f"{img_s * len(augs):.1f} aug-forwards/s)")
    empty = [i for i, r in enumerate(results) if len(r[0]) == 0]
    if empty:
        raise RuntimeError(
            f"TTA merge returned no detection for images {empty}: "
            "random-noise inputs should still yield low-score boxes")
    print(json.dumps({
        "metric": "tta_r50_3scale_hflip_throughput",
        "value": img_s,
        "unit": "img/s",
        "first_pass_s": first_pass_s,
        "input_shapes": shapes,
        "augs": len(augs),
        "batch": args.batch,
        "batches": args.batches,
        "x152_bound": {"augs": n_augs, "input_shapes": n_buckets},
        "device": card_identity(device),
        "clocks": {"start": start, "end": end},
        "launches": launches,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

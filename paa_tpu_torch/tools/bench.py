"""PAA-R50 serving throughput on the card (port of bench.py).

    python -m paa_tpu_torch.tools.bench [--batch 48] [--iters 20] \\
        [--cls-bias-lift] [--device cpu]

Builds the flagship model (bench.py's overrides of the defaults: PAA,
R-50-FPN-RETINANET with P6 from P5, 256 FPN channels, score voting,
bfloat16) with weights from seed 0, puts seed-0 uniform(-128, 128)
float32 images of 800 x 1344 (content 800 x 1333) on the device, and
times the model's forward plus PAA post-processing (``detect``: K3 in
the towers, K1's NMS, score voting) with ``scores.sum()`` as the
summary: two warm-up calls, then ``--iters`` calls queued back to back
and one synchronize (``bench_common.timed_window``). img/s is on the
host clock around that window, as bench.py's; the CUDA-event ms per
call stands beside it.

With the seeded head the cls logits sit at the focal prior (logit
-4.6) with a spread of about 0.3, so few of an image's ~1.8M (location,
class) logits pass the 0.05 threshold (logit -2.944) and K1 and score
voting run on nearly empty rows. ``--cls-bias-lift`` draws the cls bias
from seed 1 in [-3.5, -2.5] (``bench_common.lift_cls_bias``), as
chip_smoke.py's serving phases do, so that K1 sorts and sweeps real
candidates. A line before the last gives the mean count per image of
logits past the threshold, of NMS candidates and of detections.

The last line is bench.py's JSON (metric, value in img/s, unit,
vs_baseline against the same 12.5 img/s proxy: the reference PAA-R50 at
batch 1 on a V100, documented, not measured) with batch,
first_call_s, the work counts, the device's name and power limit, the
card's clocks at the start and end of the timed window, and the
kernels' launches over the warm-up and the window. Runs on the card
unless ``--device cpu`` is given; with no card it exits non-zero.
"""

import argparse
import json
import math

import numpy as np

# the reference PAA-R50 at batch 1 on a V100, 0.08 s/img (bench.py:31)
BASELINE_IMG_PER_S = 12.5
HW, SIZE = (800, 1344), (800.0, 1333.0)
# bench.py:46-53
OVERRIDES = ["MODEL.PAA_ON", True, "MODEL.RPN_ONLY", True,
             "MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET",
             "MODEL.RETINANET.USE_C5", False,
             "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 256,
             "MODEL.PAA.INFERENCE_SCORE_VOTING", True,
             "TPU.COMPUTE_DTYPE", "bfloat16"]


def bench_cfg():
    """The defaults with bench.py's overrides, frozen."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list(list(OVERRIDES))
    cfg.freeze()
    return cfg


def serving_inputs(batch, hw, device, seed=0):
    """bench.py's inputs on ``device``: uniform(-128, 128) float32 images
    from ``seed`` (drawn as (B, H, W, 3), laid out NCHW) and the (B, 2)
    content sizes (800, 1333)."""
    import torch

    rng = np.random.RandomState(seed)
    images = rng.uniform(-128, 128, (batch, *hw, 3)).astype(np.float32)
    images = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    sizes = torch.tensor([SIZE] * batch, dtype=torch.float32)
    return images.to(device), sizes.to(device)


def work_counts(model, images, sizes):
    """Mean counts per image of (location, class) logits past the score
    threshold, of NMS candidates (after each level's top-n) and of
    detections, for one call."""
    import torch

    from ..modeling.paa_inference import paa_candidates

    pp = model.postprocess_config()
    bsz = images.shape[0]
    with torch.inference_mode():
        out = model.module(images)
        anchors, counts = model.anchors_for(images.shape[2:])
        th = math.log(pp.pre_nms_thresh) - math.log1p(-pp.pre_nms_thresh)
        above = (out["cls_logits"].float() > th).sum()
        valid = paa_candidates(out, sizes, anchors, counts, pp)[3].sum()
        dets = model.postprocess(out, sizes, anchors, counts)["valid"].sum()
    return {"above_threshold": float(above) / bsz,
            "nms_candidates": float(valid) / bsz,
            "detections": float(dets) / bsz}


def serve(model, hw, batch, iters, device):
    """Times ``model.detect`` on bench.py's inputs (``timed_window``, two
    warm-up calls) and counts one call's work. Returns the timing, the
    work counts, img/s on the host clock and the kernels' launches over
    the warm-up and the window."""
    import torch

    from ..ops import launch_counts
    from .bench_common import timed_window

    images, sizes = serving_inputs(batch, hw, device)
    model.module.eval()

    @torch.inference_mode()
    def call():
        return model.detect(images, sizes)["scores"].sum()

    before = launch_counts()
    r = timed_window(call, iters, device, warmup=2)
    r["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    r["img_per_s"] = batch * iters / r["host_s"]
    r["work_per_image"] = work_counts(model, images, sizes)
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch PAA-R50 serving throughput")
    parser.add_argument("--batch", type=int, default=48)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--cls-bias-lift", action="store_true",
                        help="draw the cls bias around the score "
                             "threshold so that NMS sees candidates")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from ..modeling import build_detection_model
    from .bench_common import card_identity, device_or_exit, lift_cls_bias

    device = device_or_exit(args.device, "bench")
    cfg = bench_cfg()
    model = build_detection_model(cfg, device=device, seed=0)
    if args.cls_bias_lift:
        lift_cls_bias(model)
    r = serve(model, HW, args.batch, args.iters, device)
    print(json.dumps({"work_per_image": r["work_per_image"],
                      "cls_bias_lift": args.cls_bias_lift}))
    value = r["img_per_s"]
    print(json.dumps({
        "metric": "PAA_R_50_FPN_1x inference throughput "
                  f"({HW[0]}x{HW[1]}, {cfg.TPU.COMPUTE_DTYPE}, "
                  "incl. NMS+score-voting"
                  + (", cls-bias lift)" if args.cls_bias_lift else ")"),
        "value": value,
        "unit": "images/sec/chip",
        "vs_baseline": value / BASELINE_IMG_PER_S,
        "batch": args.batch,
        "iters": args.iters,
        "first_call_s": r["first_call_s"],
        "ms_per_call": r["ms_per_call"],
        "clock": r["clock"],
        "host_s": r["host_s"],
        "cls_bias_lift": args.cls_bias_lift,
        "work_per_image": r["work_per_image"],
        "device": card_identity(device),
        "clocks": r["clocks"],
        "launches": r["launches"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

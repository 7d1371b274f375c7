"""The overfit gate of the port (port of tools/quick_overfit.py; the
reference's quick_schedules + check_expected_results regression,
configs/quick_schedules/*, coco_eval.py:403).

    python -m paa_tpu_torch.tools.quick_overfit [--iters 1500] \\
        [--workdir DIR] [--assert] [--device cpu]

Trains PAA-R50 (128 FPN channels, 2 tower convs, 3 classes, nothing
frozen) on 8 synthetic images of class-coloured rectangles through the
real pipeline: ``COCODataset``, the bucketed loader, ``do_train``, then
``inference`` with its COCO evaluation of the same images. With
``--assert`` it checks tests/test_overfit.py's gate: the first loss
above 1.5, the loss of the last 20 iterations below
``--loss-threshold``, AP50 at least ``--ap50-threshold`` and AP at
least 0.85 (the JAX tool's CLI checks the middle two). The images are
binary PPM bytes under ``img{i}.jpg`` names (read by content,
data/coco.py), so no cv2 is needed; the JAX tool's draws make the same
arrays, which it writes as JPEG. Runs on the card unless ``--device
cpu`` is given, in float32 (TPU.COMPUTE_DTYPE's default).
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np


def make_dataset(root, n_images=8, seed=0):
    """COCO-format dataset of solid class-coloured rectangles (class 1
    red-ish, class 2 green-ish) on dark noise, 96x64 and 64x96 images in
    turns: the JAX tool's draws, in its order. Returns (ann_file,
    img_dir)."""
    from ..data.coco import write_ppm

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        w, h = (96, 64) if i % 2 == 0 else (64, 96)
        arr = rng.randint(0, 40, (h, w, 3), dtype=np.uint8)
        for b in range(1 + (i % 2)):
            cls = 1 + ((i + b) % 2)
            bw = int(rng.randint(20, 34))
            bh = int(rng.randint(16, 28))
            x = int(rng.randint(2, w - bw - 2))
            y = int(rng.randint(2, h - bh - 2))
            arr[y:y + bh, x:x + bw] = (
                (40, 40, 220) if cls == 1 else (40, 220, 40))  # BGR
            annotations.append(dict(
                id=ann_id, image_id=i + 1, bbox=[x, y, bw, bh],
                area=bw * bh, category_id=cls, iscrowd=0,
            ))
            ann_id += 1
        name = f"img{i}.jpg"
        write_ppm(os.path.join(img_dir, name), arr)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = os.path.join(root, "instances.json")
    with open(ann_file, "w") as f:
        json.dump(dict(
            images=images, annotations=annotations,
            categories=[dict(id=1, name="red"), dict(id=2, name="green")],
        ), f)
    return ann_file, img_dir


def overfit_cfg(output_dir, max_iter):
    """The gate's config: every key the JAX tool sets, on the port's
    defaults."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.MODEL.PAA_ON = True
    cfg.MODEL.RPN_ONLY = True
    cfg.MODEL.BACKBONE.CONV_BODY = "R-50-FPN-RETINANET"
    cfg.MODEL.RETINANET.USE_C5 = False
    cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 128
    cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 0  # everything learns
    cfg.MODEL.PAA.NUM_CLASSES = 3
    cfg.MODEL.PAA.NUM_CONVS = 2
    cfg.MODEL.PAA.INFERENCE_SCORE_VOTING = True
    cfg.INPUT.MIN_SIZE_TRAIN = (64,)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 96
    cfg.TPU.TRAIN_BUCKETS = ((64, 96), (96, 64))
    cfg.TPU.TEST_BUCKETS = ((64, 96), (96, 64))
    cfg.TPU.MAX_GT = 8
    cfg.TPU.GMM_ITERS = 8
    cfg.SOLVER.IMS_PER_BATCH = 4
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 50
    cfg.SOLVER.STEPS = (int(max_iter * 0.7), int(max_iter * 0.9))
    cfg.SOLVER.CHECKPOINT_PERIOD = 10_000_000  # no mid-run checkpoints
    cfg.TEST.IMS_PER_BATCH = 4
    cfg.OUTPUT_DIR = output_dir
    return cfg


def run(iters, workdir, device=None, seed=0):
    """Train ``iters`` iterations on the synthetic set under ``workdir``
    and evaluate on it; returns first_loss, final_loss (the mean of the
    last 20 iterations' losses), ap and ap50, the seconds of training
    and of the evaluation on the host clock (each ends in a read of its
    results on the host), and the kernels' launches in each. ``device``:
    None for the card (raises without one), or e.g. "cpu"."""
    from ..data.coco import COCODataset
    from ..data.loader import make_data_loader
    from ..engine import TrainState, do_train
    from ..engine.inference import inference
    from ..modeling import build_detection_model
    from ..ops import launch_counts
    from ..solver import make_optimizer

    def launched_since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

    ann_file, img_dir = make_dataset(os.path.join(workdir, "data"),
                                     seed=seed)
    out_dir = os.path.join(workdir, "out")
    os.makedirs(out_dir, exist_ok=True)
    cfg = overfit_cfg(out_dir, iters)
    cfg.freeze()

    model = build_detection_model(cfg, device=device, seed=seed)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    losses = []
    before, t0 = launch_counts(), time.perf_counter()
    do_train(cfg, model, state,
             make_data_loader(cfg, COCODataset(ann_file, img_dir),
                              is_train=True),
             metric_hook=lambda step, m: losses.append(m["loss"]))
    train_s, train_launches = time.perf_counter() - t0, launched_since(
        before)

    eval_dataset = COCODataset(ann_file, img_dir,
                               remove_images_without_annotations=False)
    before, t0 = launch_counts(), time.perf_counter()
    results = inference(cfg, model, eval_dataset,
                        output_folder=os.path.join(out_dir, "inference"))
    return dict(
        first_loss=losses[0] if losses else float("nan"),
        final_loss=float(np.mean(losses[-20:])) if losses else float("nan"),
        ap=float(results["AP"]), ap50=float(results["AP50"]),
        train_s=train_s, eval_s=time.perf_counter() - t0,
        train_launches=train_launches, eval_launches=launched_since(before))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch overfit gate")
    # 1500 iterations at BASE_LR 0.02: the JAX package reached loss
    # ~0.16, AP50 1.0, AP 0.96 (tests/test_overfit.py)
    parser.add_argument("--iters", type=int, default=1500)
    parser.add_argument(
        "--workdir",
        default=os.path.join(tempfile.gettempdir(), "paa_torch_overfit"))
    parser.add_argument("--assert", dest="do_assert", action="store_true")
    parser.add_argument("--loss-threshold", type=float, default=0.35)
    parser.add_argument("--ap50-threshold", type=float, default=0.95)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    r = run(args.iters, args.workdir, device=args.device)
    print(json.dumps(r))
    if args.do_assert:
        failed = [what for what, ok in (
            ("first loss above 1.5", r["first_loss"] > 1.5),
            (f"final loss below {args.loss_threshold}",
             r["final_loss"] < args.loss_threshold),
            (f"AP50 at least {args.ap50_threshold}",
             r["ap50"] >= args.ap50_threshold),
            ("AP at least 0.85", r["ap"] >= 0.85)) if not ok]
        if failed:
            raise SystemExit(f"overfit gate failed ({', '.join(failed)}): "
                             f"{r}")
        print("OVERFIT GATE PASSED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

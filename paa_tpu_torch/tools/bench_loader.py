"""Host input-pipeline throughput (port of tools/bench_loader.py).

    python -m paa_tpu_torch.tools.bench_loader [--images 64] \\
        [--batches 12] [--batch-size 16] [--threads 1,2,4,8] [--root DIR] \\
        [--card-eval-img-s R --card-train-img-s R] [--device cpu]

Writes a JPEG dataset at COCO val2014's usual sizes with cv2 once (the
JAX tool's draws and annotations; cached under ``--root``, by default a
directory of the port's own in the temp dir), then measures on this
host:

- per stage, one thread, ms an image: ``decode_ms`` (cv2.imdecode),
  ``resize_ms`` (shortest side 800, longest at most 1333, with
  ``data/transforms.py``'s exact cv2-free resize), ``flip_ms`` and
  ``pad_assemble_ms`` (``make_batch`` into 800 x 1344 / 1344 x 800
  uint8 buckets, 8 images a batch). The port normalizes on the device,
  so the JAX tool's host ``normalize_ms`` and ``fused_norm_pad_ms``
  have no counterpart here, and ``pad_assemble_ms`` is the uint8 copy
  that ships (the JAX tool's is its pre-fusion float32 copy);
- ``make_data_loader``'s img/s for training and evaluation at each
  ``--threads`` (DATALOADER.NUM_WORKERS), ``--batches`` batches of
  ``--batch-size`` after one warm-up batch. A training batch forms
  within one bucket (800 x 1344 or 1344 x 800), so the tool exits with
  an error before timing when no bucket gets ``--batch-size`` of the
  ``--images``.

The host cores needed to sustain the card's rates are printed only
when ``--card-eval-img-s`` and ``--card-train-img-s`` give them (take
them from ``tools/bench.py`` and ``tools/bench_dcnv2.py --train`` on
the card). The last line is the JAX tool's JSON (stages_ms, per_img_ms,
img_per_s_per_core, loader, host_cores, and cores_for_eval /
cores_for_train with the rates) with metric, value (img/s a core of
the shipped host path) and unit, and the device's name and power
limit. Needs cv2 (JPEG). Runs with the card unless ``--device cpu`` is
given; with no card it exits non-zero.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
R50_CONFIG = os.path.join(ROOT, "configs", "paa", "paa_R_50_FPN_1x.yaml")
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(),
                            "paa_tpu_torch_loader_bench")
# typical COCO val2014 sizes (w, h): most are 640-capped
COCO_SIZES = [(640, 480), (640, 427), (500, 375), (640, 426),
              (481, 640), (640, 478), (612, 612), (640, 425)]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "bench_loader writes and decodes JPEG with the cv2 package, "
            "which this Python does not have") from e
    return cv2


def synth_dataset(root, n_images, seed=0):
    """JPEG images with low-frequency content (random noise JPEGs are
    atypically slow to decode) and a COCO annotation json, the JAX
    tool's draws. Returns (ann_path, img_dir); an existing json is
    reused."""
    cv2 = _cv2()
    os.makedirs(root, exist_ok=True)
    ann_path = os.path.join(root, f"instances_{n_images}.json")
    img_dir = os.path.join(root, "images")
    if os.path.exists(ann_path):
        return ann_path, img_dir
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    ann_id = 1
    for i in range(n_images):
        w, h = COCO_SIZES[i % len(COCO_SIZES)]
        low = rng.randint(0, 255, (h // 16, w // 16, 3), dtype=np.uint8)
        img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(
            img.astype(np.int16) + rng.randint(-8, 8, img.shape), 0, 255
        ).astype(np.uint8)
        name = f"img{i:05d}.jpg"
        cv2.imwrite(os.path.join(img_dir, name), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for _ in range(rng.randint(1, 8)):
            x = float(rng.uniform(0, w - 40))
            y = float(rng.uniform(0, h - 40))
            bw = float(rng.uniform(20, w - x))
            bh = float(rng.uniform(20, h - y))
            annotations.append(dict(
                id=ann_id, image_id=i + 1, bbox=[x, y, bw, bh],
                area=bw * bh, category_id=int(rng.randint(1, 81)),
                iscrowd=0,
            ))
            ann_id += 1
    categories = [dict(id=c, name=f"c{c}") for c in range(1, 81)]
    with open(ann_path, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    return ann_path, img_dir


def bench_stages(dataset, reps=24):
    """One thread's ms an image of each stage of the shipped host path,
    averaged over the dataset's first ``reps`` images."""
    cv2 = _cv2()
    from ..data.loader import make_batch
    from ..data.transforms import hflip_image_and_boxes, resize_image_and_boxes

    paths = [dataset.image_path(i) for i in range(min(reps, len(dataset)))]
    raw = []
    for p in paths:
        with open(p, "rb") as f:
            raw.append(f.read())

    t0 = time.perf_counter()
    decoded = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
               for b in raw]
    t_decode = (time.perf_counter() - t0) / len(raw)

    boxes = np.asarray([[10.0, 10.0, 100.0, 100.0]] * 4, np.float32)
    t0 = time.perf_counter()
    resized = [resize_image_and_boxes(im, boxes, 800, 1333)[0]
               for im in decoded]
    t_resize = (time.perf_counter() - t0) / len(raw)

    t0 = time.perf_counter()
    flipped = [hflip_image_and_boxes(im, boxes)[0] for im in resized]
    t_flip = (time.perf_counter() - t0) / len(raw)

    samples = [dict(image=im, boxes=boxes, labels=np.ones((4,), np.int64),
                    image_id=1, orig_size=im.shape[:2]) for im in flipped]
    land = [s for s in samples if s["image"].shape[1] >= s["image"].shape[0]]
    port = [s for s in samples if s["image"].shape[1] < s["image"].shape[0]]
    t0 = time.perf_counter()
    n = 0
    for group, bucket in ((land, (800, 1344)), (port, (1344, 800))):
        for i in range(0, len(group) - 7, 8):
            make_batch(group[i:i + 8], bucket, 100, device_normalize=True)
            n += 8
    t_pad = (time.perf_counter() - t0) / max(n, 1)
    return dict(decode_ms=t_decode * 1e3, resize_ms=t_resize * 1e3,
                flip_ms=t_flip * 1e3, pad_assemble_ms=t_pad * 1e3)


def check_train_batch_fills(cfg, dataset):
    """Raises SystemExit, naming both numbers, when no training bucket
    gets SOLVER.IMS_PER_BATCH images of ``dataset``: a training batch
    forms within one bucket, and the train loader would wait forever."""
    from ..data.loader import make_data_loader

    bsz = cfg.SOLVER.IMS_PER_BATCH
    most = max(make_data_loader(cfg, dataset).bucket_counts().values())
    if most < bsz:
        raise SystemExit(
            f"bench_loader: a training batch of {bsz} forms within one "
            f"bucket, and the largest bucket gets {most} of the "
            f"{len(dataset)} images; pass a --batch-size of at most "
            f"{most}, or more --images")


def bench_loader(cfg, dataset, is_train, threads, n_batches):
    """img/s of ``make_data_loader`` at ``threads`` over ``n_batches``
    batches after a warm-up one (an eval loader restarts at its end)."""
    from ..data.loader import make_data_loader

    cfg = cfg.clone()
    cfg.defrost()
    cfg.DATALOADER.NUM_WORKERS = threads
    loader = make_data_loader(cfg, dataset, is_train=is_train)
    it = iter(loader)
    next(it)  # warm-up: thread pool spin-up and the first prefetch
    t0 = time.perf_counter()
    done = 0
    bsz = cfg.SOLVER.IMS_PER_BATCH if is_train else cfg.TEST.IMS_PER_BATCH
    while done < n_batches:
        try:
            next(it)
            done += 1
        except StopIteration:
            it = iter(loader)
    dt = time.perf_counter() - t0
    return done * bsz / dt if dt > 0 else float("inf")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch host input-pipeline throughput")
    parser.add_argument("--images", type=int, default=64)
    parser.add_argument("--batches", type=int, default=12)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--threads", default="1,2,4,8")
    parser.add_argument("--root", default=DEFAULT_ROOT)
    parser.add_argument("--card-eval-img-s", type=float, default=None,
                        help="the card's serving img/s (tools/bench.py)")
    parser.add_argument("--card-train-img-s", type=float, default=None,
                        help="the card's training img/s "
                             "(tools/bench_dcnv2.py --train)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)

    from ..config import get_cfg
    from ..data.coco import COCODataset
    from .bench_common import card_identity, device_or_exit

    device = device_or_exit(args.device, "bench_loader")
    ann, img_dir = synth_dataset(args.root, args.images)
    dataset = COCODataset(ann, img_dir,
                          remove_images_without_annotations=False)

    cfg = get_cfg()
    cfg.merge_from_file(R50_CONFIG)
    cfg.SOLVER.IMS_PER_BATCH = args.batch_size
    cfg.TEST.IMS_PER_BATCH = args.batch_size
    cfg.SOLVER.MAX_ITER = 10 ** 9
    check_train_batch_fills(cfg, dataset)

    stages = bench_stages(dataset)
    per_img_ms = sum(stages.values())
    print("per-stage single-thread cost (ms/img, 800x1333 target):")
    for k, v in stages.items():
        print(f"  {k:>18}: {v:7.2f}")
    print(f"  {'TOTAL (shipped)':>18}: {per_img_ms:7.2f}  "
          f"(= {1e3 / per_img_ms:.1f} img/s/core)")

    results = {"metric": "host input pipeline throughput (JPEG decode, "
                         "resize to 800x1333, flip, uint8 pad), one core",
               "value": 1e3 / per_img_ms, "unit": "images/sec/core",
               "stages_ms": stages, "per_img_ms": per_img_ms,
               "img_per_s_per_core": 1e3 / per_img_ms, "loader": {}}
    for t in [int(x) for x in args.threads.split(",")]:
        tr = bench_loader(cfg, dataset, True, t, args.batches)
        ev = bench_loader(cfg, dataset, False, t, args.batches)
        results["loader"][t] = dict(train=tr, eval=ev)
        print(f"loader threads={t:2d}: train {tr:7.1f} img/s | "
              f"eval {ev:7.1f} img/s")

    ncores = os.cpu_count()
    results["host_cores"] = ncores
    if args.card_eval_img_s and args.card_train_img_s:
        need_eval = args.card_eval_img_s / results["img_per_s_per_core"]
        need_train = args.card_train_img_s / results["img_per_s_per_core"]
        print(f"host cores: {ncores}; cores needed to sustain the card's "
              f"rates: eval ~{need_eval:.1f}, train ~{need_train:.1f}")
        results.update(cores_for_eval=need_eval, cores_for_train=need_train,
                       card_eval_img_s=args.card_eval_img_s,
                       card_train_img_s=args.card_train_img_s)
    results["device"] = card_identity(device)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

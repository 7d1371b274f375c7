"""Synthetic COCO-format datasets for dry runs without COCO.

``synth_coco(root, n_images)`` writes ``n_images`` binary PPM images
(read without cv2, data/coco.py) at COCO's common sizes, with
low-frequency content and a few filled boxes, and an instances json
with COCO's 80 sparse category ids (1-90 with gaps) and 3-12 boxes per
image. Everything comes from ``seed``. tools/synth_catalog.py serves
such datasets through ``PATHS_CATALOG``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .coco import write_ppm

# COCO's 80 json category ids: 1..90 without the 10 unused ones
COCO_CATEGORY_IDS = tuple(
    i for i in range(1, 91)
    if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
# (width, height) of common COCO images, landscape and portrait
COCO_SIZES = ((640, 480), (480, 640), (427, 640), (500, 375),
              (640, 427), (375, 500), (612, 612), (640, 360))


def synth_image(rng, w, h, boxes):
    """BGR uint8 (h, w, 3): three random low-frequency waves per channel,
    with each xywh box filled in a colour of its own."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(3):
            fx, fy = rng.uniform(-3, 3, 2) / max(w, h)
            img[:, :, c] += rng.uniform(15, 40) * np.sin(
                2 * np.pi * (fx * xs + fy * ys) + rng.uniform(0, 2 * np.pi))
    for x, y, bw, bh in boxes:
        img[int(y):int(y + bh), int(x):int(x + bw)] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_coco(root, n_images, seed=0, sizes=COCO_SIZES):
    """Write the dataset under ``root`` (images in ``root/images``) once;
    returns (ann_file, img_dir)."""
    img_dir = os.path.join(root, "images")
    ann_file = os.path.join(root, "instances.json")
    if os.path.exists(ann_file):
        return ann_file, img_dir
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n_images):
        w, h = sizes[i % len(sizes)]
        n = rng.randint(3, 13)
        side = np.exp(rng.uniform(np.log(12), np.log(0.6 * min(w, h)), n))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        bw = np.minimum(side * np.sqrt(aspect), w - 2)
        bh = np.minimum(side / np.sqrt(aspect), h - 2)
        x = rng.uniform(0, w - 1 - bw)
        y = rng.uniform(0, h - 1 - bh)
        boxes = np.round(np.stack([x, y, bw, bh], 1), 2)
        name = f"{i:06d}.ppm"
        # each file appears whole: ranks of a process group may write the
        # same dataset at once and read it as soon as their own is done
        path = os.path.join(img_dir, name)
        write_ppm(f"{path}.{os.getpid()}.tmp", synth_image(rng, w, h, boxes))
        os.replace(f"{path}.{os.getpid()}.tmp", path)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
        for b, c in zip(boxes.tolist(),
                        rng.choice(COCO_CATEGORY_IDS, n).tolist()):
            annotations.append(dict(
                id=len(annotations) + 1, image_id=i + 1, bbox=b,
                area=b[2] * b[3], category_id=int(c), iscrowd=0))
    categories = [dict(id=c, name=f"category_{c}")
                  for c in COCO_CATEGORY_IDS]
    tmp = f"{ann_file}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    os.replace(tmp, ann_file)
    return ann_file, img_dir

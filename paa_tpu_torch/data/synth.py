"""Synthetic COCO-format datasets for dry runs without COCO.

``synth_coco(root, n_images)`` writes ``n_images`` binary PPM images
(read without cv2, data/coco.py) at COCO's common sizes, with
low-frequency content and a few filled boxes, and an instances json
with COCO's 80 sparse category ids (1-90 with gaps) and 3-12 boxes per
image, each with a polygon (an octagon with the box's corners cut at a
quarter of its sides, for Mask R-CNN) and the polygon's area. With
``person_keypoints`` every box is a "person" (category 1, the only one)
with 17 keypoints inside it (a quarter of them unlabelled: v = 0 at
(0, 0), as COCO writes them) and their ``num_keypoints``, for Keypoint
R-CNN; images and boxes are the same as without. Everything comes from
``seed``. tools/synth_catalog.py serves such datasets through
``PATHS_CATALOG``.

``synth_voc(root, n_images)`` writes a Pascal VOC tree (Annotations/
*.xml, JPEGImages/, ImageSets/Main/{train,val,trainval,test}.txt) of
the same kind of images at VOC's common sizes, binary PPM bytes under
VOC's ``.jpg`` names (read by content, data/coco.py), with 1-5 objects
per image among the 20 classes, some of them difficult, and one image
whose every object is difficult. ``voc_ground_truth`` rewrites such a
tree's annotations from a model's detections, so that an evaluation of
seeded weights scores far from 0.
"""

from __future__ import annotations

import json
import os
from xml.sax.saxutils import escape

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


def box_octagon(x, y, w, h):
    """The COCO polygon of the octagon inside the xywh box whose corners
    are cut at a quarter of the box's sides, and its area."""
    xs = (x + 0.25 * w, x + 0.75 * w, x + w, x + w,
          x + 0.75 * w, x + 0.25 * w, x, x)
    ys = (y, y, y + 0.25 * h, y + 0.75 * h, y + h, y + h, y + 0.75 * h,
          y + 0.25 * h)
    poly = [round(float(v), 2) for xy in zip(xs, ys) for v in xy]
    return poly, 0.875 * w * h


def box_keypoints(rng, x, y, w, h, k=17):
    """COCO keypoints of one person in the xywh box: k points drawn
    inside it, each labelled visible (2) or occluded (1), a quarter
    unlabelled (0, at (0, 0)); the flat [x, y, v] * k list and the count
    labelled."""
    kps = np.zeros((k, 3))
    kps[:, 0] = np.round(x + rng.uniform(0, 1, k) * w, 2)
    kps[:, 1] = np.round(y + rng.uniform(0, 1, k) * h, 2)
    kps[:, 2] = rng.choice([1, 2], k)
    kps[rng.uniform(0, 1, k) < 0.25] = 0
    return kps.reshape(-1).tolist(), int((kps[:, 2] > 0).sum())


def _complete(ann_file, person_keypoints):
    """Whether an earlier dataset at ``ann_file`` has the polygons (and
    the keypoints asked for)."""
    with open(ann_file) as f:
        annotations = json.load(f)["annotations"]
    return all("segmentation" in a and ("keypoints" in a
                                        or not person_keypoints)
               for a in annotations)


def synth_coco(root, n_images, seed=0, sizes=COCO_SIZES,
               person_keypoints=False):
    """Write the dataset under ``root`` (images in ``root/images``) once
    (again when an earlier one there lacks the polygons or the keypoints
    asked for); returns (ann_file, img_dir)."""
    img_dir = os.path.join(root, "images")
    ann_file = os.path.join(root, "instances.json")
    if os.path.exists(ann_file) and _complete(ann_file, person_keypoints):
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
            poly, area = box_octagon(*b)
            ann = dict(id=len(annotations) + 1, image_id=i + 1, bbox=b,
                       area=area, segmentation=[poly], category_id=int(c),
                       iscrowd=0)
            if person_keypoints:
                # their own stream: the images and boxes stay the same
                kps, labelled = box_keypoints(
                    np.random.RandomState(seed * 100_003 + ann["id"]), *b)
                ann.update(category_id=1, keypoints=kps,
                           num_keypoints=labelled)
            annotations.append(ann)
    categories = ([dict(id=1, name="person")] if person_keypoints else
                  [dict(id=c, name=f"category_{c}")
                   for c in COCO_CATEGORY_IDS])
    tmp = f"{ann_file}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=categories), f)
    os.replace(tmp, ann_file)
    return ann_file, img_dir


VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")
# (width, height) of common VOC images
VOC_SIZES = ((500, 375), (375, 500), (500, 333), (500, 400), (333, 500),
             (500, 366))


def _voc_xml(name, w, h, objects):
    """A VOC annotation: ``objects`` as (class name, difficult, (xmin,
    ymin, xmax, ymax)) in VOC's 1-based pixel coordinates."""
    parts = [f"<annotation><folder>VOC2007</folder>"
             f"<filename>{escape(name)}.jpg</filename><size>"
             f"<width>{w}</width><height>{h}</height><depth>3</depth>"
             f"</size><segmented>0</segmented>"]
    for cls, difficult, box in objects:
        coords = "".join(f"<{k}>{v}</{k}>" for k, v in zip(
            ("xmin", "ymin", "xmax", "ymax"), box))
        parts.append(f"<object><name>{cls}</name><pose>Unspecified</pose>"
                     f"<truncated>0</truncated>"
                     f"<difficult>{int(difficult)}</difficult>"
                     f"<bndbox>{coords}</bndbox></object>")
    parts.append("</annotation>")
    return "".join(parts)


def synth_voc(root, n_images, seed=0, sizes=VOC_SIZES, all_difficult=1):
    """Write the VOC tree under ``root`` once: ``n_images`` images, the
    ``test`` split all of them, ``train`` the first half, ``val`` the
    rest and ``trainval`` both; image ``all_difficult`` has only
    difficult objects. Returns ``root``."""
    if os.path.exists(os.path.join(root, "ImageSets", "Main", "test.txt")):
        return root
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets",
                                                          "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.RandomState(seed)
    ids = []
    for i in range(n_images):
        w, h = sizes[i % len(sizes)]
        n = rng.randint(1, 6)
        side = np.exp(rng.uniform(np.log(24), np.log(0.7 * min(w, h)), n))
        aspect = np.exp(rng.uniform(np.log(0.5), np.log(2.0), n))
        bw = np.minimum(side * np.sqrt(aspect), w - 4).astype(int)
        bh = np.minimum(side / np.sqrt(aspect), h - 4).astype(int)
        x = (rng.uniform(0, 1, n) * (w - 1 - bw)).astype(int) + 1
        y = (rng.uniform(0, 1, n) * (h - 1 - bh)).astype(int) + 1
        classes = rng.randint(0, len(VOC_CLASSES), n)
        difficult = rng.uniform(0, 1, n) < 0.2
        if i == all_difficult:
            difficult[:] = True
        name = f"{i + 1:06d}"
        ids.append(name)
        xywh = np.stack([x - 1, y - 1, bw, bh], 1).astype(np.float64)
        path = os.path.join(root, "JPEGImages", f"{name}.jpg")
        # each file appears whole (ranks may write the same tree at once)
        write_ppm(f"{path}.{os.getpid()}.tmp", synth_image(rng, w, h, xywh))
        os.replace(f"{path}.{os.getpid()}.tmp", path)
        objects = [(VOC_CLASSES[c], d, (int(x0), int(y0), int(x0 + bw0),
                                       int(y0 + bh0)))
                   for c, d, x0, y0, bw0, bh0 in zip(classes, difficult, x,
                                                     y, bw, bh)]
        with open(os.path.join(root, "Annotations", f"{name}.xml"),
                  "w") as f:
            f.write(_voc_xml(name, w, h, objects))
    half = (n_images + 1) // 2
    # the test split last: its presence marks a complete tree
    for split, names in (("train", ids[:half]), ("val", ids[half:]),
                         ("trainval", ids), ("test", ids)):
        path = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(f"{path}.{os.getpid()}.tmp", "w") as f:
            f.write("".join(f"{name}\n" for name in names))
        os.replace(f"{path}.{os.getpid()}.tmp", path)
    return root


def voc_ground_truth(dataset, predictions, per_image=3, all_difficult=1):
    """Rewrite the XML of every image of ``dataset`` (a PascalVOCDataset)
    with its ``per_image`` best detections in ``predictions`` ({index:
    boxes xyxy, scores, labels}, as ``do_voc_evaluation`` takes them) as
    its objects, in VOC's 1-based integer corners inside the image: the
    second of image 0 and every one of image ``all_difficult``
    difficult."""
    for idx, name in enumerate(dataset.ids):
        p, r = predictions[idx], dataset.records[idx]
        objects = []
        for j, k in enumerate(np.argsort(-np.asarray(p["scores"]),
                                         kind="stable")[:per_image]):
            x1, y1, x2, y2 = np.round(np.asarray(p["boxes"][k]) + 1
                                      ).astype(int)
            objects.append((
                dataset.map_class_id_to_class_name(int(p["labels"][k])),
                idx == all_difficult or (idx == 0 and j == 1),
                (max(x1, 1), max(y1, 1), min(x2, r.width),
                 min(y2, r.height))))
        path = os.path.join(dataset.root, "Annotations", f"{name}.xml")
        with open(f"{path}.{os.getpid()}.tmp", "w") as f:
            f.write(_voc_xml(name, r.width, r.height, objects))
        os.replace(f"{path}.{os.getpid()}.tmp", path)

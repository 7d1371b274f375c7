"""COCO detection dataset (port of paa_tpu/data/coco.py, boxes,
polygons and keypoints).

Mirrors reference paa_core/data/datasets/coco.py:39-101 without
pycocotools: the instances json is parsed with the json module into
flat numpy records.

- image ids sorted; images without valid annotations removed at train
  (has_valid_annotation: empty, or all boxes with w/h <= 1, coco.py:21-36)
- crowd annotations filtered (coco.py:71)
- json category ids -> contiguous 1..80 by ascending json id
- boxes xywh -> xyxy with the +1 convention (BoxList.convert), clipped
  to the image with degenerate boxes removed
  (clip_to_image(remove_empty=True))
- with_masks (Mask R-CNN training): each kept instance's COCO polygons
  (``segmentation``, [] when absent) in ``ImageRecord.polygons``
- with_keypoints (Keypoint R-CNN training): each kept instance's
  ``keypoints`` as (G, K, 3) float32 (x, y, visibility; 17 zeros when
  absent) in ``ImageRecord.keypoints``. Images are kept as for boxes:
  the reference's filter of training images with fewer than 10 visible
  keypoints is not the JAX package's, nor the port's

Decoding goes by the file, not by what is installed: a binary PPM (P6)
is read with numpy, and any other format needs cv2, imported inside the
call (``read_image``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ImageRecord:
    id: int
    file_name: str
    width: int
    height: int
    boxes: np.ndarray  # (n, 4) float32 xyxy
    labels: np.ndarray  # (n,) int32 contiguous 1..C
    polygons: Optional[list] = None  # per instance, with_masks only
    keypoints: Optional[np.ndarray] = None  # (n, K, 3), with_keypoints


def _ppm_header(f):
    """(width, height, maxval) of a binary PPM after its magic, leaving
    ``f`` at the first pixel byte; comments (#) are skipped."""
    fields = []
    while len(fields) < 3:
        token = b""
        while True:
            c = f.read(1)
            if not c:
                raise ValueError("truncated PPM header")
            if c == b"#" and not token:
                f.readline()
                continue
            if c.isspace():
                if token:
                    break
                continue
            token += c
        fields.append(int(token))
    return fields


def read_ppm(path):
    """A binary PPM (P6, maxval 255) as BGR uint8 (H, W, 3), the layout
    ``cv2.imread(path, IMREAD_COLOR)`` gives."""
    with open(path, "rb") as f:
        if f.read(2) != b"P6":
            raise ValueError(f"{path}: not a binary PPM (P6)")
        w, h, maxval = _ppm_header(f)
        if maxval != 255:
            raise ValueError(f"{path}: PPM maxval {maxval}, only 255 is read")
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
    if data.size != w * h * 3:
        raise ValueError(f"{path}: {data.size} pixel bytes for {w}x{h}")
    return np.ascontiguousarray(data.reshape(h, w, 3)[:, :, ::-1])


def write_ppm(path, image_bgr):
    """Write a BGR uint8 (H, W, 3) image as a binary PPM (P6)."""
    h, w = image_bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image_bgr[:, :, ::-1]).tobytes())


def _is_ppm(path):
    with open(path, "rb") as f:
        return f.read(2) == b"P6"


def read_image(path):
    """Decode ``path`` to BGR uint8 HWC (cv2's order: the Caffe2
    convention the reference reaches via PIL-RGB + channel flip). A PPM
    (P6) is read with numpy; any other format needs cv2."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if _is_ppm(path):
        return read_ppm(path)
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: decoding this format needs the cv2 package "
            f"(opencv-python), which is not installed; binary PPM (P6) "
            f"images are read without it") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _xywh_to_xyxy(boxes):
    """BoxList 'xywh'->'xyxy' conversion (bounding_box.py:86-99):
    x2 = x1 + max(w - 1, 0)."""
    out = boxes.copy()
    out[:, 2] = boxes[:, 0] + np.clip(boxes[:, 2] - 1, 0, None)
    out[:, 3] = boxes[:, 1] + np.clip(boxes[:, 3] - 1, 0, None)
    return out


def _clip_remove_empty(boxes, labels, width, height):
    """clip_to_image(remove_empty=True) (bounding_box.py:215-227)."""
    boxes[:, 0] = np.clip(boxes[:, 0], 0, width - 1)
    boxes[:, 1] = np.clip(boxes[:, 1], 0, height - 1)
    boxes[:, 2] = np.clip(boxes[:, 2], 0, width - 1)
    boxes[:, 3] = np.clip(boxes[:, 3], 0, height - 1)
    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    return boxes[keep], labels[keep], keep


def _has_valid_annotation(annos):
    if len(annos) == 0:
        return False
    # all boxes close to zero area
    if all(any(o <= 1 for o in a["bbox"][2:]) for a in annos):
        return False
    return True


class COCODataset:
    def __init__(self, ann_file, root,
                 remove_images_without_annotations=True,
                 with_masks=False, with_keypoints=False):
        self.root = root
        with open(ann_file) as f:
            data = json.load(f)

        cat_ids = sorted(c["id"] for c in data["categories"])
        self.json_category_id_to_contiguous_id = {
            v: i + 1 for i, v in enumerate(cat_ids)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.categories = {
            c["id"]: c["name"] for c in data["categories"]
        }

        annos_by_image: Dict[int, list] = {}
        for a in data.get("annotations", []):
            annos_by_image.setdefault(a["image_id"], []).append(a)

        images = {img["id"]: img for img in data["images"]}
        ids = sorted(images.keys())

        self.records: List[ImageRecord] = []
        for img_id in ids:
            annos = annos_by_image.get(img_id, [])
            if remove_images_without_annotations and not _has_valid_annotation(
                annos
            ):
                continue
            img = images[img_id]
            non_crowd = [a for a in annos if a.get("iscrowd", 0) == 0]
            boxes = np.asarray(
                [a["bbox"] for a in non_crowd], dtype=np.float32
            ).reshape(-1, 4)
            labels = np.asarray(
                [self.json_category_id_to_contiguous_id[a["category_id"]]
                 for a in non_crowd],
                dtype=np.int32,
            ).reshape(-1)
            boxes, labels, keep = _clip_remove_empty(
                _xywh_to_xyxy(boxes), labels, img["width"], img["height"]
            )
            polygons = None
            if with_masks:
                polygons = [a.get("segmentation") or []
                            for a, k in zip(non_crowd, keep) if k]
            keypoints = None
            if with_keypoints:
                keypoints = np.zeros((0, 17, 3), np.float32)
                if non_crowd:
                    keypoints = np.asarray(
                        [np.asarray(a.get("keypoints") or [0.0] * 51,
                                    dtype=np.float32).reshape(-1, 3)
                         for a in non_crowd], dtype=np.float32)[keep]
            self.records.append(
                ImageRecord(
                    id=img_id,
                    file_name=img["file_name"],
                    width=img["width"],
                    height=img["height"],
                    boxes=boxes,
                    labels=labels,
                    polygons=polygons,
                    keypoints=keypoints,
                )
            )

        # eval needs the full GT (including crowd): keep raw annos around
        self._raw_annotations = annos_by_image

    def __len__(self):
        return len(self.records)

    def get_img_info(self, index):
        r = self.records[index]
        return {"id": r.id, "width": r.width, "height": r.height,
                "file_name": r.file_name}

    def image_path(self, index):
        return os.path.join(self.root, self.records[index].file_name)

    def load_image(self, index):
        """BGR uint8 HWC, as cv2.imread gives (``read_image``)."""
        return read_image(self.image_path(index))

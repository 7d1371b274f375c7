"""In-memory list-of-paths dataset (port of paa_tpu/data/list_dataset.py;
reference paa_core/data/datasets/list_dataset.py).

Wraps a plain list of image paths with a dummy full-image GT box and the
dataset protocol of COCODataset (records / get_img_info / load_image),
so the bucketed loader and the eval engine run over ad-hoc image lists
without annotations. Images decode through coco.read_image (PPM with
numpy, other formats with cv2).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from .coco import ImageRecord, read_image


class ListDataset:
    """image_paths: list of absolute (or root-relative) image paths.

    Image sizes are probed once up front (the reference leaves
    get_img_info unimplemented; the loader's bucketing needs them)."""

    def __init__(self, image_paths: List[str], root: str = ""):
        self.root = root
        self.records: List[ImageRecord] = []
        for i, p in enumerate(image_paths):
            h, w = read_image(os.path.join(root, p) if root else p).shape[:2]
            # dummy target: one full-image box, label 1
            # (list_dataset.py:20-21)
            self.records.append(ImageRecord(
                id=i, file_name=p, width=w, height=h,
                boxes=np.asarray([[0.0, 0.0, w - 1.0, h - 1.0]], np.float32),
                labels=np.asarray([1], np.int64)))

    def __len__(self):
        return len(self.records)

    def get_img_info(self, index):
        r = self.records[index]
        return {
            "id": r.id, "width": r.width, "height": r.height,
            "file_name": r.file_name,
        }

    def image_path(self, index):
        r = self.records[index]
        return os.path.join(self.root, r.file_name) if self.root \
            else r.file_name

    def load_image(self, index):
        return read_image(self.image_path(index))

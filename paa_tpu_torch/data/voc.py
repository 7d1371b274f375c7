"""Pascal VOC dataset (port of paa_tpu/data/voc.py; reference
paa_core/data/datasets/voc.py:17-135).

The XML annotations are parsed as the JAX package parses them: the
fixed 20-class list (background at index 0), the -1 pixel shift of VOC's
1-based coordinates (voc.py TO_REMOVE in _preprocess_annotation), and
the ``use_difficult`` switch (difficult objects are kept only at test
time; ``_difficult`` holds each record's flags for the evaluation).
Records take COCODataset's ``ImageRecord`` layout, so the loader and
the engine serve both.

Images decode by their content through ``coco.read_image``: a binary
PPM (P6) with numpy, anything else (VOC's JPEGs) through cv2, imported
inside the call.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from .coco import ImageRecord, read_image

CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
    "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class PascalVOCDataset:
    def __init__(self, data_dir, split, use_difficult=False):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult

        self._annopath = os.path.join(data_dir, "Annotations", "%s.xml")
        self._imgpath = os.path.join(data_dir, "JPEGImages", "%s.jpg")
        imgset = os.path.join(data_dir, "ImageSets", "Main", f"{split}.txt")
        with open(imgset) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.class_to_ind = {c: i for i, c in enumerate(CLASSES)}
        self.categories = dict(enumerate(CLASSES))

        self.records: List[ImageRecord] = []
        self._difficult = {}
        for idx, img_id in enumerate(self.ids):
            anno = ET.parse(self._annopath % img_id).getroot()
            size = anno.find("size")
            width = int(size.find("width").text)
            height = int(size.find("height").text)
            boxes, labels, difficult = [], [], []
            for obj in anno.iter("object"):
                is_difficult = int(obj.find("difficult").text) == 1
                if is_difficult and not self.keep_difficult:
                    continue
                name = obj.find("name").text.lower().strip()
                bb = obj.find("bndbox")
                # -1: VOC is 1-indexed (reference voc.py TO_REMOVE)
                boxes.append([float(bb.find(k).text) - 1
                              for k in ("xmin", "ymin", "xmax", "ymax")])
                labels.append(self.class_to_ind[name])
                difficult.append(is_difficult)
            self.records.append(ImageRecord(
                id=idx,
                file_name=f"{img_id}.jpg",
                width=width,
                height=height,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int32),
            ))
            self._difficult[idx] = np.asarray(difficult, dtype=bool)

    def __len__(self):
        return len(self.records)

    def image_path(self, index):
        return self._imgpath % self.ids[index]

    def load_image(self, index):
        """BGR uint8 HWC, as cv2.imread gives (``read_image``)."""
        return read_image(self.image_path(index))

    def get_img_info(self, index):
        r = self.records[index]
        return {"id": r.id, "width": r.width, "height": r.height}

    def map_class_id_to_class_name(self, class_id):
        return CLASSES[class_id]

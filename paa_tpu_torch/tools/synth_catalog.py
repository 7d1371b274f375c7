"""A paths catalog of synthetic COCO datasets, for dry runs of the
port's CLIs without COCO (the port's counterpart of
tools/synth_catalog.py, with PPM images that need no cv2):

    python -m paa_tpu_torch.tools.test_net \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        PATHS_CATALOG paa_tpu_torch/tools/synth_catalog.py \\
        DATASETS.TEST '("synth_coco_32",)'

``synth_coco_<n>`` is a dataset of n images (data/synth.py), written
once under $PAA_TPU_TORCH_SYNTH_DIR (default: a directory in the
system's temporary directory). ``keypoints_synth_coco_<n>`` is the same
images with one "person" category and 17 keypoints per box (Keypoint
R-CNN); the reference's keypoint dataset names (``keypoints_coco_*``,
config/paths_catalog.py) serve that dataset at 32 images, so that a
keypoint config runs with its own DATASETS. The reference's Pascal VOC
names (``voc_2007_train``, ``voc_2007_val``, ``voc_2007_test``, ... and
``synth_voc_<n>_<split>``) serve one synthetic VOC tree (data/synth.py
``synth_voc``, 16 images unless named) through PascalVOCDataset.
"""

import os
import re
import tempfile

from paa_tpu_torch.data.synth import synth_coco, synth_voc


class DatasetCatalog:
    DATA_DIR = os.environ.get(
        "PAA_TPU_TORCH_SYNTH_DIR",
        os.path.join(tempfile.gettempdir(), "paa_tpu_torch_synth"))

    @staticmethod
    def get(name):
        m = re.fullmatch(r"voc_20(07|12)_(train|val|trainval|test)", name)
        if m:
            name = f"synth_voc_16_{m.group(2)}"
        m = re.fullmatch(r"synth_voc_(\d+)_(train|val|trainval|test)", name)
        if m:
            data_dir = synth_voc(os.path.join(
                DatasetCatalog.DATA_DIR, f"synth_voc_{m.group(1)}"),
                int(m.group(1)))
            return dict(factory="PascalVOCDataset",
                        args=dict(data_dir=data_dir, split=m.group(2)))
        if re.fullmatch(r"keypoints_coco_\w+", name):
            name = "keypoints_synth_coco_32"
        m = re.fullmatch(r"(keypoints_)?synth_coco_(\d+)", name)
        if not m:
            raise RuntimeError(f"Dataset not available: {name}")
        ann_file, img_dir = synth_coco(
            os.path.join(DatasetCatalog.DATA_DIR, name), int(m.group(2)),
            person_keypoints=bool(m.group(1)))
        return dict(factory="COCODataset",
                    args=dict(root=img_dir, ann_file=ann_file))

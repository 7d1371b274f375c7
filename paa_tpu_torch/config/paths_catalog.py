"""Dataset and model catalogs (a copy of paa_tpu/config/paths_catalog.py).

Mirrors the reference's path indirection (paa_core/config/paths_catalog.py):
dataset names used in configs (``coco_2017_train`` etc.) resolve to concrete
image roots + annotation files here. Users can point DATA_DIR elsewhere via
the ``PAA_TPU_DATA_DIR`` environment variable or swap this module via
``cfg.PATHS_CATALOG`` (data/build.py loads the file that names). Both
packages read the same variables, so one dataset layout serves either.
"""

import os


class DatasetCatalog:
    DATA_DIR = os.environ.get("PAA_TPU_DATA_DIR", "datasets")
    DATASETS = {
        "coco_2017_train": {
            "img_dir": "coco/train2017",
            "ann_file": "coco/annotations/instances_train2017.json",
        },
        "coco_2017_val": {
            "img_dir": "coco/val2017",
            "ann_file": "coco/annotations/instances_val2017.json",
        },
        "coco_2014_train": {
            "img_dir": "coco/train2014",
            "ann_file": "coco/annotations/instances_train2014.json",
        },
        "coco_2014_val": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_val2014.json",
        },
        "coco_2014_minival": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_minival2014.json",
        },
        "coco_2014_valminusminival": {
            "img_dir": "coco/val2014",
            "ann_file": "coco/annotations/instances_valminusminival2014.json",
        },
        "keypoints_coco_2017_train": {
            "img_dir": "coco/train2017",
            "ann_file": "coco/annotations/person_keypoints_train2017.json",
        },
        "keypoints_coco_2017_val": {
            "img_dir": "coco/val2017",
            "ann_file": "coco/annotations/person_keypoints_val2017.json",
        },
        "keypoints_coco_2014_train": {
            "img_dir": "coco/train2014",
            "ann_file": "coco/annotations/person_keypoints_train2014.json",
        },
        "keypoints_coco_2014_minival": {
            "img_dir": "coco/val2014",
            "ann_file": (
                "coco/annotations/person_keypoints_minival2014.json"
            ),
        },
        "keypoints_coco_2014_valminusminival": {
            "img_dir": "coco/val2014",
            "ann_file": (
                "coco/annotations/"
                "person_keypoints_valminusminival2014.json"
            ),
        },
        # cityscapes instance segmentation converted to COCO json by
        # tools/cityscapes/convert_cityscapes_to_coco.py
        "cityscapes_fine_instanceonly_seg_train_cocostyle": {
            "img_dir": "cityscapes/images",
            "ann_file": (
                "cityscapes/annotations/"
                "instancesonly_filtered_gtFine_train.json"
            ),
        },
        "cityscapes_fine_instanceonly_seg_val_cocostyle": {
            "img_dir": "cityscapes/images",
            "ann_file": (
                "cityscapes/annotations/"
                "instancesonly_filtered_gtFine_val.json"
            ),
        },
        "cityscapes_fine_instanceonly_seg_test_cocostyle": {
            "img_dir": "cityscapes/images",
            "ann_file": (
                "cityscapes/annotations/"
                "instancesonly_filtered_gtFine_test.json"
            ),
        },
        "voc_2007_train": {"data_dir": "voc/VOC2007", "split": "train"},
        "voc_2007_val": {"data_dir": "voc/VOC2007", "split": "val"},
        "voc_2007_test": {"data_dir": "voc/VOC2007", "split": "test"},
        "voc_2012_train": {"data_dir": "voc/VOC2012", "split": "train"},
        "voc_2012_val": {"data_dir": "voc/VOC2012", "split": "val"},
        # VOC served through COCO-style jsons (reference
        # paths_catalog.py voc_*_cocostyle entries)
        "voc_2007_train_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_train2007.json",
        },
        "voc_2007_val_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_val2007.json",
        },
        "voc_2007_test_cocostyle": {
            "img_dir": "voc/VOC2007/JPEGImages",
            "ann_file": "voc/VOC2007/Annotations/pascal_test2007.json",
        },
        "voc_2012_train_cocostyle": {
            "img_dir": "voc/VOC2012/JPEGImages",
            "ann_file": "voc/VOC2012/Annotations/pascal_train2012.json",
        },
        "voc_2012_val_cocostyle": {
            "img_dir": "voc/VOC2012/JPEGImages",
            "ann_file": "voc/VOC2012/Annotations/pascal_val2012.json",
        },
    }

    @staticmethod
    def get(name):
        if "coco" in name:
            attrs = DatasetCatalog.DATASETS[name]
            data_dir = DatasetCatalog.DATA_DIR
            return dict(
                factory="COCODataset",
                args=dict(
                    root=os.path.join(data_dir, attrs["img_dir"]),
                    ann_file=os.path.join(data_dir, attrs["ann_file"]),
                ),
            )
        elif "voc" in name:
            attrs = DatasetCatalog.DATASETS[name]
            data_dir = DatasetCatalog.DATA_DIR
            return dict(
                factory="PascalVOCDataset",
                args=dict(
                    data_dir=os.path.join(data_dir, attrs["data_dir"]),
                    split=attrs["split"],
                ),
            )
        raise RuntimeError(f"Dataset not available: {name}")


class ModelCatalog:
    """catalog:// weight URL resolution (reference paths_catalog.py ModelCatalog).

    In this offline build, catalog:// URLs resolve to local files under
    ``PAA_TPU_WEIGHTS_DIR`` with the same basename layout as the Detectron
    model zoo.
    """

    WEIGHTS_DIR = os.environ.get("PAA_TPU_WEIGHTS_DIR", "weights")

    C2_IMAGENET_MODELS = {
        "MSRA/R-50": "R-50.pkl",
        "MSRA/R-101": "R-101.pkl",
        "MSRA/R-152": "R-152.pkl",
        "FAIR/20171220/X-101-32x8d": "X-101-32x8d.pkl",
        "FAIR/20171220/X-101-64x4d": "X-101-64x4d.pkl",
    }

    @staticmethod
    def get(name):
        if name.startswith("ImageNetPretrained/"):
            key = name[len("ImageNetPretrained/"):]
            fname = ModelCatalog.C2_IMAGENET_MODELS[key]
            return os.path.join(ModelCatalog.WEIGHTS_DIR, fname)
        if name.startswith("Caffe2Detectron/COCO/"):
            # catalog://Caffe2Detectron/COCO/<id>/<model_name> (reference
            # paths_catalog.py:169-181); offline: <model_name>.pkl under
            # WEIGHTS_DIR
            model_name = name.rsplit("/", 1)[-1]
            return os.path.join(
                ModelCatalog.WEIGHTS_DIR, f"{model_name}.pkl"
            )
        raise RuntimeError(f"model not present in the catalog {name}")

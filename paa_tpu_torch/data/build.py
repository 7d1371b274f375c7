"""Dataset construction from the catalog (port of paa_tpu/data/build.py;
reference data/build.py:17-58 build_dataset + paths_catalog
indirection). ``cfg.PATHS_CATALOG`` names the catalog file, loaded as a
module; its ``DatasetCatalog.get(name)`` gives the factory
(COCODataset or PascalVOCDataset) and its arguments."""

from __future__ import annotations

import importlib.util

from .coco import COCODataset
from .concat import ConcatDataset
from .voc import PascalVOCDataset

FACTORIES = {"COCODataset": COCODataset,
             "PascalVOCDataset": PascalVOCDataset}


def _load_paths_catalog(cfg):
    spec = importlib.util.spec_from_file_location(
        "paa_tpu_torch_paths_catalog", cfg.PATHS_CATALOG
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_dataset(cfg, dataset_names, is_train=True):
    """Build (and for several names at train, concatenate) datasets; at
    eval a list, one per name."""
    paths_catalog = _load_paths_catalog(cfg)
    datasets = []
    for name in dataset_names:
        data = paths_catalog.DatasetCatalog.get(name)
        args = dict(data["args"])
        if data["factory"] == "COCODataset":
            args["remove_images_without_annotations"] = is_train
            args["with_masks"] = cfg.MODEL.MASK_ON and is_train
            args["with_keypoints"] = cfg.MODEL.KEYPOINT_ON and is_train
        elif data["factory"] == "PascalVOCDataset":
            args["use_difficult"] = not is_train
        datasets.append(FACTORIES[data["factory"]](**args))

    if len(datasets) == 1:
        return datasets[0]
    if not is_train:
        return datasets
    return ConcatDataset(datasets)

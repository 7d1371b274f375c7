"""Evaluation engine (port of paa_tpu/engine/inference.py, the bbox
path; reference paa_core/engine/inference.py:19-123).

Batches of the bucketed loader go through the model's ``make_eval_fn``
(device normalize, backbone, head, post-processing with its kernels) on
the model's device; predictions come back to the host keyed by image
id, are rescaled to the original image size and converted to COCO xywh
with the +1 convention (BoxList.convert) before the COCO evaluator.
Total and model time are logged. The same engine serves every model
with ``make_eval_fn``: PAA and Faster R-CNN.

Data-parallel under a process group (utils/comm.py): the loader gives
each rank every world-th whole batch (data/loader.py), so a batch keeps
the composition it has in one process and so its detections; the
predictions are gathered with ``all_gather_pickled`` and only the main
process runs the COCO evaluator and writes the files. The other ranks
return {}.

TEST.BBOX_AUG.ENABLED dispatches to ``bbox_aug.inference_tta`` (test-time
augmentation, one process), which evaluates through
``evaluate_predictions`` as this engine does.

Not ported: the optimistic-DCN fallback (a TPU lowering), and the
RPN-only, mask and keypoint outputs (ROADMAP item 10).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from ..data.loader import make_data_loader
from ..evaluation.coco_eval import (
    COCOEvaluator, check_expected_results, format_results)
from ..utils import comm


def compute_on_dataset(model, loader, state=None):
    """Run ``model.make_eval_fn(state)`` over ``loader``: (predictions by
    image id, model seconds, images), this rank's. The model time spans
    each batch's call through to its detections on the host."""
    eval_fn = model.make_eval_fn(state)
    predictions = {}
    model_time = 0.0
    n_images = 0
    for batch in loader:
        t0 = time.perf_counter()
        det = {k: v.cpu().numpy() for k, v in eval_fn(
            torch.from_numpy(batch["images"]),
            torch.from_numpy(batch["image_sizes"])).items()}
        model_time += time.perf_counter() - t0

        for i, img_id in enumerate(batch["image_ids"]):
            if img_id < 0:  # padding image in a short batch
                continue
            n_images += 1
            valid = det["valid"][i]
            boxes = det["boxes"][i][valid]
            # rescale network-input coords -> original image coords
            oh, ow = batch["orig_sizes"][i]
            rh, rw = batch["image_sizes"][i]
            scale = np.array(
                [ow / rw, oh / rh, ow / rw, oh / rh], dtype=np.float32
            )
            boxes = boxes * scale
            # xyxy -> COCO xywh with the +1 convention (BoxList.convert)
            xywh = np.stack(
                [
                    boxes[:, 0],
                    boxes[:, 1],
                    boxes[:, 2] - boxes[:, 0] + 1.0,
                    boxes[:, 3] - boxes[:, 1] + 1.0,
                ],
                axis=1,
            )
            predictions[int(img_id)] = dict(
                boxes_xywh=xywh, scores=det["scores"][i][valid],
                labels=det["labels"][i][valid])
    return predictions, model_time, n_images


def inference(cfg, model, dataset, output_folder=None, logger=None,
              state=None):
    """Evaluate ``model`` on ``dataset``: the 12 COCO bbox metrics.
    ``state``, if given, is a state_dict loaded into the model first.
    With ``output_folder``, writes coco_results.json (the metrics) and
    bbox.json (the detections in COCO's results format) there. Under a
    process group every rank calls it; the main process returns the
    metrics and writes the files, the others return {}."""
    logger = logger or logging.getLogger("paa_tpu_torch.inference")
    if cfg.TEST.BBOX_AUG.ENABLED:
        from .bbox_aug import inference_tta

        return inference_tta(cfg, model, dataset, output_folder, logger,
                             state)
    loader = make_data_loader(cfg, dataset, is_train=False)

    t_start = time.perf_counter()
    predictions, model_time, n_images = compute_on_dataset(
        model, loader, state)
    total = time.perf_counter() - t_start
    if n_images:
        logger.info(
            f"Total run time: {total:.1f}s "
            f"({total / n_images:.4f} s/img); model time "
            f"{model_time:.1f}s ({model_time / n_images:.4f} s/img)"
        )
    if comm.get_world_size() > 1:
        parts = comm.all_gather_pickled(predictions)
        if not comm.is_main_process():
            return {}
        predictions = {k: v for part in parts for k, v in part.items()}
    return evaluate_predictions(cfg, dataset, predictions, output_folder,
                                logger)


def evaluate_predictions(cfg, dataset, predictions, output_folder, logger):
    """The 12 COCO bbox metrics of ``predictions`` ({image id: xywh
    boxes, scores, contiguous labels}) on ``dataset``, checked against
    TEST.EXPECTED_RESULTS; with ``output_folder``, coco_results.json and
    bbox.json written there."""
    # map contiguous labels -> json category ids
    cat_ids = sorted(dataset.contiguous_category_id_to_json_id.values())
    detections: Dict[int, dict] = {}
    for img_id, p in predictions.items():
        detections[img_id] = dict(
            boxes_xywh=p["boxes_xywh"],
            scores=p["scores"],
            category_ids=np.asarray(
                [
                    dataset.contiguous_category_id_to_json_id[int(l)]
                    for l in p["labels"]
                ],
                dtype=np.int64,
            ),
        )

    image_ids = [r.id for r in dataset.records]
    evaluator = COCOEvaluator(dataset._raw_annotations, cat_ids, image_ids)
    results = evaluator.evaluate(detections)
    logger.info("\n" + format_results(results))

    if cfg.TEST.EXPECTED_RESULTS:
        check_expected_results(
            results, cfg.TEST.EXPECTED_RESULTS,
            cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL, logger,
        )

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "coco_results.json"), "w") as f:
            json.dump(results, f, indent=2)
        bbox_json = []
        for img_id, d in detections.items():
            for b, s, c in zip(
                d["boxes_xywh"], d["scores"], d["category_ids"]
            ):
                bbox_json.append(
                    dict(
                        image_id=int(img_id),
                        category_id=int(c),
                        bbox=[float(x) for x in b],
                        score=float(s),
                    )
                )
        with open(os.path.join(output_folder, "bbox.json"), "w") as f:
            json.dump(bbox_json, f)
    return results

"""Evaluation engine (port of paa_tpu/engine/inference.py, the bbox,
segm and keypoints paths; reference
paa_core/engine/inference.py:19-123).

Batches of the bucketed loader go through the model's ``make_eval_fn``
(device normalize, backbone, head, post-processing with its kernels) on
the model's device; predictions come back to the host keyed by image
id, are rescaled to the original image size and converted to COCO xywh
with the +1 convention (BoxList.convert) before the COCO evaluator.
Total and model time are logged. The same engine serves every model
with ``make_eval_fn``: the dense detectors, Faster R-CNN and Mask
R-CNN. A Mask R-CNN's 28x28 mask probabilities are pasted into the
original image at each rescaled box, thresholded at 0.5 and
RLE-encoded on the host (structures/masks.py, evaluation/mask_rle.py,
no cv2), and the segm table follows the bbox one, its metrics under
``segm/...``. A Keypoint R-CNN's (K, 56, 56) heatmaps come to the host
apart from the detections and are decoded there per kept box
(structures/keypoints.py ``heatmaps_to_keypoints``: cv2's cubic resize
without cv2) into (K, 3) keypoints, rescaled to the original image; the
keypoints table (OKS, 10 metrics) follows the bbox one under
``keypoints/...``. The seconds of the heatmaps' copy and decode are
logged. The RPN-only model's detections are its proposals: they are
scored by box-proposal average recall instead (the reference's
box_proposal table, ``coco_eval.box_proposal_table``: AR, ARs, ARm, ARl
at 100 and 1,000 proposals per image, in original-image coordinates),
logged and written to box_proposals.json.

Data-parallel under a process group (utils/comm.py): the loader gives
each rank every world-th whole batch (data/loader.py), so a batch keeps
the composition it has in one process and so its detections; the
predictions are gathered with ``all_gather_pickled`` and only the main
process runs the COCO evaluator and writes the files. The other ranks
return {}.

TEST.BBOX_AUG.ENABLED dispatches to ``bbox_aug.inference_tta`` (test-time
augmentation, one process), which evaluates through
``evaluate_predictions`` as this engine does.

Not ported: the optimistic-DCN fallback (a TPU lowering).
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
from ..evaluation import mask_rle
from ..evaluation.coco_eval import (
    COCOEvaluator, box_proposal_table, check_expected_results,
    format_results)
from ..structures.keypoints import heatmaps_to_keypoints
from ..structures.masks import paste_mask_in_image
from ..utils import comm


def compute_on_dataset(model, loader, state=None):
    """Run ``model.make_eval_fn(state)`` over ``loader``: (predictions by
    image id, model seconds, images, host seconds), this rank's. The
    model time spans each batch's call through to its detections on the
    host; the host seconds are the keypoint heatmaps' copy to the host
    ("keypoint_copy_s") and their decode ("keypoint_decode_s")."""
    eval_fn = model.make_eval_fn(state)
    predictions = {}
    model_time = 0.0
    n_images = 0
    host = {"keypoint_copy_s": 0.0, "keypoint_decode_s": 0.0}
    for batch in loader:
        t0 = time.perf_counter()
        out = eval_fn(torch.from_numpy(batch["images"]),
                      torch.from_numpy(batch["image_sizes"]))
        heatmaps = out.pop("kp_heatmaps", None)
        det = {k: v.cpu().numpy() for k, v in out.items()}
        model_time += time.perf_counter() - t0
        if heatmaps is not None:
            t0 = time.perf_counter()
            heatmaps = heatmaps.cpu()
            host["keypoint_copy_s"] += time.perf_counter() - t0

        for i, img_id in enumerate(batch["image_ids"]):
            if img_id < 0:  # padding image in a short batch
                continue
            n_images += 1
            valid = det["valid"][i]
            net_boxes = det["boxes"][i][valid]
            # rescale network-input coords -> original image coords
            oh, ow = batch["orig_sizes"][i]
            rh, rw = batch["image_sizes"][i]
            scale = np.array(
                [ow / rw, oh / rh, ow / rw, oh / rh], dtype=np.float32
            )
            boxes = net_boxes * scale
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
            pred = dict(boxes_xywh=xywh, scores=det["scores"][i][valid],
                        labels=det["labels"][i][valid])
            if heatmaps is not None:
                # decoded in the network's coordinates, then rescaled
                # (reference heatmaps_to_keypoints + Keypoints.resize)
                t0 = time.perf_counter()
                kps = heatmaps_to_keypoints(
                    heatmaps[i][torch.from_numpy(valid)], net_boxes)
                kps[..., 0] *= ow / rw
                kps[..., 1] *= oh / rh
                pred["keypoints"] = kps
                host["keypoint_decode_s"] += time.perf_counter() - t0
            if "masks" in det:
                # box-frame mask probabilities pasted into the original
                # image (reference Masker), then RLE (coco_eval.py
                # prepare_for_coco_segmentation)
                oh_i, ow_i = int(round(float(oh))), int(round(float(ow)))
                pred["masks_rle"] = [
                    mask_rle.encode(paste_mask_in_image(m, b, oh_i, ow_i))
                    for m, b in zip(det["masks"][i][valid], boxes)]
            predictions[int(img_id)] = pred
    return predictions, model_time, n_images, host


def inference(cfg, model, dataset, output_folder=None, logger=None,
              state=None):
    """Evaluate ``model`` on a COCO-format ``dataset`` (any other raises
    NotImplementedError naming the VOC path): the 12 COCO bbox metrics, and
    for a model with masks the 12 segm ones under "segm/..."; for the
    RPN-only model (``head_type`` "rpn") the box_proposal table
    (``evaluate_proposals``) instead.
    ``state``, if given, is a state_dict loaded into the model first.
    With ``output_folder``, writes coco_results.json (the metrics) and
    bbox.json (the detections in COCO's results format) there. Under a
    process group every rank calls it; the main process returns the
    metrics and writes the files, the others return {}."""
    logger = logger or logging.getLogger("paa_tpu_torch.inference")
    if not hasattr(dataset, "_raw_annotations"):
        # the JAX package's inference evaluates COCO annotations only
        raise NotImplementedError(
            f"inference evaluates COCO-format datasets; "
            f"{type(dataset).__name__} has no COCO annotations. For Pascal "
            f"VOC run compute_on_dataset, then "
            f"evaluation.voc_eval.predictions_from_xywh and "
            f"evaluation.voc_eval.do_voc_evaluation")
    if cfg.TEST.BBOX_AUG.ENABLED:
        from .bbox_aug import inference_tta

        return inference_tta(cfg, model, dataset, output_folder, logger,
                             state)
    loader = make_data_loader(cfg, dataset, is_train=False)

    t_start = time.perf_counter()
    predictions, model_time, n_images, host = compute_on_dataset(
        model, loader, state)
    total = time.perf_counter() - t_start
    if n_images:
        logger.info(
            f"Total run time: {total:.1f}s "
            f"({total / n_images:.4f} s/img); model time "
            f"{model_time:.1f}s ({model_time / n_images:.4f} s/img)"
        )
    if any(p.get("keypoints") is not None for p in predictions.values()):
        logger.info(
            f"Keypoint heatmaps on the host: copy "
            f"{host['keypoint_copy_s']:.3f}s, decode "
            f"{host['keypoint_decode_s']:.3f}s")
    if comm.get_world_size() > 1:
        parts = comm.all_gather_pickled(predictions)
        if not comm.is_main_process():
            return {}
        predictions = {k: v for part in parts for k, v in part.items()}
    if model.head_type == "rpn":
        return evaluate_proposals(dataset, predictions, output_folder,
                                  logger)
    return evaluate_predictions(cfg, dataset, predictions, output_folder,
                                logger)


def evaluate_proposals(dataset, predictions, output_folder, logger):
    """The box_proposal table of the RPN-only model's ``predictions``
    ({image id: xywh boxes in pick order, ...}) on ``dataset``: AR at
    100 and 1,000 proposals, all areas and small / medium / large; with
    ``output_folder``, box_proposals.json written there."""
    proposals = {}
    for img_id, p in predictions.items():
        xywh = np.asarray(p["boxes_xywh"], np.float64).reshape(-1, 4)
        # back to xyxy with the +1 convention
        proposals[img_id] = {"boxes": np.concatenate(
            [xywh[:, :2], xywh[:, :2] + xywh[:, 2:] - 1.0], axis=1)}
    results = box_proposal_table(proposals, dataset._raw_annotations,
                                 [r.id for r in dataset.records])
    logger.info("box_proposal:\n" + "\n".join(
        f"{k}: {v:.4f}" for k, v in results.items()))
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "box_proposals.json"),
                  "w") as f:
            json.dump(results, f, indent=2)
    return results


def evaluate_predictions(cfg, dataset, predictions, output_folder, logger):
    """The 12 COCO bbox metrics of ``predictions`` ({image id: xywh
    boxes, scores, contiguous labels, and with masks ``masks_rle``, with
    keypoints ``keypoints``}) on ``dataset``, the 10 keypoints ones
    under "keypoints/..." when every prediction has keypoints and the
    segm ones under "segm/..." when every prediction has masks, checked
    against TEST.EXPECTED_RESULTS; with ``output_folder``,
    coco_results.json and bbox.json written there."""
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

    if predictions and all("keypoints" in p for p in predictions.values()):
        for img_id, p in predictions.items():
            detections[img_id]["keypoints"] = p["keypoints"]
        kp = COCOEvaluator(dataset._raw_annotations, cat_ids, image_ids,
                           iou_type="keypoints").evaluate(detections)
        logger.info("keypoints:\n" + format_results(kp, "keypoints"))
        results = {**results, **{f"keypoints/{k}": v for k, v in kp.items()}}

    if predictions and all("masks_rle" in p for p in predictions.values()):
        for img_id, p in predictions.items():
            detections[img_id]["masks_rle"] = p["masks_rle"]
        segm = COCOEvaluator(
            dataset._raw_annotations, cat_ids, image_ids, iou_type="segm",
            image_sizes={r.id: (r.height, r.width) for r in dataset.records},
        ).evaluate(detections)
        logger.info("segm:\n" + format_results(segm, "segm"))
        results = {**results, **{f"segm/{k}": v for k, v in segm.items()}}

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

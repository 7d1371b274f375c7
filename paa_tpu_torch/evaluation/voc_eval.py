"""Pascal VOC detection evaluation in numpy (a copy of
paa_tpu/evaluation/voc_eval.py; reference evaluation/voc/voc_eval.py,
itself from chainercv): a per-class precision/recall curve at IoU 0.5,
then the VOC-07 11-point AP or the continuous (VOC-10) one. The
reference's quirks stay: boxes widened by +1 on (x2, y2) before the IoU
("integer typed bounding boxes", voc_eval.py:106-110) and the +1
convention of boxlist_iou on top, difficult GTs ignored, each GT
matched once (the first match by score wins).

Predictions and GTs are lists, one dict of numpy arrays per image.
``do_voc_evaluation`` takes a dataset (data/voc.py) and predictions
keyed by image index, boxes xyxy in the original image's coordinates:
``engine/inference.py::inference`` evaluates COCO-format datasets only,
as the JAX package's does, so a VOC evaluation runs
``compute_on_dataset``, turns its COCO xywh boxes back into xyxy
(x2 = x + w - 1) and calls ``do_voc_evaluation``.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np


def _iou_plus1(a, b):
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def calc_voc_prec_rec(gts, preds, iou_thresh=0.5):
    """gts/preds: lists (per image) of dicts with boxes (n,4) xyxy,
    labels (n,), scores (preds), difficult (gts)."""
    n_pos = defaultdict(int)
    score = defaultdict(list)
    match = defaultdict(list)
    for gt, pred in zip(gts, preds):
        labels_all = np.concatenate(
            [pred["labels"], gt["labels"]]
        ).astype(int)
        for l in np.unique(labels_all):
            pm = pred["labels"] == l
            pb = pred["boxes"][pm]
            ps = pred["scores"][pm]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]

            gm = gt["labels"] == l
            gb = gt["boxes"][gm]
            gd = gt["difficult"][gm]

            n_pos[l] += int(np.logical_not(gd).sum())
            score[l].extend(ps)

            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[l].extend((0,) * len(pb))
                continue

            pb = pb.copy()
            pb[:, 2:] += 1
            gb = gb.copy()
            gb[:, 2:] += 1
            iou = _iou_plus1(pb, gb)
            gt_index = iou.argmax(axis=1)
            gt_index[iou.max(axis=1) < iou_thresh] = -1

            selec = np.zeros(len(gb), dtype=bool)
            for gi in gt_index:
                if gi >= 0:
                    if gd[gi]:
                        match[l].append(-1)
                    else:
                        match[l].append(1 if not selec[gi] else 0)
                    selec[gi] = True
                else:
                    match[l].append(0)

    n_fg_class = max(n_pos.keys()) + 1 if n_pos else 0
    prec = [None] * n_fg_class
    rec = [None] * n_fg_class
    for l in n_pos.keys():
        score_l = np.asarray(score[l])
        match_l = np.asarray(match[l], dtype=np.int8)
        order = score_l.argsort()[::-1]
        match_l = match_l[order]
        tp = np.cumsum(match_l == 1)
        fp = np.cumsum(match_l == 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            prec[l] = tp / (fp + tp)
        if n_pos[l] > 0:
            rec[l] = tp / n_pos[l]
    return prec, rec


def calc_voc_ap(prec, rec, use_07_metric=False):
    n_fg_class = len(prec)
    ap = np.empty(n_fg_class)
    for l in range(n_fg_class):
        if prec[l] is None or rec[l] is None:
            ap[l] = np.nan
            continue
        if use_07_metric:
            ap[l] = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[l] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[l])[rec[l] >= t])
                ap[l] += p / 11
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[l]), [0]))
            mrec = np.concatenate(([0], rec[l], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            i = np.where(mrec[1:] != mrec[:-1])[0]
            ap[l] = np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1])
    return ap


def eval_detection_voc(gts, preds, iou_thresh=0.5, use_07_metric=True):
    prec, rec = calc_voc_prec_rec(gts, preds, iou_thresh)
    ap = calc_voc_ap(prec, rec, use_07_metric)
    return {"ap": ap, "map": float(np.nanmean(ap))}


def do_voc_evaluation(dataset, predictions, output_folder=None,
                      logger=None):
    """predictions: dict image index -> dict(boxes xyxy in ORIGINAL
    coords, scores, labels)."""
    gts, preds = [], []
    for idx, r in enumerate(dataset.records):
        difficult = dataset._difficult.get(idx)
        if difficult is None or len(difficult) != len(r.labels):
            difficult = np.zeros(len(r.labels), dtype=bool)
        gts.append(
            dict(boxes=r.boxes, labels=r.labels, difficult=difficult)
        )
        p = predictions.get(idx)
        if p is None:
            preds.append(
                dict(
                    boxes=np.zeros((0, 4), np.float32),
                    labels=np.zeros((0,), np.int32),
                    scores=np.zeros((0,), np.float32),
                )
            )
        else:
            preds.append(p)
    result = eval_detection_voc(gts, preds, 0.5, use_07_metric=True)
    lines = [f"mAP: {result['map']:.4f}"]
    for i, ap in enumerate(result["ap"]):
        if i == 0:
            continue
        name = dataset.map_class_id_to_class_name(i)
        lines.append(f"{name:<16}: {ap:.4f}")
    text = "\n".join(lines)
    if logger:
        logger.info(text)
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "result.txt"), "w") as f:
            f.write(text)
    return result


def predictions_from_xywh(predictions):
    """``compute_on_dataset``'s predictions ({image id: boxes_xywh,
    scores, labels}) as ``do_voc_evaluation`` takes them: boxes back to
    xyxy with the +1 convention (x2 = x + w - 1). A VOC dataset's image
    id is its index."""
    out = {}
    for img_id, p in predictions.items():
        xywh = np.asarray(p["boxes_xywh"], np.float32).reshape(-1, 4)
        out[img_id] = dict(
            boxes=np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]
                                  - 1.0], axis=1),
            scores=np.asarray(p["scores"]), labels=np.asarray(p["labels"]))
    return out

"""Test-time augmentation, multi-scale testing (port of
paa_tpu/engine/bbox_aug.py; reference paa_core/engine/bbox_aug.py and
bbox_aug_vote.py).

Each augmentation of ``build_aug_list`` (the identity, its horizontal
flip, then every TEST.BBOX_AUG.SCALES entry, flipped too with
SCALE_H_FLIP) resizes every image of a batch with the port's
``resize_uint8_linear`` (cv2's INTER_LINEAR bit for bit, without cv2),
flips it, and pads the batch into the JAX package's bucket: height
``_ceil32(min(scale, max_size))``, width ``_ceil32(max_size)``, each
raised to what an image of the batch needs. The raw uint8 batch goes
through the model on its device once per augmentation:

- with TEST.BBOX_AUG.VOTE, through ``make_eval_fn`` (normalize,
  backbone, head, post-processing with its NMS kernel and score voting),
  as PAAPostProcessor's ``bbox_aug_vote`` gate does (paa/inference.py:
  96-97); its detections are merged per class by MERGE_TYPE (``vote``,
  ``soft-vote`` or plain NMS) and capped at ATSS.PRE_NMS_TOP_N;
- without it, through the head and ``paa_candidates`` (the pre-NMS
  candidates of every level, clipped); the candidates of all
  augmentations are pooled and one host class-aware NMS at FCOS.NMS_TH
  keeps TEST.DETECTIONS_PER_IMG of them.

On the host each augmentation's boxes are un-flipped in the scaled
space (BoxList.transpose), gated by the scale's SCALE_RANGES on their
area there (+1 convention), and mapped to the original image. The
merge helpers (``np_greedy_ml_nms``, ``bbox_vote``, ``soft_bbox_vote``)
are the JAX package's host numpy, copied: the reference's are numpy
too. ``inference_tta`` runs a dataset through ``TTAEngine`` in one
process and evaluates it as ``engine/inference.py`` does.
"""

from __future__ import annotations

import logging
import math
import time
from typing import List, Tuple

import numpy as np
import torch

from ..data.transforms import get_resize_size, resize_uint8_linear
from ..modeling.paa_inference import paa_candidates
from ..ops.image_norm import maybe_device_normalize
from ..utils import comm
from .inference import evaluate_predictions


def _ceil32(x):
    return int(math.ceil(x / 32) * 32)


def np_greedy_ml_nms(boxes, scores, labels, thresh, max_out):
    """Host greedy class-aware NMS, +1 IoU convention, pick-max style."""
    scores = scores.copy().astype(np.float64)
    keep = []
    for _ in range(max_out):
        i = int(scores.argmax())
        if scores[i] <= -1e30:
            break
        keep.append(i)
        lt = np.maximum(boxes[i, :2], boxes[:, :2])
        rb = np.minimum(boxes[i, 2:], boxes[:, 2:])
        wh = np.clip(rb - lt + 1, 0, None)
        inter = wh[:, 0] * wh[:, 1]
        a1 = (boxes[i, 2] - boxes[i, 0] + 1) * (boxes[i, 3] - boxes[i, 1] + 1)
        a2 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
        iou = inter / (a1 + a2 - inter)
        scores[(iou > thresh) & (labels == labels[i])] = -1e31
        scores[i] = -1e31
    return np.asarray(keep, dtype=np.int64)


def _vote_clusters(boxes, scores, vote_thresh):
    """Greedy score-ordered clustering on the pairwise +1-IoU matrix: in
    descending score order, each detection not yet in a cluster seeds
    one of every remaining detection with IoU >= vote_thresh to it
    (reference bbox_aug_vote.py:203-310, as mask updates over one IoU
    matrix instead of repeated array deletion).

    Returns (b, s, cluster, seed_iou, n_clusters): score-sorted float64
    boxes/scores, each detection's cluster id (ids are in seed-score
    order), and its IoU against its cluster's seed."""
    order = scores.argsort()[::-1]
    b = boxes[order].astype(np.float64)
    s = scores[order].astype(np.float64)
    n = len(s)
    area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / (area[:, None] + area[None, :] - inter)

    cluster = np.full(n, -1, dtype=np.int64)
    seed_iou = np.zeros(n)
    unassigned = np.ones(n, dtype=bool)
    k = 0
    while unassigned.any():
        seed = int(unassigned.argmax())  # highest-score unassigned
        members = unassigned & (iou[seed] >= vote_thresh)
        cluster[members] = k
        seed_iou[members] = iou[seed, members]
        unassigned &= ~members
        k += 1
    return b, s, cluster, seed_iou, k


def _merge_clusters(b, s, cluster, k):
    """Score-weighted box average and max score per cluster."""
    wsum = np.stack(
        [
            np.bincount(cluster, weights=b[:, d] * s, minlength=k)
            for d in range(4)
        ],
        axis=1,
    )
    ssum = np.bincount(cluster, weights=s, minlength=k)
    # detections are score-sorted, so each cluster's first member (its
    # seed) carries the cluster max score
    smax = np.zeros(k)
    np.maximum.at(smax, cluster, s)
    return wsum / ssum[:, None], smax


def bbox_vote(boxes, scores, vote_thresh):
    """IoU-cluster detections, emit one score-weighted average box with
    the cluster max score per cluster (reference bbox_aug_vote.py:
    203-249)."""
    if boxes.shape[0] <= 1:
        return np.zeros((0, 4)), np.zeros((0,))
    b, s, cluster, _, k = _vote_clusters(boxes, scores, vote_thresh)
    merged, smax = _merge_clusters(b, s, cluster, k)
    return merged, smax


def soft_bbox_vote(boxes, scores, vote_thresh, score_thresh):
    """Like bbox_vote, but members of multi-detection clusters survive
    with soft-NMS-style decayed scores ``s * (1 - IoU_to_seed)`` when
    still above ``score_thresh``; output is re-sorted by score
    (reference bbox_aug_vote.py:252-310)."""
    if boxes.shape[0] <= 1:
        return np.zeros((0, 4)), np.zeros((0,))
    b, s, cluster, seed_iou, k = _vote_clusters(boxes, scores, vote_thresh)
    merged, smax = _merge_clusters(b, s, cluster, k)

    sizes = np.bincount(cluster, minlength=k)
    soft_s = s * (1 - seed_iou)
    keep = (sizes[cluster] > 1) & (soft_s >= score_thresh)

    all_boxes = np.concatenate([merged, b[keep]])
    all_scores = np.concatenate([smax, soft_s[keep]])
    order = all_scores.argsort()[::-1]
    return all_boxes[order], all_scores[order]


def build_aug_list(cfg):
    """[(scale, max_size, hflip, scale_range or None), ...]; the first
    entry is the identity transform."""
    augs = [(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, False, None)]
    if cfg.TEST.BBOX_AUG.H_FLIP:
        augs.append(
            (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, True, None)
        )
    ranges = cfg.TEST.BBOX_AUG.SCALE_RANGES
    for idx, scale in enumerate(cfg.TEST.BBOX_AUG.SCALES):
        max_size = cfg.TEST.BBOX_AUG.MAX_SIZE
        if scale < 800:
            max_size = cfg.INPUT.MAX_SIZE_TEST
        rng = tuple(ranges[idx]) if idx < len(ranges) else None
        augs.append((scale, max_size, False, rng))
        if cfg.TEST.BBOX_AUG.SCALE_H_FLIP:
            augs.append((scale, max_size, True, rng))
    return augs


def aug_batch(raw_images, scale, max_size, hflip):
    """The padded raw uint8 batch of one augmentation: images (B, bh,
    bw, 3) and the (h, w) of each resized image, as ints."""
    bucket_h = _ceil32(min(scale, max_size))
    bucket_w = _ceil32(max_size)
    resized, sizes = [], []
    for img in raw_images:
        h, w = img.shape[:2]
        oh, ow = get_resize_size((w, h), scale, max_size)
        r = resize_uint8_linear(img, ow, oh)
        if hflip:
            r = np.ascontiguousarray(r[:, ::-1])
        resized.append(r)
        sizes.append((oh, ow))
    bh = max([bucket_h] + [_ceil32(oh) for oh, _ in sizes])
    bw = max([bucket_w] + [_ceil32(ow) for _, ow in sizes])
    images = np.zeros((len(resized), bh, bw, 3), np.uint8)
    for i, r in enumerate(resized):
        images[i, : r.shape[0], : r.shape[1]] = r
    return images, sizes


def to_original(boxes, scores, labels, size, orig_hw, hflip, srange):
    """One image's boxes of one augmentation in the original image's
    coordinates: un-flipped in the scaled space (BoxList.transpose),
    gated on their area there by ``srange`` (+1 convention), rescaled."""
    oh, ow = size
    if hflip:
        x1 = ow - boxes[:, 2] - 1.0
        x2 = ow - boxes[:, 0] - 1.0
        boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
    if srange is not None:
        a = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
        keep = (a > srange[0] ** 2) & (a < srange[1] ** 2)
        boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    h, w = orig_hw
    boxes = boxes * np.array([w / ow, h / oh, w / ow, h / oh], np.float32)
    return boxes, scores, labels


class TTAEngine:
    """Runs each augmentation of a batch through ``model`` on its device
    and merges the detections on the host. ``state``, if given, is a
    state_dict loaded into the model first."""

    def __init__(self, cfg, model, state=None):
        if not cfg.MODEL.PAA_ON:
            raise NotImplementedError(
                "paa_tpu_torch runs TEST.BBOX_AUG for PAA models only")
        self.cfg = cfg
        self.model = model
        self.vote = cfg.TEST.BBOX_AUG.VOTE
        self.eval_fn = model.make_eval_fn(state)
        self.pp = model.postprocess_config()

    @torch.inference_mode()
    def candidates(self, images, image_sizes):
        """The pre-NMS candidates of a raw uint8 batch (the no-vote
        path): {"boxes", "scores", "labels", "valid"}, (B, K, ...)."""
        model = self.model
        images = torch.as_tensor(images).to(model.device)
        image_sizes = torch.as_tensor(image_sizes).to(model.device)
        x = maybe_device_normalize(images, image_sizes,
                                   self.cfg.INPUT.PIXEL_MEAN,
                                   self.cfg.INPUT.PIXEL_STD)
        out = model.module(x.permute(0, 3, 1, 2).contiguous())
        anchors, counts = model.anchors_for(x.shape[1:3])
        boxes, scores, labels, valid = paa_candidates(
            out, image_sizes, anchors, counts, self.pp)
        return {"boxes": boxes, "scores": scores, "labels": labels,
                "valid": valid}

    def detect_batch(self, raw_images):
        """raw_images: list of HWC uint8 BGR. Returns the merged
        (boxes_xyxy in the original image's coordinates, scores, labels)
        of each image."""
        per_image: List[List[Tuple]] = [[] for _ in raw_images]
        run = self.eval_fn if self.vote else self.candidates
        for scale, max_size, hflip, srange in build_aug_list(self.cfg):
            images, sizes = aug_batch(raw_images, scale, max_size, hflip)
            det = {k: v.cpu().numpy() for k, v in run(
                torch.from_numpy(images),
                torch.tensor(sizes, dtype=torch.float32)).items()}
            for i, img in enumerate(raw_images):
                valid = det["valid"][i]
                per_image[i].append(to_original(
                    det["boxes"][i][valid], det["scores"][i][valid],
                    det["labels"][i][valid], sizes[i], img.shape[:2],
                    hflip, srange))
        results = []
        for parts in per_image:
            boxes, scores, labels = (np.concatenate(x) for x in zip(*parts))
            results.append(self._merge(boxes, scores, labels))
        return results

    def _merge(self, boxes, scores, labels):
        cfg = self.cfg
        if not self.vote:
            # one final class-aware NMS at FCOS.NMS_TH, cap
            # TEST.DETECTIONS_PER_IMG (bbox_aug.py:66-68)
            keep = np_greedy_ml_nms(
                boxes, scores, labels, cfg.MODEL.FCOS.NMS_TH,
                cfg.TEST.DETECTIONS_PER_IMG,
            )
            return boxes[keep], scores[keep], labels[keep]

        # vote merge per class (bbox_aug_vote.py:139-177)
        merge_type = cfg.TEST.BBOX_AUG.MERGE_TYPE
        vote_th = cfg.TEST.BBOX_AUG.VOTE_TH
        out_b, out_s, out_l = [], [], []
        for j in np.unique(labels):
            sel = labels == j
            bj, sj = boxes[sel], scores[sel]
            if merge_type == "vote":
                vb, vs = bbox_vote(bj, sj, vote_th)
            elif merge_type == "soft-vote":
                vb, vs = soft_bbox_vote(
                    bj, sj, vote_th, cfg.MODEL.RETINANET.INFERENCE_TH
                )
            else:  # plain nms
                keep = np_greedy_ml_nms(
                    bj, sj, np.zeros(len(sj)), cfg.MODEL.ATSS.NMS_TH,
                    len(sj),
                )
                vb, vs = bj[keep], sj[keep]
            out_b.append(vb)
            out_s.append(vs)
            out_l.append(np.full(len(vs), j, dtype=np.int64))
        boxes = np.concatenate(out_b) if out_b else np.zeros((0, 4))
        scores = np.concatenate(out_s) if out_s else np.zeros((0,))
        labels = np.concatenate(out_l) if out_l else np.zeros((0,), np.int64)
        cap = cfg.MODEL.ATSS.PRE_NMS_TOP_N
        if len(scores) > cap:
            top = np.argsort(-scores, kind="stable")[:cap]
            boxes, scores, labels = boxes[top], scores[top], labels[top]
        return boxes, scores, labels


def inference_tta(cfg, model, dataset, output_folder=None, logger=None,
                  state=None):
    """Evaluate ``dataset`` with test-time augmentation (the
    TEST.BBOX_AUG.ENABLED path of the reference's compute_on_dataset,
    engine/inference.py:28-32): batches of TEST.IMS_PER_BATCH images in
    dataset order through ``TTAEngine``, then the COCO evaluator and the
    files of ``engine/inference.py::inference``. One process: under a
    process group of more than one rank it raises rather than evaluate
    the set once per rank."""
    if comm.get_world_size() > 1:
        raise NotImplementedError(
            "TEST.BBOX_AUG runs in one process; this process group has "
            f"{comm.get_world_size()} ranks")
    logger = logger or logging.getLogger("paa_tpu_torch.inference")
    engine = TTAEngine(cfg, model, state)
    batch_size = cfg.TEST.IMS_PER_BATCH

    predictions = {}
    t0 = time.perf_counter()
    for start in range(0, len(dataset.records), batch_size):
        idxs = range(start, min(start + batch_size, len(dataset.records)))
        merged = engine.detect_batch([dataset.load_image(i) for i in idxs])
        for i, (boxes, scores, labels) in zip(idxs, merged):
            xywh = np.stack(
                [
                    boxes[:, 0],
                    boxes[:, 1],
                    boxes[:, 2] - boxes[:, 0] + 1.0,
                    boxes[:, 3] - boxes[:, 1] + 1.0,
                ],
                axis=1,
            ) if len(boxes) else np.zeros((0, 4))
            predictions[dataset.records[i].id] = dict(
                boxes_xywh=xywh, scores=scores, labels=labels)
    if predictions:
        per_image = (time.perf_counter() - t0) / len(predictions)
        logger.info(f"TTA eval: {per_image:.3f} s/img")
    return evaluate_predictions(cfg, dataset, predictions, output_folder,
                                logger)

"""COCO-style bbox, segm and keypoints evaluation in numpy (port of
paa_tpu/evaluation/coco_eval.py).

pycocotools is not a dependency, so this follows the COCOeval protocol
itself (pycocotools/cocoeval.py semantics): 10 IoU thresholds
0.50:0.05:0.95, 101 recall points, maxDets [1, 10, 100], area ranges
all/small/medium/large, crowd GTs matched by "iof", greedy
per-threshold matching that prefers non-ignored GTs, and the standard
12-number summary. The IoU and the matching run in the native matcher
(csrc/cocoeval.cpp through evaluation/_native.py); ``_match_img_py`` is
its plain numpy version, which the tests hold it against.

The caller (engine/inference.py) rescales predictions to the original
image, converts them to xywh with the +1 convention (BoxList.convert)
and maps contiguous labels back to json category ids, as the
reference's do_coco_evaluation does
(paa_core/data/datasets/evaluation/coco/coco_eval.py:13-67). The segm
flavour takes each detection's mask as an RLE of the original image
(evaluation/mask_rle.py) and rasterizes the GT polygons at the image's
size; the mask IoUs (a crowd GT's as "iof": intersection over the
detection's area) go to the same native matcher. The keypoints flavour
(pycocotools' keypoint params: maxDets [20], areas all/medium/large)
scores each detection's (K, 3) keypoints against a GT by object
keypoint similarity (``oks_iou``), ignores GTs without labelled
keypoints, takes a detection's area from its keypoints' extent, matches
through the same native matcher and summarizes 10 numbers.

``evaluate_box_proposals`` scores the RPN-only model's proposals by
average recall (the reference's box_proposal table,
paa_core/data/datasets/evaluation/coco/coco_eval.py:189-300): each GT
of an area range, greedily matched to its best-covering proposal among
the first ``limit``, +1-convention IoU, recall averaged over the IoU
thresholds 0.5:0.05:0.95.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

from ..structures.keypoints import OKS_SIGMAS
from . import _native, mask_rle

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.00, 101)
MAX_DETS = (1, 10, 100)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}

METRICS = (
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
)


def oks_iou(dt_kps, gts):
    """pycocotools computeOks: the object keypoint similarity of each
    (detection, GT) pair, (n_dt, n_gt) float64.

    dt_kps (n_dt, K, 3) (x, y, score); gts: annotation dicts with
    'keypoints' (flat 3K list, absent: all 0), 'bbox' (xywh) and
    'area'. A GT with visible keypoints compares those; one without
    measures each detected point's distance to the GT box grown by its
    size on every side."""
    n_d, n_g = len(dt_kps), len(gts)
    out = np.zeros((n_d, n_g))
    if not n_d or not n_g:
        return out
    variances = (2 * OKS_SIGMAS) ** 2
    k = len(OKS_SIGMAS)
    xd = np.asarray(dt_kps, dtype=np.float64)[:, :, 0]
    yd = np.asarray(dt_kps, dtype=np.float64)[:, :, 1]
    for j, g in enumerate(gts):
        gkp = np.asarray(g.get("keypoints") or [0.0] * (3 * k),
                         dtype=np.float64).reshape(-1, 3)
        xg, yg, vg = gkp[:, 0], gkp[:, 1], gkp[:, 2]
        bx, by, bw, bh = g["bbox"]
        if (vg > 0).any():
            dx, dy = xd - xg, yd - yg
        else:
            dx = (np.maximum(0, bx - bw - xd)
                  + np.maximum(0, xd - (bx + bw * 2)))
            dy = (np.maximum(0, by - bh - yd)
                  + np.maximum(0, yd - (by + bh * 2)))
        e = (dx ** 2 + dy ** 2) / variances / (
            g.get("area", bw * bh) + np.spacing(1)) / 2
        if (vg > 0).any():
            e = e[:, vg > 0]
        out[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
    return out


def _match_img_py(ious, g_ig, g_crowd, dt_out_of_range):
    """The plain numpy version of the native per-image greedy matching
    (csrc/cocoeval.cpp ``evaluate_img``)."""
    T = len(IOU_THRS)
    n_dt, n_gt = ious.shape
    dtm = np.full((T, n_dt), -1, dtype=np.int64)
    gtm = np.full((T, n_gt), -1, dtype=np.int64)
    dt_ig = np.zeros((T, n_dt), dtype=bool)
    for t, thr in enumerate(IOU_THRS):
        for di in range(n_dt):
            best = min(thr, 1 - 1e-10)
            m = -1
            for gi in range(n_gt):
                # already-matched non-crowd GTs are unavailable
                # (crowd GTs may match many detections)
                if gtm[t, gi] >= 0 and not g_crowd[gi]:
                    continue
                if m > -1 and not g_ig[m] and g_ig[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m == -1:
                dt_ig[t, di] = dt_out_of_range[di]
                continue
            dt_ig[t, di] = g_ig[m]
            dtm[t, di] = m
            gtm[t, m] = di
    return dtm, dt_ig


class COCOEvaluator:
    """Evaluates bbox, segm or keypoints detections against COCO-style
    ground truth.

    gt_by_image: image_id -> list of annotation dicts with keys bbox
    (xywh), category_id (json id), iscrowd, area, optional ignore, for
    segm ``segmentation`` (polygons, or an uncompressed RLE) and for
    keypoints ``keypoints`` and ``num_keypoints``. iou_type "segm"
    compares masks: the detections carry ``masks_rle`` and
    ``image_sizes`` maps each image id to its (h, w); "keypoints"
    compares the detections' ``keypoints`` (n, K, 3) by OKS.
    """

    def __init__(self, gt_by_image: Dict[int, list], cat_ids: List[int],
                 image_ids: List[int], iou_type: str = "bbox",
                 image_sizes: Dict[int, tuple] = None):
        if iou_type not in ("bbox", "segm", "keypoints"):
            raise ValueError(f"iou_type {iou_type!r}: bbox, segm or "
                             f"keypoints")
        self.iou_type = iou_type
        self.image_sizes = image_sizes or {}
        if iou_type == "keypoints":
            # pycocotools' keypoint params: maxDets [20], no small range
            self.max_dets = (20,)
            self.area_rngs = {k: AREA_RNGS[k]
                              for k in ("all", "medium", "large")}
        else:
            self.max_dets = MAX_DETS
            self.area_rngs = AREA_RNGS
        self.cat_ids = list(cat_ids)
        self.image_ids = list(image_ids)
        self._gt = {}
        for img_id in self.image_ids:
            by_cat = defaultdict(list)
            for a in gt_by_image.get(img_id, []):
                by_cat[a["category_id"]].append(a)
            self._gt[img_id] = by_cat

    def _image_eval(self, img_id, cat_id, detections, max_det):
        """Scores, IoUs and GT flags of one (image, category), or None
        when it has neither GTs nor detections."""
        gts = self._gt[img_id].get(cat_id, [])
        det = detections.get(img_id)
        segm = self.iou_type == "segm"
        kps = self.iou_type == "keypoints"
        dt_rles, dt_kps = [], np.zeros((0, len(OKS_SIGMAS), 3))
        if det is None:
            dt_boxes, dt_scores = np.zeros((0, 4)), np.zeros((0,))
        else:
            sel = np.asarray(det["category_ids"]) == cat_id
            dt_boxes = np.asarray(det["boxes_xywh"])[sel]
            dt_scores = np.asarray(det["scores"])[sel]
            if segm:
                dt_rles = [det["masks_rle"][i] for i in np.nonzero(sel)[0]]
            if kps:
                dt_kps = np.asarray(det["keypoints"])[sel]
        if len(gts) == 0 and len(dt_scores) == 0:
            return None
        order = np.argsort(-dt_scores, kind="mergesort")[:max_det]
        dt_boxes, dt_scores = dt_boxes[order], dt_scores[order]
        g_boxes = np.asarray([g["bbox"] for g in gts]).reshape(-1, 4)
        g_crowd = np.asarray([int(g.get("iscrowd", 0)) for g in gts],
                             dtype=bool)
        # the keypoints flavour also ignores GTs without labelled
        # keypoints (pycocotools _prepare)
        g_ignore_base = np.asarray(
            [bool(g.get("ignore", 0)) or bool(g.get("iscrowd", 0))
             or (kps and int(g.get("num_keypoints", 0)) == 0)
             for g in gts], dtype=bool)
        g_area = np.asarray(
            [g.get("area", g["bbox"][2] * g["bbox"][3]) for g in gts],
            dtype=np.float64)
        if segm:
            gh, gw = self.image_sizes.get(img_id, (0, 0))
            dt_rles = [dt_rles[i] for i in order]
            ious = mask_rle.iou(
                dt_rles, [mask_rle.polygons_to_rle(g["segmentation"], gh, gw)
                          for g in gts], g_crowd)
            dt_area = np.asarray([mask_rle.area(r) for r in dt_rles],
                                 dtype=np.float64)
        elif kps:
            dt_kps = dt_kps[order]
            ious = oks_iou(dt_kps, gts)
            # pycocotools loadRes: a detection's area is its keypoints'
            # extent
            xs, ys = dt_kps[..., 0], dt_kps[..., 1]
            dt_area = ((xs.max(1) - xs.min(1)) * (ys.max(1) - ys.min(1))
                       if len(dt_kps) else np.zeros((0,)))
        else:
            ious = _native.bbox_iou_xywh(dt_boxes, g_boxes, g_crowd)
            dt_area = dt_boxes[:, 2] * dt_boxes[:, 3]
        return dict(
            scores=dt_scores, ious=ious, g_ignore_base=g_ignore_base,
            g_area=g_area, g_crowd=g_crowd, dt_area=dt_area,
        )

    def evaluate(self, detections: Dict[int, dict]):
        """detections: image_id -> dict(boxes_xywh (n, 4), scores (n,),
        category_ids (n,), and masks_rle or keypoints (n, K, 3) for
        their flavours). Returns the 12 standard metrics (the keypoints
        flavour: 10), each in [0, 1] or -1 where nothing is there to
        measure."""
        T = len(IOU_THRS)
        R = len(REC_THRS)
        K = len(self.cat_ids)
        A = len(self.area_rngs)
        M = len(self.max_dets)
        max_det = max(self.max_dets)

        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat_id in enumerate(self.cat_ids):
            per_image = [self._image_eval(img_id, cat_id, detections,
                                          max_det)
                         for img_id in self.image_ids]
            for a, (a_lo, a_hi) in enumerate(self.area_rngs.values()):
                # evaluateImg for every image at this area range
                img_evals = []
                for ev in per_image:
                    if ev is None:
                        continue
                    g_ig = ev["g_ignore_base"] | (
                        (ev["g_area"] < a_lo) | (ev["g_area"] > a_hi)
                    )
                    # gt order: non-ignored first (pycocotools sorts by
                    # ignore flag)
                    g_order = np.argsort(g_ig, kind="mergesort")
                    ious = ev["ious"][:, g_order]
                    g_ig_s = g_ig[g_order]
                    out_of_rng = (
                        (ev["dt_area"] < a_lo) | (ev["dt_area"] > a_hi)
                    )
                    dtm, dt_ig = _native.evaluate_img(
                        ious, g_ig_s, ev["g_crowd"][g_order], out_of_rng,
                        IOU_THRS)
                    img_evals.append(dict(
                        scores=ev["scores"], dtm=dtm, dt_ig=dt_ig,
                        n_ig=int(g_ig_s.sum()), n_gt=ious.shape[1]))

                for m, md in enumerate(self.max_dets):
                    npig = sum(ie["n_gt"] - ie["n_ig"] for ie in img_evals)
                    if npig == 0:
                        continue
                    if img_evals:
                        scores_cat = np.concatenate(
                            [ie["scores"][:md] for ie in img_evals])
                        order = np.argsort(-scores_cat, kind="mergesort")
                        tps = np.concatenate(
                            [ie["dtm"][:, :md] >= 0 for ie in img_evals],
                            axis=1)[:, order]
                        ig = np.concatenate(
                            [ie["dt_ig"][:, :md] for ie in img_evals],
                            axis=1)[:, order]
                    else:
                        tps = np.zeros((T, 0), dtype=bool)
                        ig = np.zeros((T, 0), dtype=bool)

                    tp_sum = np.cumsum((tps & ~ig).astype(np.float64), axis=1)
                    fp_sum = np.cumsum((~tps & ~ig).astype(np.float64),
                                       axis=1)
                    for t in range(T):
                        tp_c, fp_c = tp_sum[t], fp_sum[t]
                        nd = len(tp_c)
                        rc = tp_c / npig
                        pr = tp_c / np.maximum(tp_c + fp_c, np.finfo(
                            np.float64).eps)
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # monotone-from-right precision envelope
                        q = np.zeros(R)
                        if nd:
                            pr = pr.tolist()
                            for i in range(nd - 1, 0, -1):
                                if pr[i] > pr[i - 1]:
                                    pr[i - 1] = pr[i]
                            inds = np.searchsorted(rc, REC_THRS, side="left")
                            for ri, pi in enumerate(inds):
                                if pi < nd:
                                    q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall
        return self.summarize()

    def _summ(self, ap, iou_thr=None, area="all", max_det=None):
        if max_det is None:
            max_det = max(self.max_dets)
        a = list(self.area_rngs.keys()).index(area)
        m = self.max_dets.index(max_det)
        s = self.precision[:, :, :, a, m] if ap else self.recall[:, :, a, m]
        if iou_thr is not None:
            s = s[np.where(np.isclose(IOU_THRS, iou_thr))[0]]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self):
        if self.iou_type == "keypoints":
            return {
                "AP": self._summ(True),
                "AP50": self._summ(True, iou_thr=0.5),
                "AP75": self._summ(True, iou_thr=0.75),
                "APm": self._summ(True, area="medium"),
                "APl": self._summ(True, area="large"),
                "AR": self._summ(False),
                "AR50": self._summ(False, iou_thr=0.5),
                "AR75": self._summ(False, iou_thr=0.75),
                "ARm": self._summ(False, area="medium"),
                "ARl": self._summ(False, area="large"),
            }
        return {
            "AP": self._summ(True),
            "AP50": self._summ(True, iou_thr=0.5),
            "AP75": self._summ(True, iou_thr=0.75),
            "APs": self._summ(True, area="small"),
            "APm": self._summ(True, area="medium"),
            "APl": self._summ(True, area="large"),
            "AR1": self._summ(False, max_det=1),
            "AR10": self._summ(False, max_det=10),
            "AR100": self._summ(False, max_det=100),
            "ARs": self._summ(False, area="small"),
            "ARm": self._summ(False, area="medium"),
            "ARl": self._summ(False, area="large"),
        }


def check_expected_results(results, expected_results, sigma_tol,
                           logger=None):
    """Regression assertion (reference coco_eval.py:403-422): each entry
    (task, metric, mean, std) must satisfy |actual - mean| <
    sigma_tol * std. Raises AssertionError otherwise. 'bbox' entries are
    the top-level metrics, another task's are under "task/metric"; an
    entry with no result is skipped with a warning."""
    for task, metric, mean, std in expected_results:
        key = metric if task == "bbox" else f"{task}/{metric}"
        if key not in results:
            if logger:
                logger.warning(f"no result for {task}/{metric}; skipping")
            continue
        actual = results[key]
        lo = mean - sigma_tol * std
        hi = mean + sigma_tol * std
        ok = lo < actual < hi
        msg = (
            f"{task}/{metric} = {actual:.4f}; expected {mean:.4f} "
            f"+/- {sigma_tol}*{std:.4f} -> ({lo:.4f}, {hi:.4f}): "
            f"{'OK' if ok else 'FAILED'}"
        )
        if logger:
            (logger.info if ok else logger.error)(msg)
        assert ok, msg


def format_results(results, task="bbox"):
    """COCOResults-style table (reference coco_eval.py:358-402)."""
    lines = [f"Task: {task}"]
    for k in METRICS:
        if k in results:
            lines.append(f"{k}: {results[k]:.4f}")
    for k in results:
        if k not in METRICS and "/" not in k:
            lines.append(f"{k}: {results[k]:.4f}")
    return "\n".join(lines)


# the box_proposal table's area ranges (the reference's, in px^2)
PROPOSAL_AREAS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
# the box_proposal table: (metric suffix, area) at each proposal limit
PROPOSAL_LIMITS = (100, 1000)
PROPOSAL_METRICS = (("", "all"), ("s", "small"), ("m", "medium"),
                    ("l", "large"))


def evaluate_box_proposals(proposals, gt_by_image, image_ids,
                           thresholds=None, area="all", limit=None):
    """Proposal recall of one area range and limit.

    proposals: {image id: {"boxes": (n, 4) xyxy in original-image
    coordinates, in pick order (descending objectness)}}; gt_by_image:
    {image id: [annotation dict with "bbox" xywh, "area", "iscrowd"]}.
    Crowd GTs are left out; a GT's area is its annotation's "area" (its
    box's w * h without one). Each image's first ``limit`` proposals
    cover its GTs greedily: the GT with the best-covering proposal
    takes it, both leave, repeated min(proposals, GTs) times. Returns
    {"ar", "recalls" (per threshold), "thresholds", "num_pos"}."""
    lo, hi = PROPOSAL_AREAS[area]
    gt_overlaps = []
    num_pos = 0
    for img_id in image_ids:
        anns = [a for a in gt_by_image.get(img_id, [])
                if not a.get("iscrowd", 0)]
        if not anns:
            continue
        g_xywh = np.asarray([a["bbox"] for a in anns], np.float64)
        g_areas = np.asarray([a.get("area", b[2] * b[3])
                              for a, b in zip(anns, g_xywh)])
        keep = (g_areas >= lo) & (g_areas <= hi)
        gt = np.stack([g_xywh[:, 0], g_xywh[:, 1],
                       g_xywh[:, 0] + g_xywh[:, 2] - 1.0,
                       g_xywh[:, 1] + g_xywh[:, 3] - 1.0], axis=1)[keep]
        num_pos += len(gt)
        if not len(gt):
            continue
        pred = proposals.get(img_id)
        if pred is None or not len(pred["boxes"]):
            continue
        boxes = np.asarray(pred["boxes"], np.float64)[:limit]
        a1 = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
        a2 = (gt[:, 2] - gt[:, 0] + 1) * (gt[:, 3] - gt[:, 1] + 1)
        lt = np.maximum(boxes[:, None, :2], gt[None, :, :2])
        rb = np.minimum(boxes[:, None, 2:], gt[None, :, 2:])
        wh = np.clip(rb - lt + 1, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        overlaps = inter / (a1[:, None] + a2[None, :] - inter)
        covered = np.zeros(len(gt))
        for j in range(min(len(boxes), len(gt))):
            gi = int(overlaps.max(axis=0).argmax())
            bi = int(overlaps[:, gi].argmax())
            covered[j] = overlaps[bi, gi]
            overlaps[bi, :] = -1
            overlaps[:, gi] = -1
        gt_overlaps.append(covered)
    gt_overlaps = (np.sort(np.concatenate(gt_overlaps)) if gt_overlaps
                   else np.zeros((0,)))
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    recalls = np.asarray([(gt_overlaps >= t).sum() / max(num_pos, 1)
                          for t in thresholds])
    return {"ar": float(recalls.mean()), "recalls": recalls,
            "thresholds": thresholds, "num_pos": num_pos}


def box_proposal_table(proposals, gt_by_image, image_ids):
    """The reference's box_proposal table: {"AR@100", "ARs@100", ...,
    "ARl@1000"}, ``evaluate_box_proposals`` at each PROPOSAL_LIMITS and
    area."""
    return {f"AR{suffix}@{limit}": evaluate_box_proposals(
        proposals, gt_by_image, image_ids, area=area, limit=limit)["ar"]
        for limit in PROPOSAL_LIMITS for suffix, area in PROPOSAL_METRICS}

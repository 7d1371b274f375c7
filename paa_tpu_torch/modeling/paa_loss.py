"""PAA training loss with the probabilistic anchor assignment on the
device (port of paa_tpu/modeling/paa_loss.py; reference
paa_core/modeling/rpn/paa/loss.py).

1. IoU pre-assignment at IOU_THRESHOLD through the batched matcher
   (loss.py:89-126).
2. Detached per-anchor scores: focal cls loss + GIoU reg loss, INF for
   unmatched anchors (loss.py:292-306).
3. Candidates (loss.py:154-178): per (image, GT, level) the TOPK
   lowest-score anchors matched to that GT, by k argmin passes.
4. GMM split (loss.py:187-230): one batched fixed-iteration EM over the
   (B, G, L*K) candidate scores (ops/gmm.py). The positives are the
   sorted positions up to the foreground component's best-scoring one;
   all candidates when the foreground is empty; position 0 for a GT with
   one candidate. Candidate sets of different GTs are disjoint (each
   anchor has one matched GT), so the per-GT writes scatter in one pass.
5. Losses (loss.py:317-359): focal cls over all anchors over the
   positive count, IoU-weighted GIoU over the IoU sum, BCE on the IoU
   branch. Under a process group (utils/comm.py) each rank holds its
   share of the batch: the positive count and the IoU sum are summed
   over the ranks (detached), and each rank divides by max(total,
   world) / world and sum_iou / world, as the reference does per GPU
   (loss.py:22-28, 317-322); DDP's gradient mean then gives the global
   batch's step, the same for any world size when total >= world. One
   process divides by max(total, 1) and sum_iou.

The integer outputs equal the JAX package's: ``torch.argmin`` and
``torch.argmax`` take the first index on ties, as ``jnp``'s do, and the
candidate sort is stable, as ``jnp.argsort`` is.

Each stage runs inside a ``torch.profiler.record_function`` span
(``paa_loss/...``), which costs nothing measurable without a profiler.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.focal_loss import sigmoid_focal_loss
from ..ops.gmm import gmm_fit_predict
from ..structures.boxes import box_iou, box_iou_aligned
from ..utils import comm
from .box_coder import decode_box, encode_box
from .matcher import match_anchors

INF = 1e8
# the spans of a train step that tools/profile_train_step.py reads; the
# benchmark's train.assignment_ms reads the first (the GMM's host reads
# in it open sync/gmm_converged)
SPAN_ASSIGN = "paa_loss/assignment"
SPAN_LOSSES = "paa_loss/losses"


@dataclass(frozen=True)
class PAALossConfig:
    gamma: float = 2.0
    alpha: float = 0.25
    iou_threshold: float = 0.1
    topk: int = 9
    reg_loss_weight: float = 1.3
    iou_loss_weight: float = 0.5
    use_iou_pred: bool = True
    gmm_iters: int = 64

    @staticmethod
    def from_cfg(cfg):
        return PAALossConfig(
            gamma=cfg.MODEL.PAA.LOSS_GAMMA,
            alpha=cfg.MODEL.PAA.LOSS_ALPHA,
            iou_threshold=cfg.MODEL.PAA.IOU_THRESHOLD,
            topk=cfg.MODEL.PAA.TOPK,
            reg_loss_weight=cfg.MODEL.PAA.REG_LOSS_WEIGHT,
            iou_loss_weight=cfg.MODEL.PAA.IOU_LOSS_WEIGHT,
            use_iou_pred=cfg.MODEL.PAA.USE_IOU_PRED,
            gmm_iters=cfg.TPU.GMM_ITERS,
        )


def giou_loss(pred_deltas, target_deltas, anchors):
    """GIoU loss on decoded boxes (reference GIoULoss, loss.py:46-87),
    with NO +1 in the areas, as the reference."""
    pred = decode_box(pred_deltas, anchors)
    px1, py1 = pred[..., 0], pred[..., 1]
    px2 = torch.maximum(px1, pred[..., 2])
    py2 = torch.maximum(py1, pred[..., 3])
    pred_area = (px2 - px1) * (py2 - py1)

    gt = decode_box(target_deltas, anchors)
    gx1, gy1, gx2, gy2 = gt.unbind(-1)
    target_area = (gx2 - gx1) * (gy2 - gy1)

    x1i = torch.maximum(px1, gx1)
    y1i = torch.maximum(py1, gy1)
    x2i = torch.minimum(px2, gx2)
    y2i = torch.minimum(py2, gy2)
    inter_mask = (y2i > y1i) & (x2i > x1i)
    area_inter = torch.where(inter_mask, (x2i - x1i) * (y2i - y1i),
                             torch.zeros((), device=pred.device))

    x1e = torch.minimum(px1, gx1)
    y1e = torch.minimum(py1, gy1)
    x2e = torch.maximum(px2, gx2)
    y2e = torch.maximum(py2, gy2)
    area_enclosing = (x2e - x1e) * (y2e - y1e) + 1e-7

    area_union = pred_area + target_area - area_inter + 1e-7
    ious = area_inter / area_union
    gious = ious - (area_enclosing - area_union) / area_enclosing
    return 1.0 - gious


def bce_with_logits(logits, targets):
    """Elementwise BCEWithLogits: -(t log sig(x) + (1-t) log sig(-x))."""
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def bottom_k_iterative(x, k):
    """The k smallest entries along the last axis, ascending, by k
    argmin passes (first index on ties, like the JAX package's; not
    ``torch.topk``, whose order on ties is unspecified). Returns
    (values, indices int64)."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = x.argmin(dim=-1, keepdim=True)
        vals.append(x.gather(-1, i))
        idxs.append(i)
        x.scatter_(-1, i, float("inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _select_candidates(combined_loss, matched_idx, iou_labels,
                       level_counts, num_gt, topk):
    """Per (image, GT, level) the ``topk`` lowest-loss anchors matched to
    that GT (loss.py:154-178). Returns cand_idx (B, G, L*topk) int64
    anchor indices and cand_valid (B, G, L*topk) bool."""
    gt_range = torch.arange(num_gt, device=combined_loss.device)
    idx_chunks, valid_chunks = [], []
    start = 0
    for count in level_counts:
        loss_l = combined_loss[:, start:start + count]
        matched_l = matched_idx[:, start:start + count]
        labels_l = iou_labels[:, start:start + count]
        eligible = ((matched_l[:, None, :] == gt_range[None, :, None])
                    & (labels_l[:, None, :] > 0))  # (B, G, n)
        masked = torch.where(eligible, loss_l[:, None, :],
                             torch.full((), INF, device=loss_l.device))
        _, idx = bottom_k_iterative(masked, min(topk, count))
        valid_chunks.append(eligible.gather(-1, idx))
        idx_chunks.append(idx + start)
        start += count
    return torch.cat(idx_chunks, dim=-1), torch.cat(valid_chunks, dim=-1)


def _paa_positive_mask(combined_loss, cand_idx, cand_valid, gmm_iters):
    """GMM fit and positive/negative split; returns the positive anchors
    (B, N) bool."""
    bsz, num_gt, k = cand_idx.shape
    num_anchors = combined_loss.shape[1]

    cand_loss = combined_loss.gather(1, cand_idx.reshape(bsz, -1)).reshape(
        bsz, num_gt, k)
    cand_loss = torch.where(cand_valid, cand_loss,
                            torch.full((), INF, device=cand_loss.device))

    # ascending and stable; invalid (INF) last (loss.py:191)
    sorted_loss, order = torch.sort(cand_loss, dim=-1, stable=True)
    sorted_idx = cand_idx.gather(-1, order)
    sorted_valid = cand_valid.gather(-1, order)

    components, scores = gmm_fit_predict(sorted_loss, sorted_valid,
                                         num_iters=gmm_iters)
    fgs = (components == 0) & sorted_valid
    fg_any = fgs.any(dim=-1)

    fg_scores = torch.where(fgs, scores,
                            torch.full((), -1e30, device=scores.device))
    fg_max_score = fg_scores.amax(dim=-1, keepdim=True)
    is_fg_max = fgs & (scores == fg_max_score)
    # the first maximum (loss.py:211)
    fg_max_idx = is_fg_max.to(torch.uint8).argmax(dim=-1)

    positions = torch.arange(k, device=cand_idx.device)
    n_valid = sorted_valid.sum(dim=-1)
    pos_multi = torch.where(
        fg_any[:, :, None],
        positions[None, None, :] <= fg_max_idx[:, :, None],
        sorted_valid,  # no foreground component: all positive (:214-217)
    )
    pos_single = positions[None, None, :] == 0  # one candidate (:218-221)
    pos_sorted = torch.where((n_valid > 1)[:, :, None], pos_multi,
                             pos_single) & sorted_valid

    # scatter to anchors: the candidate sets are disjoint across GTs, and
    # every write is True; non-positive slots go to a spare column N, so
    # none of them can clear a positive
    flat_idx = torch.where(pos_sorted, sorted_idx,
                           torch.full((), num_anchors,
                                      device=sorted_idx.device))
    pos_anchor = torch.zeros(bsz, num_anchors + 1, dtype=torch.bool,
                             device=cand_idx.device)
    pos_anchor.scatter_(1, flat_idx.reshape(bsz, -1), True)
    return pos_anchor[:, :num_anchors]


def paa_loss(outputs, gt_boxes, gt_labels, anchors, level_counts, lc,
             return_aux=False):
    """The PAA losses of one batch.

    outputs: 'cls_logits' (B, N, C), 'box_regression' (B, N, 4) and
    optionally 'iou_pred' (B, N); gt_boxes (B, G, 4) float32 xyxy,
    padded; gt_labels (B, G) int, 1..C, 0 for padding; anchors (N, 4);
    level_counts: per-level anchor counts; lc: PAALossConfig.

    Returns {loss_cls, loss_reg, loss_iou_pred, num_pos}, and with
    ``return_aux`` also {labels_paa, pos_mask, combined_loss, iou_labels}.
    """
    cls_logits = outputs["cls_logits"].to(torch.float32)
    box_regression = outputs["box_regression"].to(torch.float32)
    iou_pred = outputs.get("iou_pred")
    if iou_pred is not None:
        iou_pred = iou_pred.to(torch.float32)
    gt_boxes = gt_boxes.to(torch.float32)
    gt_valid = gt_labels > 0
    anchors = anchors.to(torch.float32)

    with record_function(SPAN_ASSIGN):
        # 1. IoU pre-assignment
        iou = box_iou(gt_boxes, anchors[None])  # (B, G, N)
        matched = match_anchors(iou, gt_valid, lc.iou_threshold,
                                lc.iou_threshold)
        matched_clamped = matched.clamp(min=0).long()
        matched_labels = gt_labels.gather(1, matched_clamped)
        iou_labels = torch.where(
            matched >= 0, matched_labels,
            torch.where(matched == -2, -1, 0).to(matched_labels.dtype),
        ).to(torch.int32)
        matched_boxes = gt_boxes.gather(
            1, matched_clamped[:, :, None].expand(-1, -1, 4))
        reg_targets_iou = encode_box(matched_boxes, anchors[None])

        # 2. detached anchor scores
        score_cls = sigmoid_focal_loss(cls_logits.detach(), iou_labels,
                                       lc.gamma, lc.alpha).sum(-1)
        score_reg = giou_loss(box_regression.detach(), reg_targets_iou,
                              anchors[None])
        combined_loss = score_cls + torch.where(
            iou_labels > 0, score_reg,
            torch.full((), INF, device=score_reg.device))

        # 3 + 4. candidates and the GMM split
        cand_idx, cand_valid = _select_candidates(
            combined_loss, matched, iou_labels, level_counts,
            gt_boxes.shape[1], lc.topk)
        pos_mask = _paa_positive_mask(combined_loss, cand_idx, cand_valid,
                                      lc.gmm_iters)
        labels_paa = torch.where(pos_mask, matched_labels,
                                 torch.zeros_like(matched_labels)).to(
                                     torch.int32)

    with record_function(SPAN_LOSSES):
        # 5. losses
        world = comm.get_world_size()
        num_pos = comm.all_reduce_sum(pos_mask.sum())
        # max(total / num_gpus, 1) per GPU under gradient averaging is
        # the global denominator max(total, num_gpus)
        num_pos_norm = num_pos.to(torch.float32).clamp(
            min=float(world)) / world
        loss_cls = sigmoid_focal_loss(cls_logits, labels_paa, lc.gamma,
                                      lc.alpha).sum() / num_pos_norm

        posf = pos_mask.to(torch.float32)
        gt_decoded = decode_box(reg_targets_iou, anchors[None])
        pred_decoded = decode_box(box_regression.detach(), anchors[None])
        ious = box_iou_aligned(gt_decoded, pred_decoded)  # +1 convention

        out = {}
        if lc.use_iou_pred and iou_pred is not None:
            iou_bce = bce_with_logits(iou_pred, ious) * posf
            out["loss_iou_pred"] = (iou_bce.sum() / num_pos_norm
                                    * lc.iou_loss_weight)
            reg_norm = comm.all_reduce_sum(
                (ious * posf).sum()).clamp(min=1e-6) / world
            reg_weight = ious
        else:
            reg_norm = num_pos_norm
            reg_weight = torch.ones_like(ious)
        reg_giou = giou_loss(box_regression, reg_targets_iou, anchors[None])
        loss_reg = ((reg_giou * reg_weight * posf).sum() / reg_norm
                    * lc.reg_loss_weight)

    out["loss_cls"] = loss_cls
    out["loss_reg"] = loss_reg
    out["num_pos"] = num_pos
    if return_aux:
        return out, {"labels_paa": labels_paa, "pos_mask": pos_mask,
                     "combined_loss": combined_loss,
                     "iou_labels": iou_labels}
    return out

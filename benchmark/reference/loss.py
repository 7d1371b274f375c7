"""The plain PAA loss (the PAA paper's probabilistic anchor assignment;
paa_core's modeling/rpn/paa/loss.py), written per image batch in
float32:

1. IoU pre-assignment: each anchor's best GT if IoU >= IOU_THRESHOLD,
   plus every anchor that is some GT's best (ties included);
2. a detached score per anchor: focal cls loss + GIoU loss (INF where
   no GT is matched);
3. candidates: per (image, GT, level) the TOPK lowest-score anchors
   matched to that GT (ties to the lower index);
4. a two-component 1-D Gaussian mixture fitted by EM to each GT's
   sorted candidate scores (sklearn's GaussianMixture settings: means
   from min / max, unit variances, equal weights, reg_covar 1e-6, a
   row stops moving once its mean log-likelihood changes by less than
   1e-3); the positives run up to the foreground component's
   best-scoring candidate;
5. focal cls loss over all anchors / #positives, IoU-weighted GIoU /
   sum of IoUs, BCE of iou_pred against the IoU / #positives.

``assign`` and ``losses`` are split so that a batch can be computed in
blocks of images: the normalizers are the whole batch's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import aligned_iou, box_iou, decode, encode

INF = 1e8
LOG_2PI = 1.8378770664093453


def focal(logits, targets, gamma, alpha):
    """Elementwise sigmoid focal loss; targets 1..C positive, 0 negative,
    < 0 ignored."""
    c = logits.shape[-1]
    classes = torch.arange(1, c + 1, dtype=targets.dtype,
                           device=targets.device)
    t = targets[..., None]
    p = torch.sigmoid(logits)
    pos = (t == classes).float()
    neg = ((t != classes) & (t >= 0)).float()
    return (-pos * (1 - p) ** gamma * F.logsigmoid(logits) * alpha
            - neg * p ** gamma * F.logsigmoid(-logits) * (1 - alpha))


def giou_loss(pred_d, target_d, anchors):
    """1 - GIoU of the decoded boxes (areas without the +1)."""
    p = decode(pred_d, anchors)
    px1, py1 = p[..., 0], p[..., 1]
    px2 = torch.maximum(px1, p[..., 2])
    py2 = torch.maximum(py1, p[..., 3])
    g = decode(target_d, anchors)
    gx1, gy1, gx2, gy2 = g.unbind(-1)
    pa = (px2 - px1) * (py2 - py1)
    ga = (gx2 - gx1) * (gy2 - gy1)
    ix1, iy1 = torch.maximum(px1, gx1), torch.maximum(py1, gy1)
    ix2, iy2 = torch.minimum(px2, gx2), torch.minimum(py2, gy2)
    inter = torch.where((iy2 > iy1) & (ix2 > ix1), (ix2 - ix1) * (iy2 - iy1),
                        torch.zeros((), device=p.device))
    enc = ((torch.maximum(px2, gx2) - torch.minimum(px1, gx1))
           * (torch.maximum(py2, gy2) - torch.minimum(py1, gy1)) + 1e-7)
    union = pa + ga - inter + 1e-7
    return 1.0 - (inter / union - (enc - union) / enc)


def match(iou, gt_valid, threshold):
    """(B, G, N) IoUs -> (B, N) matched GT index, or -1."""
    iou = torch.where(gt_valid[:, :, None], iou, -1.0)
    best, idx = iou.max(dim=1)
    m = torch.where(best >= threshold, idx, -1)
    is_best = (iou == iou.amax(dim=2, keepdim=True)) & gt_valid[:, :, None]
    m = torch.where(is_best.any(dim=1), idx, m)
    return torch.where(gt_valid.any(dim=1)[:, None], m, -1)


def gmm(values, valid, iters):
    """EM of a two-component mixture on each row's valid entries.
    Returns (component (0: the low mean), score_samples) per entry."""
    vf = valid.float()
    n = vf.sum(-1).clamp(min=1.0)
    vmin = torch.where(valid, values, 1e30).amin(-1)
    vmax = torch.where(valid, values, -1e30).amax(-1)
    anyv = valid.any(-1)
    vmin = torch.where(anyv, vmin, 0.0)
    vmax = torch.where(anyv, vmax, 1.0)
    means = torch.stack([vmin, vmax], -1)
    var = torch.ones_like(means)
    wts = torch.full_like(means, 0.5)
    prev = torch.full(n.shape, -float("inf"), device=values.device)
    done = torch.zeros(n.shape, dtype=torch.bool, device=values.device)

    def logp(m, v, w):
        d = values[..., :, None] - m[..., None, :]
        return (-0.5 * (d * d / v[..., None, :] + torch.log(v[..., None, :])
                        + LOG_2PI) + torch.log(w[..., None, :]))

    for _ in range(iters):
        lp = logp(means, var, wts)
        lb = (torch.logsumexp(lp, -1) * vf).sum(-1) / n
        resp = torch.softmax(lp, -1) * vf[..., :, None]
        nk = resp.sum(-2) + 1e-12
        nm = (resp * values[..., :, None]).sum(-2) / nk
        d = values[..., :, None] - nm[..., None, :]
        nv = (resp * d * d).sum(-2) / nk + 1e-6
        upd = (~done)[..., None]
        means = torch.where(upd, nm, means)
        var = torch.where(upd, nv, var)
        wts = torch.where(upd, nk / n[..., None], wts)
        new_prev = torch.where(done, prev, lb)
        done = done | ((lb - prev).abs() < 1e-3)
        prev = new_prev
    lp = logp(means, var, wts)
    return lp.argmax(-1), torch.logsumexp(lp, -1)


def positives(combined, matched, iou_labels, counts, num_gt, topk, iters):
    """(B, N) bool: the anchors the mixture assigns to their GT."""
    b, n = combined.shape
    dev = combined.device
    gts = torch.arange(num_gt, device=dev)
    idx_parts, ok_parts, start = [], [], 0
    for count in counts:
        sl = slice(start, start + count)
        elig = (matched[:, None, sl] == gts[None, :, None]) \
            & (iou_labels[:, None, sl] > 0)
        masked = torch.where(elig, combined[:, None, sl], INF)
        order = torch.sort(masked, dim=-1, stable=True).indices
        idx = order[..., :min(topk, count)]
        ok_parts.append(elig.gather(-1, idx))
        idx_parts.append(idx + start)
        start += count
    cand = torch.cat(idx_parts, -1)
    ok = torch.cat(ok_parts, -1)
    k = cand.shape[-1]
    loss = combined.gather(1, cand.reshape(b, -1)).reshape(b, num_gt, k)
    loss = torch.where(ok, loss, INF)
    sloss, order = torch.sort(loss, dim=-1, stable=True)
    sidx, sok = cand.gather(-1, order), ok.gather(-1, order)
    comp, score = gmm(sloss, sok, iters)
    fg = (comp == 0) & sok
    fg_score = torch.where(fg, score, -1e30)
    first_max = (fg & (score == fg_score.amax(-1, keepdim=True))).byte() \
        .argmax(-1)
    pos_at = torch.arange(k, device=dev)
    multi = torch.where(fg.any(-1)[..., None],
                        pos_at <= first_max[..., None], sok)
    pos = torch.where((sok.sum(-1) > 1)[..., None], multi, pos_at == 0) & sok
    out = torch.zeros(b, n + 1, dtype=torch.bool, device=dev)
    out.scatter_(1, torch.where(pos, sidx, n).reshape(b, -1), True)
    return out[:, :n]


def assign(out, gt_boxes, gt_labels, anchors, counts, lc):
    """The assignment of a block of images from its head outputs
    (detached): positives, their labels and regression targets, the
    IoU of each anchor's decoded prediction with its target."""
    cls = out["cls_logits"].detach().float()
    reg = out["box_regression"].detach().float()
    gt_boxes, anchors = gt_boxes.float(), anchors.float()
    valid = gt_labels > 0
    matched = match(box_iou(gt_boxes, anchors[None]), valid,
                    lc["iou_threshold"])
    mc = matched.clamp(min=0).long()
    mlabels = gt_labels.gather(1, mc)
    iou_labels = torch.where(matched >= 0, mlabels, 0)
    targets = encode(gt_boxes.gather(1, mc[..., None].expand(-1, -1, 4)),
                     anchors[None])
    score = focal(cls, iou_labels, lc["gamma"], lc["alpha"]).sum(-1)
    score = score + torch.where(iou_labels > 0,
                                giou_loss(reg, targets, anchors[None]), INF)
    pos = positives(score, matched, iou_labels, counts, gt_boxes.shape[1],
                    lc["topk"], lc["gmm_iters"])
    ious = aligned_iou(decode(targets, anchors[None]),
                       decode(reg, anchors[None]))
    return {"pos": pos, "labels": torch.where(pos, mlabels, 0),
            "targets": targets, "ious": ious,
            "num_pos": pos.sum(), "iou_sum": (ious * pos.float()).sum()}


def losses(out, a, anchors, lc, num_pos, iou_sum):
    """The block's share of the batch's three losses, over the whole
    batch's normalizers max(#positives, 1) and max(sum of IoUs, 1e-6)."""
    cls = out["cls_logits"].float()
    reg = out["box_regression"].float()
    iou = out["iou_pred"].float()
    posf = a["pos"].float()
    npos = max(float(num_pos), 1.0)
    l_cls = focal(cls, a["labels"], lc["gamma"], lc["alpha"]).sum() / npos
    bce = -(a["ious"] * F.logsigmoid(iou) + (1 - a["ious"])
            * F.logsigmoid(-iou))
    l_iou = (bce * posf).sum() / npos * lc["iou_loss_weight"]
    g = giou_loss(reg, a["targets"], anchors[None].float())
    l_reg = ((g * a["ious"] * posf).sum() / max(float(iou_sum), 1e-6)
             * lc["reg_loss_weight"])
    return {"loss_cls": l_cls, "loss_reg": l_reg, "loss_iou_pred": l_iou}

"""FCOS training loss (port of paa_tpu/modeling/fcos_loss.py; reference
paa_core/modeling/rpn/fcos/loss.py), batched on the device.

- Per location, the l/t/r/b distances to every GT (loss.py:150-163).
- A location is positive for a GT when it lies inside it (strictly; or,
  with CENTER_SAMPLING_RADIUS > 0, inside the GT's box of that many
  strides about its centre, clipped to the GT, loss.py:54-103) and its
  largest distance is within the level's size range ([-1, 64], [64,
  128], ..., [512, INF], loss.py:105-111). Conflicts go to the smallest
  GT (+1 areas, the first on ties; loss.py:184-189).
- NORM_REG_TARGETS divides the targets by the level's stride
  (loss.py:141-144).
- Losses (loss.py:241-282): focal over the positive count; IOULoss
  ('iou', 'linear_iou' or 'giou', layers/iou_loss.py) weighted by the
  centerness targets over their sum; the centerness BCE over the
  positive count. Under a process group both counts are summed over the
  ranks, as ``paa_loss`` does.

The two stages run inside ``record_function`` spans (``SPAN_ASSIGN``,
``SPAN_LOSSES``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..ops.focal_loss import sigmoid_focal_loss
from ..utils import comm
from .paa_loss import bce_with_logits

INF = 1e8
SPAN_ASSIGN = "fcos_loss/assignment"
SPAN_LOSSES = "fcos_loss/losses"
OBJECT_SIZES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


@dataclass(frozen=True)
class FCOSLossConfig:
    gamma: float = 2.0
    alpha: float = 0.25
    strides: tuple = (8, 16, 32, 64, 128)
    center_sampling_radius: float = 0.0
    iou_loss_type: str = "iou"
    norm_reg_targets: bool = False

    @staticmethod
    def from_cfg(cfg):
        f = cfg.MODEL.FCOS
        return FCOSLossConfig(
            gamma=f.LOSS_GAMMA,
            alpha=f.LOSS_ALPHA,
            strides=tuple(f.FPN_STRIDES),
            center_sampling_radius=f.CENTER_SAMPLING_RADIUS,
            iou_loss_type=f.IOU_LOSS_TYPE,
            norm_reg_targets=f.NORM_REG_TARGETS,
        )


def iou_loss_ltrb(pred, target, loss_type="iou"):
    """IOULoss on l/t/r/b distances (layers/iou_loss.py:12-45):
    -log(IoU), 1 - IoU or 1 - GIoU, with IoU = (inter + 1) / (union +
    1)."""
    tl, tt, tr, tb = target.unbind(-1)
    pl, pt, pr, pb = pred.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h + 1e-7
    area_inter = w_inter * h_inter
    area_union = target_area + pred_area - area_inter
    ious = (area_inter + 1.0) / (area_union + 1.0)
    if loss_type == "iou":
        return -torch.log(ious)
    if loss_type == "linear_iou":
        return 1 - ious
    if loss_type == "giou":
        return 1 - (ious - (ac_union - area_union) / ac_union)
    raise NotImplementedError(loss_type)


def _per_location(values, level_counts, device):
    """(N,) float32: each level's value repeated over its locations."""
    return torch.cat([torch.full((c,), float(v))
                      for c, v in zip(level_counts, values)]).to(device)


def fcos_assign(gt_boxes, gt_labels, locations, level_counts, lc):
    """gt_boxes (B, G, 4), gt_labels (B, G) (0 = padding), locations
    (N, 2). Returns labels (B, N) int32 (0 background) and reg_targets
    (B, N, 4), the l/t/r/b distances to the assigned GT in pixels."""
    gt_valid = gt_labels > 0
    dev = locations.device
    xs, ys = locations[:, 0], locations[:, 1]
    l = xs[None, :, None] - gt_boxes[:, None, :, 0]  # (B, N, G)
    t = ys[None, :, None] - gt_boxes[:, None, :, 1]
    r = gt_boxes[:, None, :, 2] - xs[None, :, None]
    b = gt_boxes[:, None, :, 3] - ys[None, :, None]
    reg = torch.stack([l, t, r, b], dim=-1)  # (B, N, G, 4)

    if lc.center_sampling_radius > 0:
        cx = (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2  # (B, G)
        cy = (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2
        rad = (_per_location(lc.strides, level_counts, dev)[None, :, None]
               * lc.center_sampling_radius)
        x0 = torch.maximum(cx[:, None, :] - rad, gt_boxes[:, None, :, 0])
        y0 = torch.maximum(cy[:, None, :] - rad, gt_boxes[:, None, :, 1])
        x1 = torch.minimum(cx[:, None, :] + rad, gt_boxes[:, None, :, 2])
        y1 = torch.minimum(cy[:, None, :] + rad, gt_boxes[:, None, :, 3])
        xx, yy = xs[None, :, None], ys[None, :, None]
        in_box = ((xx - x0 > 0) & (yy - y0 > 0) & (x1 - xx > 0)
                  & (y1 - yy > 0))
    else:
        in_box = reg.amin(dim=-1) > 0

    lo = _per_location([s[0] for s in OBJECT_SIZES], level_counts, dev)
    hi = _per_location([s[1] for s in OBJECT_SIZES], level_counts, dev)
    max_reg = reg.amax(dim=-1)
    cared = (max_reg >= lo[None, :, None]) & (max_reg <= hi[None, :, None])
    area = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0)
            * (gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0))  # (B, G)
    loc_area = torch.where(in_box & cared & gt_valid[:, None, :],
                           area[:, None, :], torch.full((), INF, device=dev))
    min_area, gt_idx = loc_area.min(dim=-1)  # the first GT on ties
    labels = torch.where(min_area < INF, gt_labels.gather(1, gt_idx),
                         torch.zeros((), dtype=gt_labels.dtype, device=dev))
    reg_targets = reg.gather(
        2, gt_idx[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
    return labels.to(torch.int32), reg_targets


def compute_centerness_targets_ltrb(reg_targets):
    lr, tb = reg_targets[..., 0::2], reg_targets[..., 1::2]
    c = ((lr.amin(-1) / lr.amax(-1)) * (tb.amin(-1) / tb.amax(-1)))
    return torch.sqrt(c.clamp(min=0.0))


def fcos_loss(outputs, gt_boxes, gt_labels, locations, level_counts, lc):
    """The FCOS losses of one batch: outputs 'cls_logits' (B, N, C),
    'box_regression' (B, N, 4) (l/t/r/b, in strides under
    NORM_REG_TARGETS) and 'iou_pred' (B, N) (centerness logits);
    ``locations`` the (N, 4) (x, y, x, y) tiling the model passes as its
    anchors. Returns {loss_cls, loss_reg, loss_centerness, num_pos}."""
    cls_logits = outputs["cls_logits"].to(torch.float32)
    box_regression = outputs["box_regression"].to(torch.float32)
    centerness = outputs["iou_pred"].to(torch.float32)
    locations = locations.to(torch.float32)[:, :2]
    gt_boxes = gt_boxes.to(torch.float32)

    with record_function(SPAN_ASSIGN):
        labels, reg_targets = fcos_assign(gt_boxes, gt_labels, locations,
                                          level_counts, lc)
        if lc.norm_reg_targets:
            reg_targets = reg_targets / _per_location(
                lc.strides, level_counts, locations.device)[None, :, None]

    with record_function(SPAN_LOSSES):
        pos = labels > 0
        posf = pos.to(torch.float32)
        world = comm.get_world_size()
        num_pos = comm.all_reduce_sum(posf.sum())
        num_pos_norm = num_pos.clamp(min=float(world)) / world
        loss_cls = sigmoid_focal_loss(cls_logits, labels, lc.gamma,
                                      lc.alpha).sum() / num_pos_norm
        ctr_targets = torch.where(
            pos, compute_centerness_targets_ltrb(reg_targets), 0.0)
        sum_ctr = comm.all_reduce_sum(ctr_targets.sum()).clamp(
            min=1e-6) / world
        # the log and the divisions see 1s on background rows, whose
        # targets can be negative
        safe_targets = torch.where(pos[..., None], reg_targets, 1.0)
        safe_preds = torch.where(pos[..., None], box_regression, 1.0)
        reg = iou_loss_ltrb(safe_preds, safe_targets, lc.iou_loss_type)
        loss_reg = (reg * ctr_targets).sum() / sum_ctr
        loss_ctr = (bce_with_logits(centerness, ctr_targets)
                    * posf).sum() / num_pos_norm
    return {"loss_cls": loss_cls, "loss_reg": loss_reg,
            "loss_centerness": loss_ctr, "num_pos": num_pos}

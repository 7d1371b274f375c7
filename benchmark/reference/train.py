"""The plain reference of the train step: forward, the PAA loss, the
backward and SGD with momentum, in float32, over a batch computed in
blocks of images.

SGD as the configuration's solver states it (paa_core's
solver/build.py): weight decay added to the gradient before the
momentum trace, the trace started at the first gradient, the learning
rate applied after it; biases at BIAS_LR_FACTOR times the rate and
WEIGHT_DECAY_BIAS; the DCN offset convs at DCONV_OFFSETS_LR_FACTOR; the
stem and the first FREEZE_CONV_BODY_AT - 1 stages frozen; constant or
linear warm-up, then steps of GAMMA.
"""

from __future__ import annotations

from bisect import bisect_right

import torch

from . import loss as L
from .model import normalize


def label(name):
    parts = name.split(".")
    if any("offset" in p for p in parts):
        return "dcn_offset_bias" if parts[-1] == "bias" else "dcn_offset"
    return "bias" if parts[-1] == "bias" else "weight"


def lr_at(solver, i):
    wf = 1.0
    if i < solver["warmup_iters"]:
        wf = solver["warmup_factor"]
        if solver["warmup_method"] == "linear":
            a = i / max(solver["warmup_iters"], 1)
            wf = wf * (1 - a) + a
    return solver["base_lr"] * wf * solver["gamma"] ** bisect_right(
        solver["steps"], i)


def group_settings(solver, lab):
    """(learning-rate factor, weight decay) of a parameter label."""
    return {
        "weight": (1.0, solver["weight_decay"]),
        "bias": (solver["bias_lr_factor"], solver["weight_decay_bias"]),
        "dcn_offset": (solver["dcn_offsets_lr_factor"],
                       solver["weight_decay"]),
        "dcn_offset_bias": (solver["dcn_offsets_lr_factor"]
                            * solver["bias_lr_factor"],
                            solver["weight_decay_bias"]),
    }[lab]


def batch_losses(model, batch, anchors, counts, ref, block, grad=True):
    """The batch's loss terms and #positives; with ``grad`` the
    parameters' .grad hold the gradient of the total. Two passes over
    blocks of ``block`` images: the assignment (no gradient) gives the
    batch's normalizers, then each block's share is differentiated."""
    lc = ref["loss"]
    images, sizes = batch["images"], batch["image_sizes"]
    n = images.shape[0]
    blocks = [slice(i, min(n, i + block)) for i in range(0, n, block)]

    def forward(sl):
        x = normalize(images[sl], sizes[sl], ref["pixel_mean"],
                      ref["pixel_std"])
        return model(x)

    assigned, num_pos, iou_sum = [], 0.0, 0.0
    with torch.no_grad():
        for sl in blocks:
            a = L.assign(forward(sl), batch["gt_boxes"][sl],
                         batch["gt_labels"][sl], anchors, counts, lc)
            assigned.append(a)
            num_pos += float(a["num_pos"])
            iou_sum += float(a["iou_sum"])
    totals = {"loss_cls": 0.0, "loss_reg": 0.0, "loss_iou_pred": 0.0}
    for sl, a in zip(blocks, assigned):
        with torch.set_grad_enabled(grad):
            parts = L.losses(forward(sl), a, anchors, lc, num_pos, iou_sum)
            if grad:
                sum(parts.values()).backward()
        for k, v in parts.items():
            totals[k] += float(v.detach())
    totals["loss"] = sum(totals.values())
    totals["num_pos"] = num_pos
    return totals


def train_steps(model, batches, anchors, counts, ref, block):
    """SGD steps of ``model`` (its initial weights loaded) over
    ``batches``. Returns per step the loss terms, and the first step's
    gradient of every trainable parameter (as dict of tensors)."""
    solver = ref["solver"]
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    trace = {}
    records, first_grad = [], None
    for i, batch in enumerate(batches):
        for p in params.values():
            p.grad = None
        records.append(batch_losses(model, batch, anchors, counts, ref,
                                    block))
        if i == 0:
            first_grad = {n: p.grad.detach().clone()
                          for n, p in params.items()}
        lr = lr_at(solver, i)
        with torch.no_grad():
            for n, p in params.items():
                factor, wd = group_settings(solver, label(n))
                d = p.grad + wd * p
                trace[n] = d if i == 0 else solver["momentum"] * trace[n] + d
                p -= lr * factor * trace[n]
    for p in params.values():
        p.grad = None
    return records, first_grad

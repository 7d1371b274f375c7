"""Optimizer and learning-rate schedule (port of paa_tpu/solver/build.py;
reference paa_core/solver/build.py:7-37, lr_scheduler.py:10-52).

- SGD with momentum: ``torch.optim.SGD`` with ``dampening=0`` and
  ``nesterov=False`` adds the weight decay to the gradient before the
  momentum trace, starts the trace at the first gradient and applies the
  learning rate after it, as the JAX package's
  ``optax.add_decayed_weights`` -> ``optax.sgd(momentum)`` does.
- Parameter groups by label: "bias" parameters get BASE_LR *
  BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS; DCN offset convs get
  DCONV_OFFSETS_LR_FACTOR (times BIAS_LR_FACTOR for their bias).
  Each group carries its ``lr_factor``; the caller sets
  ``lr = schedule(i) * lr_factor`` before update i (0-based), so no
  scheduler's own counter is involved.
- WarmupMultiStepLR: constant or linear warmup for WARMUP_ITERS, then
  GAMMA ** bisect_right(STEPS, i).
- "frozen" parameters (FREEZE_CONV_BODY_AT stages; FrozenBatchNorm's
  tensors are buffers in the port) get no update: they join no group.
  A FrozenBatchNorm is told by its type, not by its name or its
  tensors: a GN body names its norms ``bn1``..``bn3`` and
  ``downsample_bn`` as a FrozenBN body does, and a SyncBatchNorm holds
  the same four tensors as a FrozenBatchNorm; the affines of both train.
"""

from __future__ import annotations

import re
from bisect import bisect_right

import torch

def make_lr_schedule(cfg):
    """schedule(i) -> the learning rate of update i (0-based)."""
    s = cfg.SOLVER
    base_lr, steps, gamma = s.BASE_LR, tuple(s.STEPS), s.GAMMA
    warmup_factor, warmup_iters = s.WARMUP_FACTOR, s.WARMUP_ITERS
    if s.WARMUP_METHOD not in ("constant", "linear"):
        raise ValueError(s.WARMUP_METHOD)
    linear = s.WARMUP_METHOD == "linear"

    def schedule(count):
        wf = 1.0
        if count < warmup_iters:
            wf = warmup_factor
            if linear:
                alpha = count / max(warmup_iters, 1)
                wf = warmup_factor * (1 - alpha) + alpha
        return base_lr * wf * gamma ** bisect_right(steps, count)

    return schedule


def _label(name, freeze_at, frozen_bn):
    keys = name.split(".")
    leaf = keys[-1]
    if name.rpartition(".")[0] in frozen_bn:
        return "frozen"
    # FREEZE_CONV_BODY_AT: stage 0 = stem, stage i = layer{i}
    for comp in keys:
        if comp == "stem" and freeze_at >= 1:
            return "frozen"
        m = re.match(r"^layer(\d)_", comp)
        if m and freeze_at >= int(m.group(1)) + 1:
            return "frozen"
    if any("offset" in comp for comp in keys):
        return "dcn_offset_bias" if leaf == "bias" else "dcn_offset"
    return "bias" if leaf == "bias" else "weight"


def param_labels(module, freeze_at=2):
    """{name: 'weight' | 'bias' | 'dcn_offset' | 'dcn_offset_bias' |
    'frozen'} for ``module``'s parameters and FrozenBatchNorm buffers:
    the tensors of the JAX package's param tree, under dotted names that
    carry its flax scopes. Every tensor of a FrozenBatchNorm is "frozen";
    a GroupNorm's or SyncBatchNorm's affine under the same module name (a
    GN or SyncBN body's ``bn1``) is not, as the JAX package labels
    ``bn1/gn/scale`` and ``bn1/bn/scale``. A SyncBatchNorm's running
    statistics (the JAX package's ``batch_stats``) get no label."""
    from ..modeling.layers import FrozenBatchNorm  # modeling imports us

    frozen_bn = {name for name, m in module.named_modules()
                 if isinstance(m, FrozenBatchNorm)}
    names = [name for name, _ in module.named_parameters()] + [
        name for name, _ in module.named_buffers()
        if name.rpartition(".")[0] in frozen_bn]
    return {name: _label(name, freeze_at, frozen_bn) for name in names}


def make_optimizer(cfg, module):
    """SGD over ``module``'s trainable parameters, one group per label.
    Returns (optimizer, labels); every group's ``lr_factor`` scales the
    schedule's rate."""
    s = cfg.SOLVER
    params = dict(module.named_parameters())
    labels = param_labels(module, cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT)
    settings = {  # label: (lr factor, weight decay)
        "weight": (1.0, s.WEIGHT_DECAY),
        "bias": (s.BIAS_LR_FACTOR, s.WEIGHT_DECAY_BIAS),
        "dcn_offset": (s.DCONV_OFFSETS_LR_FACTOR, s.WEIGHT_DECAY),
        "dcn_offset_bias": (s.DCONV_OFFSETS_LR_FACTOR * s.BIAS_LR_FACTOR,
                            s.WEIGHT_DECAY_BIAS),
    }
    groups = []
    for label, (factor, wd) in settings.items():
        members = [p for n, p in params.items()
                   if labels[n] == label and p.requires_grad]
        if members:
            groups.append({"params": members, "label": label,
                           "lr_factor": factor, "weight_decay": wd,
                           "lr": s.BASE_LR * factor})
    optimizer = torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM,
                                dampening=0.0, nesterov=False)
    return optimizer, labels


def set_lr(optimizer, lr):
    """Give every group ``lr * lr_factor`` (before an update)."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_factor"]

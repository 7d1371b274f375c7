"""The train step (port of paa_tpu/engine/train_step.py; reference hot
loop paa_core/engine/trainer.py:57-113).

One step: normalize the raw uint8 batch on the device (padding back to
zero), forward, the loss, total = sum of the ``loss_*`` terms, backward,
an SGD update at ``schedule(step)``, ``step += 1``. Frozen parameters
do not require grad (modeling/resnet.py), so autograd computes no
gradient for them and the optimizer holds none of them.

PyTorch runs eagerly, so there is no jit and no mesh here: the step runs
on the module's device as it is called. The metrics stay on the device
(the trainer reads them a step late). The step syncs with the device
only inside the loss's GMM, which reads "every row converged" on the
host every ``ops/gmm.py::CHECK_EVERY`` EM iterations until it is true.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..modeling.paa_loss import PAALossConfig, paa_loss
from ..ops.image_norm import maybe_device_normalize
from ..solver import set_lr

# the spans of a step that chip_smoke.py's profile reads (the loss has
# its own, modeling/paa_loss.py)
SPAN_INPUT = "train_step/input"
SPAN_FORWARD = "train_step/forward"
SPAN_BACKWARD = "train_step/backward"
SPAN_OPTIMIZER = "train_step/optimizer"


@dataclass
class TrainState:
    """The module being trained, its optimizer and the number of updates
    taken (which picks the learning rate of the next one)."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(anchors, level_counts, loss_cfg: PAALossConfig,
                    schedule, num_shards=1, loss_call=paa_loss,
                    normalize=None):
    """Returns train_step(state, batch) -> metrics.

    batch: 'images' (B, H, W, 3), 'gt_boxes' (B, G, 4), 'gt_labels'
    (B, G), and with ``normalize`` = (pixel_mean, pixel_std) the raw
    uint8 images' 'image_sizes' (B, 2). Numpy arrays or tensors; they
    move to the device of ``anchors``. metrics: the losses, 'num_pos' and
    'loss' (their total), detached tensors on the device."""
    counts = tuple(level_counts)
    device = anchors.device

    def train_step(state: TrainState, batch):
        with record_function(SPAN_INPUT):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
            images = batch["images"]
            if normalize is not None:
                images = maybe_device_normalize(
                    images, batch.get("image_sizes"), *normalize)
        with record_function(SPAN_FORWARD):
            outputs = state.module(images.permute(0, 3, 1, 2).contiguous())
        losses = loss_call(outputs, batch["gt_boxes"], batch["gt_labels"],
                           anchors, counts, loss_cfg, num_shards=num_shards)
        total = sum(v for k, v in losses.items() if k.startswith("loss_"))
        with record_function(SPAN_BACKWARD):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with record_function(SPAN_OPTIMIZER):
            set_lr(state.optimizer, schedule(state.step))
            state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
        return metrics

    return train_step

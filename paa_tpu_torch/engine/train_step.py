"""The train step (port of paa_tpu/engine/train_step.py; reference hot
loop paa_core/engine/trainer.py:57-113).

One step: normalize the raw uint8 batch on the device (padding back to
zero), the model's forward and loss (``forward_loss``: for a dense
detector ``dense_forward_loss``, its head's outputs into its loss; a
two-stage model's module computes its losses in its own forward,
modeling/two_stage.py), total = sum of the ``loss_*`` terms, backward,
an SGD update at ``schedule(step)``, ``step += 1``. Frozen parameters
do not require grad (modeling/resnet.py), so autograd computes no
gradient for them and the optimizer holds none of them.

PyTorch runs eagerly, so there is no jit and no mesh here: the step runs
on the module's device as it is called. The metrics stay on the device
(the trainer reads them a step late). The step syncs with the device
only inside the loss's GMM, which reads "every row converged" on the
host every ``ops/gmm.py::CHECK_EVERY`` EM iterations until it is true.

Under a process group of more than one rank (utils/comm.py) the step
wraps ``state.module`` in ``DistributedDataParallel`` at its first call:
each rank's batch is its share of the global one, the loss sums the
positive count and the IoU sum over the ranks (modeling/paa_loss.py),
DDP averages the gradients, and the logged losses are averaged over the
ranks (the reference's ``reduce_loss_dict``). Frozen parameters do not
require grad, so DDP's reducer leaves them out. ``broadcast_buffers``
keeps its default, rank 0's buffers copied to every rank before each
forward: FrozenBatchNorm's never change, and a SyncBatchNorm's running
statistics (MODEL.USE_SYNCBN) are the same on every rank, since each
rank moves them by the same all-reduced batch statistics, so the copy
changes no value.

Each step puts the module in training mode (a SyncBatchNorm normalizes
by batch statistics and moves its running ones), as the JAX package
applies its model with ``mutable=["batch_stats"]`` in its step; every
eval entry point puts it back in eval mode (``make_eval_fn``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn.parallel import DistributedDataParallel
from torch.profiler import record_function

from ..ops.image_norm import maybe_device_normalize
from ..solver import set_lr
from ..utils import comm

# the spans of a step that chip_smoke.py's profile reads (the loss has
# its own, modeling/paa_loss.py)
SPAN_INPUT = "train_step/input"
SPAN_FORWARD = "train_step/forward"
SPAN_BACKWARD = "train_step/backward"
SPAN_OPTIMIZER = "train_step/optimizer"


@dataclass
class TrainState:
    """The module being trained (``DistributedDataParallel`` around the
    model's module once a step of more than one rank has run), its
    optimizer and the number of updates taken (which picks the learning
    rate of the next one)."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _data_parallel(module):
    """``module`` in ``DistributedDataParallel`` when there is more than
    one rank (once)."""
    if comm.get_world_size() == 1 or \
            isinstance(module, DistributedDataParallel):
        return module
    device = next(module.parameters()).device
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None)


def _mean_over_ranks(metrics):
    """The ``loss*`` metrics averaged over the ranks, in one all-reduce."""
    keys = [k for k in metrics if k.startswith("loss")]
    means = comm.all_reduce_sum(torch.stack([metrics[k] for k in keys])
                                ) / comm.get_world_size()
    return {**metrics, **dict(zip(keys, means))}


def dense_forward_loss(anchors, level_counts, loss_cfg, loss_call):
    """``forward_loss`` of a dense detector: its module's head outputs
    into ``loss_call(outputs, gt_boxes, gt_labels, anchors, level_counts,
    loss_cfg)``."""
    counts = tuple(level_counts)

    def forward_loss(module, images, batch, step):
        with record_function(SPAN_FORWARD):
            outputs = module(images)
        return loss_call(outputs, batch["gt_boxes"], batch["gt_labels"],
                         anchors, counts, loss_cfg)

    return forward_loss


def make_train_step(forward_loss, schedule, device, normalize=None):
    """Returns train_step(state, batch) -> metrics.

    forward_loss(module, images, batch, step) -> the loss dict, from the
    normalized NCHW images and the batch on the device, at the number of
    updates taken so far. batch: 'images' (B, H, W, 3), 'gt_boxes'
    (B, G, 4), 'gt_labels' (B, G), and with ``normalize`` = (pixel_mean,
    pixel_std) the raw uint8 images' 'image_sizes' (B, 2); whatever else
    the loss reads. Numpy arrays or tensors; they move to ``device``.
    metrics: the losses, 'num_pos' and 'loss' (their total), detached
    tensors on the device, over the global batch when there is more than
    one rank."""

    def train_step(state: TrainState, batch):
        state.module = _data_parallel(state.module)
        state.module.train()
        with record_function(SPAN_INPUT):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
            images = batch["images"]
            if normalize is not None:
                images = maybe_device_normalize(
                    images, batch.get("image_sizes"), *normalize)
        losses = forward_loss(state.module,
                              images.permute(0, 3, 1, 2).contiguous(), batch,
                              state.step)
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
        if comm.get_world_size() > 1:
            metrics = _mean_over_ranks(metrics)
        return metrics

    return train_step

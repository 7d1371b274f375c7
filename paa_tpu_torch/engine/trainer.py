"""Training loop (port of paa_tpu/engine/trainer.py; reference
paa_core/engine/trainer.py:38-121): data and step timing, the
20-iteration log line with the ETA, checkpoints every CHECKPOINT_PERIOD
and at the end. One train step per bucket shape. The metrics are read
one step late, so reading them does not wait for the step just queued
(the step itself syncs at its GMM's convergence reads,
engine/train_step.py), and a non-finite lagged loss raises
FloatingPointError; the last step's are read once the loop ends.

``batches`` is an iterable of batch dicts in the loader's contract
(data/loader.py, ``make_data_loader(cfg, dataset, is_train=True)``):
'images' (B, H, W, 3) uint8, 'image_sizes' (B, 2), 'gt_boxes'
(B, MAX_GT, 4) float32, 'gt_labels' (B, MAX_GT) int32 with 0 for
padding; other keys ('image_ids', 'orig_sizes') are not read.
"""

from __future__ import annotations

import datetime
import logging
import math
import time

from ..utils.metric_logger import MetricLogger


def do_train(cfg, model, state, batches, checkpointer=None, start_iter=0,
             logger=None, metric_hook=None):
    """Run the loop until SOLVER.MAX_ITER or the end of ``batches``;
    returns ``state``.

    metric_hook: optional ``hook(iteration, metrics)``, called with the
    one-step-lagged host floats of each iteration."""
    logger = logger or logging.getLogger("paa_tpu_torch.trainer")
    logger.info("Start training")
    meters = MetricLogger()
    max_iter = cfg.SOLVER.MAX_ITER
    checkpoint_period = cfg.SOLVER.CHECKPOINT_PERIOD

    steps = {}  # one train step per bucket shape

    def get_step(hw):
        if hw not in steps:
            steps[hw] = model.make_bucket_train_step(hw)
        return steps[hw]

    def read(it, metrics):
        """The host floats of iteration ``it``'s metrics; raises on a
        non-finite loss (the reference asserts one every step,
        rpn/paa/loss.py:307)."""
        host_metrics = {k: float(v) for k, v in metrics.items()}
        meters.update(**host_metrics)
        loss_val = host_metrics.get("loss")
        if loss_val is not None and not math.isfinite(loss_val):
            raise FloatingPointError(
                f"non-finite training loss {loss_val} at iteration {it}: "
                f"{host_metrics}")
        if metric_hook is not None:
            metric_hook(it, host_metrics)

    start_time = time.time()
    end = time.time()
    prev_metrics = None
    iteration = start_iter
    for batch in batches:
        data_time = time.time() - end
        iteration += 1
        step_fn = get_step(tuple(batch["images"].shape[1:3]))
        metrics = step_fn(state, {k: batch[k] for k in model.train_batch_keys
                                  if k in batch})

        batch_time = time.time() - end
        end = time.time()
        meters.update(time=batch_time, data=data_time)
        if prev_metrics is not None:
            read(iteration - 1, prev_metrics)
        prev_metrics = metrics

        if iteration % 20 == 0 or iteration == max_iter:
            eta_seconds = meters.meters["time"].global_avg * (
                max_iter - iteration)
            eta = str(datetime.timedelta(seconds=int(eta_seconds)))
            logger.info(f"eta: {eta}  iter: {iteration}  {meters}")
        if checkpointer and iteration % checkpoint_period == 0:
            checkpointer.save(f"model_{iteration:07d}", state,
                              iteration=iteration)
        if iteration >= max_iter:
            break

    if prev_metrics is not None:  # the last step's, once the loop is done
        read(iteration, prev_metrics)
    if checkpointer:
        checkpointer.save("model_final", state, iteration=iteration)
    total = time.time() - start_time
    logger.info(
        f"Total training time: {datetime.timedelta(seconds=int(total))} "
        f"({total / max(max_iter - start_iter, 1):.4f} s/it)")
    return state

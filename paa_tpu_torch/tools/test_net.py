"""Evaluation CLI of the port (port of tools/test_net.py; reference
tools/test_net.py:31-146).

    python -m paa_tpu_torch.tools.test_net \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        [--ckpt OUTPUT_DIR/model_final] [--eval_dir OUTPUT_DIR] \\
        [--device cpu] [KEY VALUE ...]

Evaluates one checkpoint of the port (utils/checkpoint.py), or, with
``--eval_dir``, watches a checkpoint directory: it polls every 5 minutes
for new ``model_*`` checkpoints, evaluates each, tracks the best AP and
optionally keeps only the best (``--keep_best_only``). With no
checkpoint the model keeps its seeded initial weights (a dry run).
Results and the AP table go to OUTPUT_DIR/inference/<dataset>/; the
watcher also writes each checkpoint's metrics as TensorBoard scalars
to OUTPUT_DIR, tagged ``{dataset}_{metric}`` at the checkpoint's
iteration, when ``torch.utils.tensorboard`` imports (a soft
dependency: skipped otherwise). Runs on the card unless ``--device
cpu`` is given.
"""

import argparse
import glob
import os
import re
import time


def _ckpt_iteration(ckpt_path):
    """model_0025000[.pth] -> 25000 (reference test_net.py:202-204)."""
    name = os.path.basename(ckpt_path or "")
    m = re.search(r"model_(\d+)", name)
    return int(m.group(1)) if m else 0


def _write_tb_scalars(output_dir, dataset_names, all_results, n_iter):
    """TensorBoard scalars of one evaluated checkpoint (reference
    tools/test_net.py:140-143): '{dataset}_{metric}' tags at the
    checkpoint's iteration. Skipped when tensorboard is unavailable."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return
    writer = SummaryWriter(output_dir)
    for name, results in zip(dataset_names, all_results):
        if not isinstance(results, dict):
            continue
        for metric, value in results.items():
            if isinstance(value, (int, float)):
                writer.add_scalar(f"{name}_{metric}", float(value), n_iter)
    writer.close()


def eval_checkpoint(cfg, model, ckpt_path, logger, tb_iter=None):
    """Evaluate ``model`` (with the weights of ``ckpt_path``, if given)
    on every dataset of DATASETS.TEST; returns the results, one dict per
    dataset. With ``tb_iter``, also writes them as TensorBoard scalars
    at that iteration."""
    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.engine.inference import inference
    from paa_tpu_torch.utils.checkpoint import load_weights

    if ckpt_path:
        logger.info(f"Loading checkpoint from {os.path.abspath(ckpt_path)}")
        load_weights(model.module, ckpt_path)
    datasets = build_dataset(cfg, cfg.DATASETS.TEST, is_train=False)
    if not isinstance(datasets, list):
        datasets = [datasets]
    all_results = [
        inference(cfg, model, dataset, logger=logger,
                  output_folder=os.path.join(cfg.OUTPUT_DIR, "inference",
                                             name))
        for name, dataset in zip(cfg.DATASETS.TEST, datasets)
    ]
    if tb_iter is not None:
        _write_tb_scalars(cfg.OUTPUT_DIR, list(cfg.DATASETS.TEST),
                          all_results, tb_iter)
    return all_results


def watch_dir(cfg, model, eval_dir, logger, poll_s=300,
              give_up_s=6 * 3600, keep_best_only=False):
    evaluated = set()
    best_ap, best_ckpt = -1.0, None
    last_new = time.time()
    while True:
        ckpts = sorted(glob.glob(os.path.join(eval_dir, "model_*")))
        for ckpt in [c for c in ckpts if c not in evaluated]:
            last_new = time.time()
            for _ in range(3):
                try:
                    results = eval_checkpoint(
                        cfg, model, ckpt, logger,
                        tb_iter=_ckpt_iteration(ckpt))
                    break
                except Exception as e:  # noqa: BLE001 - a checkpoint
                    # still being written; retried, then left out
                    logger.warning(f"eval of {ckpt} failed ({e}); "
                                   f"retrying in 10s")
                    time.sleep(10)
            else:
                continue
            evaluated.add(ckpt)
            ap = results[0].get("AP", -1.0) if results else -1.0
            logger.info(f"{ckpt} (iteration {_ckpt_iteration(ckpt)}): "
                        f"AP {ap:.4f}")
            if ap > best_ap:
                best_ap, best_ckpt = ap, ckpt
                logger.info(f"new best AP {ap:.4f} at {ckpt}")
            if keep_best_only:
                for c in list(evaluated):
                    if c != best_ckpt and os.path.isfile(c):
                        os.remove(c)
        if time.time() - last_new > give_up_s:
            logger.info("No new checkpoints for 6h; exiting watcher")
            return
        time.sleep(poll_s)


def main(argv=None):
    parser = argparse.ArgumentParser(description="paa_tpu_torch evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--eval_dir", default=None)
    parser.add_argument("--keep_best_only", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.utils.logger import setup_logger

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("paa_tpu_torch", cfg.OUTPUT_DIR)
    model = build_detection_model(cfg, device=args.device)

    if args.eval_dir:
        watch_dir(cfg, model, args.eval_dir, logger,
                  keep_best_only=args.keep_best_only)
    else:
        eval_checkpoint(cfg, model, args.ckpt, logger)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

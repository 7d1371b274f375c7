"""Training CLI of the port (port of tools/train_net.py; reference
tools/train_net.py).

    python -m paa_tpu_torch.tools.train_net \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        [--skip-test] [--device cpu] [KEY VALUE ...]

    torchrun --nproc_per_node N -m paa_tpu_torch.tools.train_net ...

Joins the process group of a ``torchrun`` launch (utils/comm.py: one
rank per card with NCCL, or gloo with ``--device cpu``), logs the
environment and saves OUTPUT_DIR/config.yml on the main process. It
resumes from OUTPUT_DIR's ``last_checkpoint`` when there is one, and
otherwise starts from MODEL.WEIGHT (utils/torch_import.py: a
``catalog://`` or ``.pkl`` Detectron model, a ``paa_core`` ``.pth``).
Then ``do_train`` over DATASETS.TRAIN (each rank loads its interleaved
share of the global SOLVER.IMS_PER_BATCH) and, unless ``--skip-test``,
the evaluation of every dataset of DATASETS.TEST. A weight file or a
dataset that is missing or unreadable exits with code 2. The world size
comes from ``torchrun``; TPU.MESH_DATA (a TPU lowering) is not read.
"""

import argparse
import os
import pickle

# what a missing or unreadable weight file or dataset raises
SETUP_ERRORS = (OSError, ValueError, RuntimeError, KeyError, EOFError,
                pickle.UnpicklingError)


def setup(cfg, device, logger):
    """The model on ``device``, its train state (resumed, or from
    MODEL.WEIGHT), the start iteration and the training batches."""
    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.data.loader import make_data_loader
    from paa_tpu_torch.engine import TrainState
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.solver import make_optimizer
    from paa_tpu_torch.utils.checkpoint import Checkpointer
    from paa_tpu_torch.utils.torch_import import load_pretrained_into

    model = build_detection_model(cfg, device=device)
    state = TrainState(model.module, make_optimizer(cfg, model.module)[0])
    checkpointer = Checkpointer(cfg.OUTPUT_DIR, logger=logger)
    start_iter = 0
    if checkpointer.has_checkpoint():
        start_iter = int(checkpointer.load(state).get("iteration", 0))
    elif cfg.MODEL.WEIGHT:
        load_pretrained_into(cfg, model.module, cfg.MODEL.WEIGHT, logger)
    dataset = build_dataset(cfg, cfg.DATASETS.TRAIN, is_train=True)
    logger.info(f"train dataset: {len(dataset)} images")
    batches = make_data_loader(cfg, dataset, is_train=True,
                               start_iter=start_iter)
    return model, state, checkpointer, start_iter, batches


def run_test(cfg, model, logger):
    """Evaluate ``model`` on every dataset of DATASETS.TEST; the results,
    one dict per dataset ({} on ranks other than the main one)."""
    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.engine.inference import inference

    datasets = build_dataset(cfg, cfg.DATASETS.TEST, is_train=False)
    if not isinstance(datasets, list):
        datasets = [datasets]
    return [
        inference(cfg, model, dataset, logger=logger,
                  output_folder=os.path.join(cfg.OUTPUT_DIR, "inference",
                                             name))
        for name, dataset in zip(cfg.DATASETS.TEST, datasets)
    ]


def main(argv=None, metric_hook=None):
    """The CLI; returns the exit code. ``metric_hook(iteration, metrics)``
    is ``do_train``'s, for callers that drive the CLI in process."""
    parser = argparse.ArgumentParser(description="paa_tpu_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--skip-test", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="Modify config options using the command-line")
    args = parser.parse_args(argv)

    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.engine import do_train
    from paa_tpu_torch.utils import comm
    from paa_tpu_torch.utils.logger import setup_logger
    from paa_tpu_torch.utils.misc import collect_env_info, save_config

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    device = comm.init_distributed(args.device)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("paa_tpu_torch", cfg.OUTPUT_DIR, comm.get_rank())
    logger.info(f"world size {comm.get_world_size()}, rank "
                f"{comm.get_rank()} on {device}")
    logger.info(f"environment:\n{collect_env_info()}")
    logger.info(f"Running with config:\n{cfg}")
    if comm.is_main_process():
        save_config(cfg, os.path.join(cfg.OUTPUT_DIR, "config.yml"))

    try:
        model, state, checkpointer, start_iter, batches = setup(
            cfg, device, logger)
    except SETUP_ERRORS as e:
        logger.error(f"cannot start training: {type(e).__name__}: {e}")
        return 2
    do_train(cfg, model, state, batches, checkpointer=checkpointer,
             start_iter=start_iter, logger=logger, metric_hook=metric_hook)
    if not args.skip_test:
        run_test(cfg, model, logger)
    comm.synchronize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

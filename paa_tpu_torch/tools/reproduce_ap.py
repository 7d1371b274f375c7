"""The AP gate of the port (port of tools/reproduce_ap.py).

The reference publishes PAA_R_50_FPN_1x at AP 40.4 on COCO minival and
asserts regression results with check_expected_results. One command
imports a released checkpoint into the port, evaluates it and applies
that gate (default AP 0.404 +/- 0.003):

    python -m paa_tpu_torch.tools.reproduce_ap \\
        --weights /path/to/PAA_R_50_FPN_1x.pth \\
        --data /path/to/datasets        # the directory holding coco/...

    torchrun --nproc_per_node N -m paa_tpu_torch.tools.reproduce_ap ...

Exit code 0: the gate passed; 1: the AP is outside expected +/- tol;
2: data or weights are missing or unreadable. ``--ann-file``/``--img-dir``
bypass the dataset catalog. Runs on the card unless ``--device cpu``.
Under ``torchrun`` the ranks share the batches and the main process
applies the gate (engine/inference.py); the other ranks exit 0.
"""

import argparse
import os

from paa_tpu_torch.tools.train_net import SETUP_ERRORS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="paa_tpu_torch AP gate")
    p.add_argument("--config-file",
                   default="configs/paa/paa_R_50_FPN_1x.yaml", metavar="FILE")
    p.add_argument("--weights", required=True,
                   help=".pth/.pkl/catalog:// released checkpoint to import")
    p.add_argument("--data", default=None,
                   help="datasets root (the directory holding coco/...); "
                   "sets PAA_TPU_DATA_DIR for the dataset catalog")
    p.add_argument("--ann-file", default=None,
                   help="a COCO-format annotation json (bypasses the "
                   "catalog; requires --img-dir)")
    p.add_argument("--img-dir", default=None)
    p.add_argument("--expected", type=float, default=0.404,
                   help="expected COCO AP (a fraction, e.g. 0.404)")
    p.add_argument("--tol", type=float, default=0.003,
                   help="allowed |AP - expected| (a fraction)")
    p.add_argument("--output-dir", default=None,
                   help="cfg.OUTPUT_DIR for the eval artifacts")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def load_model(cfg, weights, logger, device=None):
    """The model of ``cfg`` on ``device`` with ``weights`` imported:
    (model, skipped file names, unwritten port keys). Raises when the
    file is missing or unreadable."""
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.utils.torch_import import load_pretrained_into

    model = build_detection_model(cfg, device=device)
    skipped, unwritten = load_pretrained_into(cfg, model.module, weights,
                                              logger)
    return model, skipped, unwritten


def run_gate(cfg, model, datasets, logger):
    """Evaluate ``model`` on every (name, dataset); ``inference`` raises
    AssertionError when the gate of cfg.TEST.EXPECTED_RESULTS fails.
    Returns the results list (dicts empty on ranks other than the main
    one)."""
    from paa_tpu_torch.engine.inference import inference

    return [
        inference(cfg, model, dataset, logger=logger,
                  output_folder=os.path.join(cfg.OUTPUT_DIR, "inference",
                                             name))
        for name, dataset in datasets
    ]


def resolve_datasets(cfg, args):
    """[(name, dataset)] from --ann-file/--img-dir or DATASETS.TEST."""
    from paa_tpu_torch.data.build import build_dataset
    from paa_tpu_torch.data.coco import COCODataset

    if args.ann_file:
        return [("custom", COCODataset(
            args.ann_file, args.img_dir,
            remove_images_without_annotations=False))]
    built = build_dataset(cfg, cfg.DATASETS.TEST, is_train=False)
    if not isinstance(built, list):
        built = [built]
    return list(zip(cfg.DATASETS.TEST, built))


def main(argv=None):
    args = parse_args(argv)
    if args.data:
        os.environ["PAA_TPU_DATA_DIR"] = args.data

    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.utils import comm
    from paa_tpu_torch.utils.logger import setup_logger

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # the gate goes through TEST.EXPECTED_RESULTS, as the reference's
    # quick schedules: mean +/- sigma_tol * std
    cfg.TEST.EXPECTED_RESULTS = [["bbox", "AP", args.expected, args.tol]]
    cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL = 1
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    cfg.freeze()

    device = comm.init_distributed(args.device)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger("paa_tpu_torch.reproduce_ap", cfg.OUTPUT_DIR,
                          comm.get_rank())
    if args.ann_file and not args.img_dir:
        logger.error("--ann-file requires --img-dir")
        return 2
    try:
        datasets = resolve_datasets(cfg, args)
    except (OSError, KeyError, RuntimeError) as e:
        logger.error(
            f"dataset not found ({e}); put COCO under --data (the default "
            "config evaluates coco_2017_val: <data>/coco/annotations/"
            "instances_val2017.json and <data>/coco/val2017) or pass "
            "--ann-file/--img-dir")
        return 2
    try:
        model, _, _ = load_model(cfg, args.weights, logger, device)
    except SETUP_ERRORS as e:
        logger.error(f"weights missing or unreadable: {type(e).__name__}: "
                     f"{e}")
        return 2
    try:
        results = run_gate(cfg, model, datasets, logger)
    except AssertionError as e:
        logger.error(f"AP GATE FAILED: {e}")
        return 1
    if comm.is_main_process():
        ap = results[0]["AP"]
        logger.info(f"AP GATE PASSED: AP={ap:.4f} within "
                    f"{args.expected:.4f} +/- {args.tol:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

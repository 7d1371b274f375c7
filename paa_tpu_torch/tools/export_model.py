"""Export a detector as a self-contained serving artifact (port of
tools/export_model.py; paa_tpu_torch/serving.py):

    python -m paa_tpu_torch.tools.export_model \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        --output paa_r50.paat [--ckpt OUTPUT_DIR/model_final] \\
        [--batch 16] [--height 800 --width 1344] [--device cpu] \\
        [KEY VALUE ...]

The artifact holds the whole inference at one static input shape (by
default the first TPU.TEST_BUCKETS entry), the weights of ``--ckpt``
(else the model's seeded initial weights) and the kernels as the port's
custom ops; ``paa_tpu_torch.serving.load_exported`` serves it without
the config or the model code. It is exported on the card unless
``--device cpu`` is given, and runs on the device it was exported on.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch serving export")
    parser.add_argument("--config-file", required=True, metavar="FILE")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument(
        "--height", type=int, default=None,
        help="input height (default: first TPU.TEST_BUCKETS entry)")
    parser.add_argument("--width", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from paa_tpu_torch.config import get_cfg
    from paa_tpu_torch.modeling import build_detection_model
    from paa_tpu_torch.serving import export_inference, save_exported
    from paa_tpu_torch.utils.checkpoint import load_weights
    from paa_tpu_torch.utils.logger import setup_logger

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    logger = setup_logger("paa_tpu_torch.export", None)

    hw = ((args.height, args.width) if args.height and args.width
          else tuple(cfg.TPU.TEST_BUCKETS[0]))
    model = build_detection_model(cfg, device=args.device)
    if args.ckpt:
        load_weights(model.module, args.ckpt)
    exported, meta = export_inference(model, args.batch, hw)
    meta["config_file"] = os.path.basename(args.config_file)
    save_exported(args.output, exported, meta)
    size_mb = os.path.getsize(args.output) / 1e6
    logger.info(f"wrote {args.output} ({size_mb:.1f} MB) input "
                f"{meta['input_shape']} device {meta['device']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

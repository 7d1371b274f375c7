"""Run detection on an image file (port of demo/demo.py).

    python -m paa_tpu_torch.demo.demo \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        [--ckpt OUTPUT_DIR/model_final] --input img.ppm \\
        [--output demo_out.jpg] [--confidence-threshold 0.7] \\
        [--device cpu] [KEY VALUE ...]

Prints the detections at or above the threshold as one JSON line (boxes
xyxy in the input's coordinates, scores, labels). With cv2 installed it
also draws them and writes the image to ``--output``; without cv2 (the
machine with the card has none) it says so and writes nothing. A binary
PPM input is read without cv2 (data/coco.py); any other format needs
it. Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch detection demo on one image")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", default="demo_out.jpg")
    parser.add_argument("--confidence-threshold", type=float, default=0.7)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from ..config import get_cfg
    from ..data.coco import read_image
    from .predictor import COCODemo

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    demo = COCODemo(cfg, args.ckpt, args.confidence_threshold, args.device)
    img = read_image(args.input)
    boxes, scores, labels = demo.compute_prediction(img)
    print(json.dumps({"input": args.input, "boxes": boxes.tolist(),
                      "scores": scores.tolist(),
                      "labels": labels.tolist()}))
    try:
        import cv2
    except ImportError:
        print("cv2 is not installed: the detections are not drawn")
        return 0
    cv2.imwrite(args.output, demo.run_on_opencv_image(img))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

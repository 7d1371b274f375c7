"""Webcam demo (port of demo/webcam.py; reference demo/webcam.py): run
the detector on a cv2 capture stream and show the detections.

    python -m paa_tpu_torch.demo.webcam \\
        --config-file configs/paa/paa_R_50_FPN_1x.yaml \\
        [--ckpt OUTPUT_DIR/model_final] [--confidence-threshold 0.7] \\
        [--camera 0] [--device cpu] [KEY VALUE ...]

Needs cv2 and a camera. Press ESC to exit. Runs on the card unless
``--device cpu`` is given.
"""

import argparse
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="paa_tpu_torch object detection webcam demo")
    parser.add_argument("--config-file", required=True, metavar="FILE")
    parser.add_argument("--ckpt", default=None)
    parser.add_argument(
        "--confidence-threshold", type=float, default=0.7,
        help="minimum score for a prediction to be shown")
    parser.add_argument(
        "--camera", type=int, default=0, help="cv2 capture device index")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import cv2

    from ..config import get_cfg
    from .predictor import COCODemo

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()

    demo = COCODemo(cfg, args.ckpt, args.confidence_threshold, args.device)
    cam = cv2.VideoCapture(args.camera)
    if not cam.isOpened():
        print(f"could not open camera {args.camera}", file=sys.stderr)
        return 1
    try:
        while True:
            start_time = time.time()
            ret_val, img = cam.read()
            if not ret_val:
                break
            composite = demo.run_on_opencv_image(img)
            print(f"inference time: {time.time() - start_time:.2f}s")
            cv2.imshow("paa_tpu_torch detections", composite)
            if cv2.waitKey(1) == 27:
                break  # esc
    finally:
        cam.release()
        cv2.destroyAllWindows()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

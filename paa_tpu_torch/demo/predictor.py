"""A COCODemo-style single-image predictor (port of demo/predictor.py).

``COCODemo(cfg, checkpoint_path, confidence_threshold, device)`` builds
the config's model on ``device`` (default: the card) with weights from
seed 0, or from a checkpoint of the port (``utils/checkpoint.py``'s
``load_weights``: a ``Checkpointer`` file, or one that
tools/remove_solver_states.py stripped). ``compute_prediction`` takes one
BGR uint8 image: resized as the eval path resizes (the shorter side to
INPUT.MIN_SIZE_TEST, the longer at most MAX_SIZE_TEST, with
``resize_uint8_linear``, cv2's INTER_LINEAR bit for bit), normalized on
the host, zero-padded to a multiple of 32 (not to a TEST_BUCKET), and
run through ``make_eval_fn``; it returns the boxes in the original
image's coordinates, scores and labels of the detections at or above
the threshold. ``run_on_opencv_image`` draws them, with cv2 imported
inside the call (the machine with the card has none).
"""

from __future__ import annotations

import math

import numpy as np

COCO_CATEGORIES = [
    "__background", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
    "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "wine glass",
    "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
    "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
    "donut", "cake", "chair", "couch", "potted plant", "bed",
    "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


class COCODemo:
    def __init__(self, cfg, checkpoint_path=None, confidence_threshold=0.7,
                 device=None):
        from ..modeling import build_detection_model
        from ..utils.checkpoint import load_weights

        self.cfg = cfg
        self.confidence_threshold = confidence_threshold
        self.model = build_detection_model(cfg, device=device)
        if checkpoint_path:
            load_weights(self.model.module, checkpoint_path)
        self.eval_fn = self.model.make_eval_fn()

    def compute_prediction(self, image_bgr):
        """image_bgr: (H, W, 3) uint8. Returns (boxes xyxy in original
        coordinates, scores, labels) at or above the confidence
        threshold, as numpy arrays."""
        import torch

        from ..data.transforms import (
            get_resize_size, normalize_image, resize_uint8_linear)

        h, w = image_bgr.shape[:2]
        oh, ow = get_resize_size((w, h), self.cfg.INPUT.MIN_SIZE_TEST,
                                 self.cfg.INPUT.MAX_SIZE_TEST)
        resized = resize_uint8_linear(image_bgr, ow, oh)
        norm = normalize_image(resized, self.cfg.INPUT.PIXEL_MEAN,
                               self.cfg.INPUT.PIXEL_STD)
        bh = int(math.ceil(oh / 32) * 32)
        bw = int(math.ceil(ow / 32) * 32)
        padded = np.zeros((1, bh, bw, 3), np.float32)
        padded[0, :oh, :ow] = norm

        det = self.eval_fn(torch.from_numpy(padded),
                           torch.tensor([[float(oh), float(ow)]]))
        det = {k: v[0].cpu().numpy() for k, v in det.items()}
        valid = det["valid"]
        boxes, scores, labels = (det["boxes"][valid], det["scores"][valid],
                                 det["labels"][valid])
        keep = scores >= self.confidence_threshold
        boxes = boxes[keep] * np.array(
            [w / ow, h / oh, w / ow, h / oh], np.float32)
        return boxes, scores[keep], labels[keep]

    def run_on_opencv_image(self, image_bgr):
        """The image with the detections drawn (needs cv2)."""
        import cv2

        boxes, scores, labels = self.compute_prediction(image_bgr)
        out = image_bgr.copy()
        for box, score, label in zip(boxes, scores, labels):
            x1, y1, x2, y2 = (int(v) for v in box)
            cv2.rectangle(out, (x1, y1), (x2, y2), (0, 255, 0), 2)
            name = (COCO_CATEGORIES[int(label)]
                    if int(label) < len(COCO_CATEGORIES)
                    else str(int(label)))
            cv2.putText(out, f"{name}: {score:.2f}", (x1, max(y1 - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
        return out

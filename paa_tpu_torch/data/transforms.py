"""Image transforms (port of paa_tpu/data/transforms.py).

Mirrors reference paa_core/data/transforms/transforms.py: shortest-side
resize with a cap on the longest (Resize.get_size, transforms.py:35-55),
horizontal flip with the BoxList +1-pixel transpose rule
(bounding_box.py:180-199), and Caffe2 BGR x255 mean subtraction
(transforms.py:84-97). Images are BGR uint8 HWC, as cv2 decodes them.

The JAX package resizes with ``cv2.resize(..., INTER_LINEAR)``. The
port does not depend on cv2: ``resize_uint8_linear`` computes the same
pixels, bit for bit, in integer arithmetic on torch tensors (torch ops
release the GIL, so the loader's threads run it in parallel). It is the
one image resize of the port, whatever is installed.
"""

from __future__ import annotations

import random
import threading

import numpy as np
import torch

from ..structures.keypoints import flip_keypoints, resize_keypoints

# cv2's fixed-point scale of the interpolation weights
# (INTER_RESIZE_COEF_BITS = 11)
_COEF_SCALE = 2048


def _linear_taps(n_in, n_out):
    """cv2's per-axis source index and fixed-point weights: for each
    output position d, f = float32((d + 0.5) * (1 / (n_out / n_in)) -
    0.5), s = floor(f), f -= s, and the weights rint((1 - f) * 2048) and
    rint(f * 2048), each rounded on its own (they need not sum to 2048;
    cvRound rounds half to even, as torch.round does)."""
    scale = 1.0 / (n_out / n_in)
    d = torch.arange(n_out, dtype=torch.float64)
    f = ((d + 0.5) * scale - 0.5).to(torch.float32)
    s = torch.floor(f)
    f = f - s
    w0 = torch.round((1 - f) * _COEF_SCALE).to(torch.int32)
    w1 = torch.round(f * _COEF_SCALE).to(torch.int32)
    return s.to(torch.int64), w0, w1


def resize_uint8_linear(image, ow, oh):
    """Resize a uint8 (H, W) or (H, W, C) image to (oh, ow) with the
    pixels of ``cv2.resize(image, (ow, oh), interpolation=INTER_LINEAR)``
    (OpenCV's fixed-point uint8 path, resize.cpp):

    - horizontally, each output is S[x0] * a0 + S[x1] * a1 in int32. An
      output whose taps leave the row (s < 0 or s + 1 >= W) takes the
      clamped pixel with weights (2048, 0);
    - vertically the rows are clamped to the image but the weights are
      kept as computed; the sum is OpenCV's vector form
      ``((h0 >> 4) * b0 >> 16) + ((h1 >> 4) * b1 >> 16) + 2 >> 2``,
      saturated to uint8 (its scalar form, (v + 2**21) >> 22, differs in
      about 12% of pixels; OpenCV's x86 build takes the vector form).

    An exact 2x downscale in both axes is routed by OpenCV to INTER_AREA,
    whose (a + b + c + d + 2) >> 2 the formula above gives as well
    (weights 1024, 1024); tests/test_torch_port_data.py holds it to both
    flags of cv2. Returns a numpy uint8 array of the input's layout.
    Every intermediate fits int32: 255 * 2049 per tap sum, 32,655 * 2048
    per product."""
    t = torch.from_numpy(np.ascontiguousarray(image))
    if t.dtype != torch.uint8 or t.dim() not in (2, 3):
        raise ValueError(f"resize_uint8_linear takes uint8 (H, W[, C]), "
                         f"got {t.dtype} {tuple(t.shape)}")
    if ow <= 0 or oh <= 0 or 0 in t.shape:
        raise ValueError(f"resize {tuple(t.shape)} to ({oh}, {ow})")
    flat = t.dim() == 2
    if flat:
        t = t[:, :, None]
    h, w = t.shape[:2]
    sx, a0, a1 = _linear_taps(w, ow)
    border = (sx < 0) | (sx + 1 >= w)
    x0 = sx.clamp(0, w - 1)
    x1 = torch.where(border, x0, x0 + 1)
    a0 = torch.where(border, _COEF_SCALE, a0)[None, :, None]
    a1 = torch.where(border, 0, a1)[None, :, None]
    sy, b0, b1 = _linear_taps(h, oh)
    y0, y1 = sy.clamp(0, h - 1), (sy + 1).clamp(0, h - 1)
    src = t.to(torch.int32)
    hx = (src[:, x0] * a0 + src[:, x1] * a1) >> 4
    out = ((hx[y0] * b0[:, None, None]) >> 16) + (
        (hx[y1] * b1[:, None, None]) >> 16)
    out = ((out + 2) >> 2).clamp_(0, 255).to(torch.uint8)
    return (out[:, :, 0] if flat else out).numpy()


def get_resize_size(image_wh, size, max_size):
    """Exact reference resize rule (transforms.py:35-55).

    image_wh: (w, h); returns (oh, ow).
    """
    w, h = image_wh
    if max_size is not None:
        min_original = float(min(w, h))
        max_original = float(max(w, h))
        if max_original / min_original * size > max_size:
            size = int(round(max_size * min_original / max_original))

    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return (oh, ow)


def resize_image_and_boxes(image, boxes, size, max_size):
    """Resize keeping aspect: the shorter side to ``size``, the longer at
    most ``max_size``; boxes scale with the image."""
    h, w = image.shape[:2]
    oh, ow = get_resize_size((w, h), size, max_size)
    resized = resize_uint8_linear(image, ow, oh)
    if boxes is not None and len(boxes):
        # BoxList.resize uses independent x/y ratios, no +1 correction
        ratio_w = ow / w
        ratio_h = oh / h
        boxes = boxes * np.array(
            [ratio_w, ratio_h, ratio_w, ratio_h], dtype=np.float32
        )
    return resized, boxes


def hflip_image_and_boxes(image, boxes):
    """Horizontal flip; boxes follow BoxList.transpose(0) with
    TO_REMOVE=1 (bounding_box.py:188-193)."""
    image = np.ascontiguousarray(image[:, ::-1])
    if boxes is not None and len(boxes):
        w = image.shape[1]
        x1 = w - boxes[:, 2] - 1.0
        x2 = w - boxes[:, 0] - 1.0
        boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], axis=1)
    return image, boxes


def normalize_image(image, pixel_mean, pixel_std, out=None):
    """uint8 BGR -> float32 normalized (Caffe2: mean subtract, std 1).

    ``out``: optional preallocated float32 destination (a view into the
    padded batch buffer): the subtract writes straight into it. The same
    (x - mean) then / std op order in float32 as out of place.
    """
    mean = np.asarray(pixel_mean, dtype=np.float32)
    std = np.asarray(pixel_std, dtype=np.float32)
    img = np.subtract(image, mean, out=out, dtype=np.float32)
    if np.any(std != 1.0):
        np.divide(img, std, out=img)
    return img


class TrainTransform:
    def __init__(self, min_sizes, max_size, pixel_mean, pixel_std,
                 flip_prob=0.5, seed=None, defer_normalize=False):
        """``defer_normalize``: return the resized/flipped uint8 image
        and let the caller normalize (the loader writes (x - mean)/std
        straight into the padded batch, or leaves it to the device)."""
        self.min_sizes = (
            list(min_sizes) if isinstance(min_sizes, (list, tuple))
            else [min_sizes]
        )
        self.max_size = max_size
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.flip_prob = flip_prob
        self.defer_normalize = defer_normalize
        self.rng = random.Random(seed)
        self._lock = threading.Lock()

    def __call__(self, image, boxes, draws=None, masks=None,
                 keypoints=None):
        """``draws=(size_draw, flip_draw)`` in [0, 1) makes the
        augmentation deterministic per sample: the loader derives them
        from (seed, epoch, index), so every data-parallel process agrees
        on the realized sizes (and so the buckets) without communication.
        Without ``draws`` the shared RNG is used (thread order then
        decides which sample gets which draw).

        ``masks``: the instances' box-normalized masks (n, M, M); they do
        not change with the resize and flip with the image.
        ``keypoints``: the instances' (n, K, 3) keypoints; they scale
        with the resize and flip with the image (left and right swapped,
        the invisible ones zeroed). Returns (image, boxes), then the
        masks and the keypoints, each when given."""
        if draws is None:
            with self._lock:  # the shared RNG is used from loader threads
                size_draw = self.rng.random()
                flip_draw = self.rng.random()
        else:
            size_draw, flip_draw = draws
        oh, ow = image.shape[:2]
        image, boxes = resize_image_and_boxes(
            image, boxes,
            self.min_sizes[int(size_draw * len(self.min_sizes))],
            self.max_size,
        )
        keypoints = _resized_keypoints(keypoints, image, oh, ow)
        if flip_draw < self.flip_prob:
            image, boxes = hflip_image_and_boxes(image, boxes)
            if masks is not None:
                masks = np.ascontiguousarray(masks[:, :, ::-1])
            if keypoints is not None and len(keypoints):
                keypoints = flip_keypoints(keypoints, image.shape[1])
        if not self.defer_normalize:
            image = normalize_image(image, self.pixel_mean, self.pixel_std)
        return _with_fields(image, boxes, masks, keypoints)


class EvalTransform:
    def __init__(self, min_size, max_size, pixel_mean, pixel_std,
                 defer_normalize=False):
        self.min_size = min_size
        self.max_size = max_size
        self.pixel_mean = pixel_mean
        self.pixel_std = pixel_std
        self.defer_normalize = defer_normalize

    def __call__(self, image, boxes=None, draws=None, masks=None,
                 keypoints=None):
        oh, ow = image.shape[:2]
        image, boxes = resize_image_and_boxes(
            image, boxes, self.min_size, self.max_size
        )
        keypoints = _resized_keypoints(keypoints, image, oh, ow)
        if not self.defer_normalize:
            image = normalize_image(image, self.pixel_mean, self.pixel_std)
        return _with_fields(image, boxes, masks, keypoints)


def _resized_keypoints(keypoints, image, oh, ow):
    """(n, K, 3) keypoints of an (oh, ow) image scaled to ``image``'s
    size (None and empty arrays pass through)."""
    if keypoints is None or not len(keypoints):
        return keypoints
    nh, nw = image.shape[:2]
    return resize_keypoints(keypoints, nw / ow, nh / oh)


def _with_fields(image, boxes, masks, keypoints):
    out = (image, boxes)
    if masks is not None:
        out = out + (masks,)
    if keypoints is not None:
        out = out + (keypoints,)
    return out


def build_transforms(cfg, is_train=True, seed=None,
                     defer_normalize=False):
    """Mirror of reference data/transforms/build.py:5-36 incl. the
    MIN_SIZE_RANGE_TRAIN expansion."""
    if is_train:
        if cfg.INPUT.MIN_SIZE_RANGE_TRAIN[0] == -1:
            min_size = cfg.INPUT.MIN_SIZE_TRAIN
        else:
            lo, hi = cfg.INPUT.MIN_SIZE_RANGE_TRAIN
            min_size = list(range(lo, hi + 1))
        return TrainTransform(
            min_size, cfg.INPUT.MAX_SIZE_TRAIN, cfg.INPUT.PIXEL_MEAN,
            cfg.INPUT.PIXEL_STD, flip_prob=0.5, seed=seed,
            defer_normalize=defer_normalize,
        )
    return EvalTransform(
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST,
        cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
        defer_normalize=defer_normalize,
    )

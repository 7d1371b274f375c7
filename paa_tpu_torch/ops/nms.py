"""Static-shape greedy (multi-label) NMS (port of paa_tpu/ops/nms.py and
the TPU kernels of paa_tpu/ops/nms_pallas.py).

``max_out`` pick-the-max / suppress steps per image: greedy NMS selects
survivors in descending score order, so the first ``max_out`` picks
equal full NMS followed by the reference's top-k cap
(paa/inference.py:110-121). IoU uses the +1 Detectron convention of the
reference's csrc/cuda/ml_nms.cu:17-23.

Every entry point dispatches on the tensors' device: the plain PyTorch
version below for CPU tensors, a CUDA kernel for CUDA tensors, with no
fallback between the two:

- K1, csrc/nms_batched.cu (``nms_pallas_batched``): one CTA per image
  with its candidates in shared memory, up to ``k1_max_candidates``;
- K2, csrc/nms_global.cu (``nms_pallas``): one CTA per image over a
  scratch buffer in device memory, any N.

``nms_batched`` takes K1 where the image fits and K2 otherwise; ``nms``
(one image) always takes K2. The kernels share their argmax and IoU in
csrc/nms_common.cuh; each kernel's header says what bounds it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_NEG_INF = -1e30


def nms_batched_plain(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware=True):
    """The plain PyTorch version: ``max_out`` argmax/IoU/suppress steps
    over the whole (B, N) batch, in the TPU kernel's op order.

    boxes (B, N, 4); scores, labels, valid (B, N) -> keep_idx (int32),
    keep_scores (float32), keep_valid (bool), each (B, max_out).
    """
    bsz, n = scores.shape
    dev = scores.device
    live = torch.where(
        valid, scores.to(torch.float32),
        torch.tensor(_NEG_INF, dtype=torch.float32, device=dev),
    )
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    cols = torch.arange(n, device=dev).expand(bsz, n)
    thresh = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    keep_idx = torch.zeros(bsz, max_out, dtype=torch.int32, device=dev)
    keep_scores = torch.full((bsz, max_out), _NEG_INF, dtype=torch.float32,
                             device=dev)
    keep_valid = torch.zeros(bsz, max_out, dtype=torch.bool, device=dev)
    for i in range(max_out):
        best = live.max(dim=1, keepdim=True).values
        idx = torch.where(live == best, cols, n).min(dim=1,
                                                      keepdim=True).values
        ok = best > _NEG_INF / 2
        if not bool(ok.any()):
            break  # every row exhausted: later slots keep their init
        pick = lambda t: t.gather(1, idx)  # noqa: E731
        w = (torch.minimum(pick(x2), x2) - torch.maximum(pick(x1), x1)
             + 1.0).clamp(min=0.0)
        h = (torch.minimum(pick(y2), y2) - torch.maximum(pick(y1), y1)
             + 1.0).clamp(min=0.0)
        inter = w * h
        iou = inter / (pick(area) + area - inter)
        suppress = iou > thresh
        if class_aware:
            suppress = suppress & (labels == pick(labels))
        suppress = suppress | (cols == idx)
        live = torch.where(suppress & ok, neg_inf, live)
        keep_idx[:, i] = idx[:, 0].to(torch.int32)
        keep_scores[:, i] = best[:, 0]
        keep_valid[:, i] = ok[:, 0]
    return keep_idx, keep_scores, keep_valid


def _check_inputs(boxes, scores, labels, valid):
    bsz, n = scores.shape
    if boxes.shape != (bsz, n, 4):
        raise ValueError(f"boxes {tuple(boxes.shape)} vs scores {(bsz, n)}")
    expect = ((boxes, torch.float32, "boxes"), (scores, torch.float32,
              "scores"), (labels, torch.int32, "labels"),
              (valid, torch.bool, "valid"))
    for t, dtype, name in expect:
        if t.dtype != dtype or t.device != scores.device:
            raise TypeError(
                f"{name}: {t.dtype} on {t.device}, the kernel takes "
                f"{dtype} on {scores.device}"
            )


def _empty_keeps(bsz, max_out, device):
    return (torch.empty(bsz, max_out, dtype=torch.int32, device=device),
            torch.empty(bsz, max_out, dtype=torch.float32, device=device),
            torch.empty(bsz, max_out, dtype=torch.bool, device=device))


def _launch(fn, name, boxes, scores, labels, valid, iou_threshold, max_out,
            class_aware, *scratch):
    """Launch a kernel of the (boxes, scores, labels, valid, B, N, thresh,
    max_out, class_aware, [scratch,] keeps..., stream) interface."""
    bsz, n = scores.shape
    keeps = _empty_keeps(bsz, max_out, scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = fn(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), bsz, n, float(iou_threshold), max_out,
        int(bool(class_aware)), *(t.data_ptr() for t in scratch),
        *(t.data_ptr() for t in keeps), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return keeps


# boxes, scores, labels, valid, B, N, thresh, max_out, class_aware; then
# (K2 only) the scratch buffer; then the three keeps and the stream
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_INPUT_ARGS = [_VP] * 4 + [_CI, _CI, ctypes.c_float, _CI, _CI]
_OUTPUT_ARGS = [_VP] * 4


@functools.cache
def _k1_lib():
    lib = _build.load("nms_batched")
    lib.paa_nms_batched.argtypes = _INPUT_ARGS + _OUTPUT_ARGS
    lib.paa_nms_batched.restype = _CI
    lib.paa_nms_batched_max_candidates.argtypes = []
    lib.paa_nms_batched_max_candidates.restype = _CI
    return lib


@functools.cache
def _k2_lib():
    lib = _build.load("nms_global")
    lib.paa_nms_global.argtypes = _INPUT_ARGS + [_VP] + _OUTPUT_ARGS
    lib.paa_nms_global.restype = _CI
    return lib


def k1_max_candidates(device):
    """The most candidates per image the batched kernel (K1) holds in one
    CTA's shared memory on ``device`` (8,265 on an H100)."""
    with torch.cuda.device(device):
        return _k1_lib().paa_nms_batched_max_candidates()


def _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware):
    """K1: csrc/nms_batched.cu, one CTA per image, candidates in shared
    memory; raises for N above what it holds."""
    _check_inputs(boxes, scores, labels, valid)
    bsz, n = scores.shape
    if bsz == 0 or max_out == 0:
        return _empty_keeps(bsz, max_out, scores.device)
    limit = k1_max_candidates(scores.device)
    if not 0 < n <= limit:
        raise ValueError(
            f"nms_batched kernel holds 1..{limit} candidates per image "
            f"in shared memory, got {n}"
        )
    with torch.cuda.device(scores.device):
        keeps = _launch(
            _k1_lib().paa_nms_batched, "nms_batched",
            *(t.contiguous() for t in (boxes, scores, labels, valid)),
            iou_threshold, max_out, class_aware,
        )
    nms_batched.launches += 1
    return keeps


def _device_type(scores, name):
    kind = scores.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {scores.device}")
    return kind


def _nms_global(boxes, scores, labels, valid, iou_threshold, max_out,
                class_aware=True):
    """``nms_batched`` at any N per image: CPU tensors take the plain
    version; CUDA tensors launch K2 (csrc/nms_global.cu, one CTA per
    image over a (B, 7, N) scratch buffer in device memory; counted in
    ``_nms_global.launches``) or raise."""
    if _device_type(scores, "nms") == "cpu":
        return nms_batched_plain(boxes, scores, labels, valid,
                                 iou_threshold, max_out, class_aware)
    _check_inputs(boxes, scores, labels, valid)
    bsz, n = scores.shape
    if bsz == 0 or max_out == 0:
        return _empty_keeps(bsz, max_out, scores.device)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel loads a box as one float4
        boxes = boxes.clone()
    scratch = torch.empty(bsz, 7, n, dtype=torch.float32,
                          device=scores.device)
    with torch.cuda.device(scores.device):
        keeps = _launch(
            _k2_lib().paa_nms_global, "nms_global", boxes,
            *(t.contiguous() for t in (scores, labels, valid)),
            iou_threshold, max_out, class_aware, scratch,
        )
    _nms_global.launches += 1
    return keeps


def nms_batched(boxes, scores, labels, valid, iou_threshold, max_out,
                class_aware=True):
    """Batched greedy NMS: boxes (B, N, 4) float32, scores (B, N) float32,
    labels (B, N) int32, valid (B, N) bool -> keep_idx (int32),
    keep_scores (float32), keep_valid (bool), each (B, max_out).

    CPU tensors take the plain version. CUDA tensors launch K1 (counted
    in ``nms_batched.launches``) up to ``k1_max_candidates`` per image,
    and K2 (``_nms_global``) above that: the shape alone chooses, as the
    JAX package chunks images by a VMEM budget. A kernel that fails
    raises; nothing falls back."""
    if _device_type(scores, "nms_batched") == "cpu":
        return nms_batched_plain(boxes, scores, labels, valid,
                                 iou_threshold, max_out, class_aware)
    if scores.shape[1] > k1_max_candidates(scores.device):
        return _nms_global(boxes, scores, labels, valid, iou_threshold,
                           max_out, class_aware)
    return _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold,
                             max_out, class_aware)


def nms(boxes, scores, labels, valid, iou_threshold, max_out,
        class_aware=True):
    """Single-image greedy NMS (the counterpart of paa_tpu's ``nms_auto``):
    boxes (N, 4), scores/labels/valid (N,) -> (max_out,) keeps. CUDA
    tensors launch K2, CPU tensors take the plain version."""
    out = _nms_global(boxes[None], scores[None], labels[None], valid[None],
                      iou_threshold, max_out, class_aware=class_aware)
    return tuple(t[0] for t in out)


nms_batched.launches = 0
_nms_global.launches = 0

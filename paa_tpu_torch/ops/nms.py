"""Static-shape greedy (multi-label) NMS (port of paa_tpu/ops/nms.py and
the batched TPU kernel paa_tpu/ops/nms_pallas.py::nms_pallas_batched).

``max_out`` pick-the-max / suppress steps per image: greedy NMS selects
survivors in descending score order, so the first ``max_out`` picks
equal full NMS followed by the reference's top-k cap
(paa/inference.py:110-121). IoU uses the +1 Detectron convention of the
reference's csrc/cuda/ml_nms.cu:17-23.

``nms_batched`` dispatches on the tensors' device: the plain PyTorch
version below for CPU tensors, the CUDA kernel of csrc/nms_batched.cu
(its header says what bounds it and how it is built) for CUDA tensors.
There is no fallback between the two.
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


def nms(boxes, scores, labels, valid, iou_threshold, max_out,
        class_aware=True):
    """Plain single-image NMS: boxes (N, 4), scores/labels/valid (N,) ->
    (max_out,) keeps."""
    out = nms_batched_plain(
        boxes[None], scores[None], labels[None], valid[None],
        iou_threshold, max_out, class_aware=class_aware,
    )
    return tuple(t[0] for t in out)


def _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware):
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
    keep_idx = torch.empty(bsz, max_out, dtype=torch.int32,
                           device=scores.device)
    keep_scores = torch.empty(bsz, max_out, dtype=torch.float32,
                              device=scores.device)
    keep_valid = torch.empty(bsz, max_out, dtype=torch.bool,
                             device=scores.device)
    if bsz == 0 or max_out == 0:
        return keep_idx, keep_scores, keep_valid
    lib = _lib()
    with torch.cuda.device(scores.device):
        limit = lib.paa_nms_batched_max_candidates()
        if not 0 < n <= limit:
            raise ValueError(
                f"nms_batched kernel holds 1..{limit} candidates per image "
                f"in shared memory, got {n}"
            )
        boxes, scores, labels, valid = (
            t.contiguous() for t in (boxes, scores, labels, valid)
        )
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = lib.paa_nms_batched(
            boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            valid.data_ptr(), bsz, n, float(iou_threshold), max_out,
            int(bool(class_aware)), keep_idx.data_ptr(),
            keep_scores.data_ptr(), keep_valid.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_batched kernel launch failed: CUDA error {err}")
    nms_batched.launches += 1
    return keep_idx, keep_scores, keep_valid


@functools.cache
def _lib():
    lib = _build.load("nms_batched")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paa_nms_batched.argtypes = [
        vp, vp, vp, vp, ci, ci, ctypes.c_float, ci, ci, vp, vp, vp, vp,
    ]
    lib.paa_nms_batched.restype = ci
    lib.paa_nms_batched_max_candidates.argtypes = []
    lib.paa_nms_batched_max_candidates.restype = ci
    return lib


def nms_batched(boxes, scores, labels, valid, iou_threshold, max_out,
                class_aware=True):
    """Batched greedy NMS: boxes (B, N, 4) float32, scores (B, N) float32,
    labels (B, N) int32, valid (B, N) bool -> keep_idx (int32),
    keep_scores (float32), keep_valid (bool), each (B, max_out).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``nms_batched.launches``) or raise."""
    if scores.device.type == "cpu":
        return nms_batched_plain(boxes, scores, labels, valid,
                                 iou_threshold, max_out, class_aware)
    if scores.device.type != "cuda":
        raise ValueError(f"nms_batched: no kernel for {scores.device}")
    return _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold,
                             max_out, class_aware)


nms_batched.launches = 0

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
  sorts the image's live candidates by (score desc, index asc) in shared
  memory, then sweeps them in tiles of 32, up to ``k1_max_candidates``;
- K2, csrc/nms_global.cu (``nms_pallas``), any N, by one of two routes
  that ``k2_plan`` picks from N alone: one thread-block cluster of cs
  CTAs per image with the valid candidates in shared memory, up to 16
  CTAs' capacity; above that, one CTA per image over a scratch buffer in
  device memory.

``nms_batched`` takes K1 where the image fits and K2 otherwise; ``nms``
(one image) always takes K2. The kernels share the bit-exact IoU in
csrc/nms_common.cuh (with K2's argmax and K1's sort key); each kernel's
header says what bounds it.

Both entry points are ``torch.library`` custom ops,
``paa_tpu_torch::nms_batched`` and ``paa_tpu_torch::nms``, so that
``torch.export`` records each as one node (serving.py): their fake
implementation gives the static (B, max_out) outputs, and every check
that reads a tensor's storage or pointer runs inside the op, at call
time. Each op's implementation is one function for both devices, which
takes the plain version for CPU tensors and launches the kernel for
CUDA tensors.

A valid NaN score ends its image before the first pick, as in the JAX
package, where the step's max is then NaN. Slots without a pick hold
(idx 0, score -1e30, valid False) in every entry point; the JAX package
writes other values there, and its scan and Pallas routes differ from
each other (a NaN image gives idx 7 from one and 383 from the other at
N=300, score NaN), so only valid slots carry meaning.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_NEG_INF = -1e30
# K2's cluster route: at most 16 CTAs per image (a non-portable cluster
# size; 8 is the portable one)
K2_MAX_CLUSTER = 16


def nms_batched_plain(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware=True):
    """The plain PyTorch version: ``max_out`` argmax/IoU/suppress steps
    over the whole (B, N) batch, in the TPU kernel's op order. A row
    whose max is NaN (a valid NaN score) is exhausted from the start.

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
        idx = idx.clamp(max=n - 1)  # a NaN best matches no column
        ok = best > _NEG_INF / 2  # False for NaN
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
        keep_idx[:, i] = torch.where(ok, idx, 0)[:, 0].to(torch.int32)
        keep_scores[:, i] = torch.where(ok, best, neg_inf)[:, 0]
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


def _aligned_boxes(boxes):
    """``boxes``, contiguous and 16-byte aligned: both kernels load a box
    as one float4."""
    boxes = boxes.contiguous()
    return boxes.clone() if boxes.data_ptr() % 16 else boxes


def _launch(fn, name, boxes, scores, labels, valid, iou_threshold, max_out,
            class_aware, extra):
    """Launch a kernel of the (boxes, scores, labels, valid, B, N, thresh,
    max_out, class_aware, extra, keeps..., stream) interface; ``extra``
    is K1's tiles pointer or K2's cluster size or scratch pointer, passed
    as given."""
    bsz, n = scores.shape
    keeps = _empty_keeps(bsz, max_out, scores.device)
    stream = torch.cuda.current_stream(scores.device).cuda_stream
    err = fn(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        valid.data_ptr(), bsz, n, float(iou_threshold), max_out,
        int(bool(class_aware)), extra,
        *(t.data_ptr() for t in keeps), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return keeps


# boxes, scores, labels, valid, B, N, thresh, max_out, class_aware; then
# K1's tiles-swept buffer (or null), or K2's cluster size or scratch
# buffer; then the three keeps and the stream
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_INPUT_ARGS = [_VP] * 4 + [_CI, _CI, ctypes.c_float, _CI, _CI]
_OUTPUT_ARGS = [_VP] * 4


@functools.cache
def _k1_lib():
    lib = _build.load("nms_batched")
    lib.paa_nms_batched.argtypes = _INPUT_ARGS + [_VP] + _OUTPUT_ARGS
    lib.paa_nms_batched.restype = _CI
    lib.paa_nms_batched_max_candidates.argtypes = []
    lib.paa_nms_batched_max_candidates.restype = _CI
    return lib


@functools.cache
def _k2_lib():
    lib = _build.load("nms_global")
    lib.paa_nms_global.argtypes = _INPUT_ARGS + [_VP] + _OUTPUT_ARGS
    lib.paa_nms_cluster.argtypes = _INPUT_ARGS + [_CI] + _OUTPUT_ARGS
    lib.paa_nms_cluster_capacity.argtypes = []
    lib.paa_nms_cluster_max_active.argtypes = [_CI, _CI]
    for fn in (lib.paa_nms_global, lib.paa_nms_cluster,
               lib.paa_nms_cluster_capacity, lib.paa_nms_cluster_max_active):
        fn.restype = _CI
    return lib


@functools.cache
def k1_max_candidates(device):
    """The most candidates per image the batched kernel (K1) takes on
    ``device``: 8,192 on an H100, the capacity of its sort (8 keys per
    thread), whose shared memory (28 bytes per candidate) fits."""
    with torch.cuda.device(device):
        return _k1_lib().paa_nms_batched_max_candidates()


@functools.cache
def k2_capacity(device):
    """The most candidates one CTA of K2's cluster route holds in shared
    memory on ``device`` (8,900 on an H100: 26 bytes each)."""
    with torch.cuda.device(device):
        return _k2_lib().paa_nms_cluster_capacity()


def k2_plan(n, capacity):
    """K2's route for ``n`` candidates per image, from N alone:
    ``("cluster", cs)`` with the smallest cluster size cs whose CTAs each
    hold ceil(n / cs) candidates even if all are valid, or
    ``("scratch", 1)`` when more than K2_MAX_CLUSTER CTAs would be
    needed."""
    cs = max(1, -(-n // capacity))
    return ("cluster", cs) if cs <= K2_MAX_CLUSTER else ("scratch", 1)


def k2_max_active_clusters(device, n):
    """cudaOccupancyMaxActiveClusters of K2's cluster route at ``n``
    candidates per image: how many images run at once."""
    route, cs = k2_plan(n, k2_capacity(device))
    if route != "cluster":
        return 0
    with torch.cuda.device(device):
        return _k2_lib().paa_nms_cluster_max_active(cs, n)


def _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware, tiles=None):
    """K1: csrc/nms_batched.cu, one CTA per image, which sorts its live
    candidates in shared memory and sweeps them in tiles; raises for N
    above what it holds. ``tiles``, an int32 (B,) tensor on the same
    device, receives the tiles each image swept."""
    _check_inputs(boxes, scores, labels, valid)
    bsz, n = scores.shape
    if tiles is not None and (tiles.shape != (bsz,)
                              or tiles.dtype != torch.int32
                              or tiles.device != scores.device
                              or not tiles.is_contiguous()):
        raise TypeError(f"tiles: {tiles.dtype} {tuple(tiles.shape)} on "
                        f"{tiles.device}, the kernel takes int32 ({bsz},) "
                        f"on {scores.device}")
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
            _k1_lib().paa_nms_batched, "nms_batched", _aligned_boxes(boxes),
            *(t.contiguous() for t in (scores, labels, valid)),
            iou_threshold, max_out, class_aware,
            None if tiles is None else tiles.data_ptr(),
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
    version; CUDA tensors launch K2 (csrc/nms_global.cu, by the route
    ``k2_plan`` picks; counted in ``_nms_global.launches``) or raise."""
    if _device_type(scores, "nms") == "cpu":
        return nms_batched_plain(boxes, scores, labels, valid,
                                 iou_threshold, max_out, class_aware)
    _check_inputs(boxes, scores, labels, valid)
    bsz, n = scores.shape
    if bsz == 0 or max_out == 0:
        return _empty_keeps(bsz, max_out, scores.device)
    route, cs = k2_plan(n, k2_capacity(scores.device))
    if route == "cluster":
        fn, extra = _k2_lib().paa_nms_cluster, cs
    else:
        scratch = torch.empty(bsz, 7, n, dtype=torch.float32,
                              device=scores.device)
        fn, extra = _k2_lib().paa_nms_global, scratch.data_ptr()
    with torch.cuda.device(scores.device):
        keeps = _launch(
            fn, "nms_global", _aligned_boxes(boxes),
            *(t.contiguous() for t in (scores, labels, valid)),
            iou_threshold, max_out, class_aware, extra,
        )
    _nms_global.launches += 1
    return keeps


_Keeps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _nms_batched_impl(boxes, scores, labels, valid, iou_threshold, max_out,
                      class_aware):
    """``paa_tpu_torch::nms_batched`` on either device: the plain version
    for CPU tensors; for CUDA tensors K1 up to ``k1_max_candidates`` per
    image, K2 (``_nms_global``) above that."""
    if _device_type(scores, "nms_batched") == "cpu":
        return nms_batched_plain(boxes, scores, labels, valid,
                                 iou_threshold, max_out, class_aware)
    if scores.shape[1] > k1_max_candidates(scores.device):
        return _nms_global(boxes, scores, labels, valid, iou_threshold,
                           max_out, class_aware)
    return _nms_batched_cuda(boxes, scores, labels, valid, iou_threshold,
                             max_out, class_aware)


@torch.library.custom_op("paa_tpu_torch::nms_batched", mutates_args=(),
                         device_types="cpu")
def _nms_batched_op(boxes: torch.Tensor, scores: torch.Tensor,
                    labels: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float, max_out: int,
                    class_aware: bool) -> _Keeps:
    return _nms_batched_impl(boxes, scores, labels, valid, iou_threshold,
                             max_out, class_aware)


def _nms_one_impl(boxes, scores, labels, valid, iou_threshold, max_out,
                  class_aware):
    """``paa_tpu_torch::nms`` on either device: one image as a batch of
    one through ``_nms_global`` (K2, or the plain version on the CPU)."""
    out = _nms_global(boxes[None], scores[None], labels[None], valid[None],
                      iou_threshold, max_out, class_aware=class_aware)
    return tuple(t[0] for t in out)


@torch.library.custom_op("paa_tpu_torch::nms", mutates_args=(),
                         device_types="cpu")
def _nms_op(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
            valid: torch.Tensor, iou_threshold: float, max_out: int,
            class_aware: bool) -> _Keeps:
    return _nms_one_impl(boxes, scores, labels, valid, iou_threshold,
                         max_out, class_aware)


_nms_batched_op.register_kernel("cuda")(_nms_batched_impl)
_nms_op.register_kernel("cuda")(_nms_one_impl)


@_nms_batched_op.register_fake
def _(boxes, scores, labels, valid, iou_threshold, max_out, class_aware):
    return _empty_keeps(scores.shape[0], max_out, scores.device)


@_nms_op.register_fake
def _(boxes, scores, labels, valid, iou_threshold, max_out, class_aware):
    keeps = _empty_keeps(1, max_out, scores.device)
    return tuple(t[0] for t in keeps)


def nms_batched(boxes, scores, labels, valid, iou_threshold, max_out,
                class_aware=True):
    """Batched greedy NMS: boxes (B, N, 4) float32, scores (B, N) float32,
    labels (B, N) int32, valid (B, N) bool -> keep_idx (int32),
    keep_scores (float32), keep_valid (bool), each (B, max_out).

    CPU tensors take the plain version. CUDA tensors launch K1 (counted
    in ``nms_batched.launches``) up to ``k1_max_candidates`` per image,
    and K2 (``_nms_global``) above that: the shape alone chooses, as the
    JAX package chunks images by a VMEM budget. A kernel that fails
    raises; nothing falls back. The call is the custom op
    ``paa_tpu_torch::nms_batched``."""
    _device_type(scores, "nms_batched")
    return _nms_batched_op(boxes, scores, labels, valid,
                           float(iou_threshold), int(max_out),
                           bool(class_aware))


def nms(boxes, scores, labels, valid, iou_threshold, max_out,
        class_aware=True):
    """Single-image greedy NMS (the counterpart of paa_tpu's ``nms_auto``):
    boxes (N, 4), scores/labels/valid (N,) -> (max_out,) keeps. CUDA
    tensors launch K2, CPU tensors take the plain version: the custom op
    ``paa_tpu_torch::nms``."""
    _device_type(scores, "nms")
    return _nms_op(boxes, scores, labels, valid, float(iou_threshold),
                   int(max_out), bool(class_aware))


nms_batched.launches = 0
_nms_global.launches = 0

"""ctypes binding of the native COCO matcher (port of
paa_tpu/evaluation/_native.py).

``csrc/cocoeval.cpp`` is compiled with g++ at first use into
``paa_tpu_torch/_build/`` (ops/_build.py::load_host), never next to the
source. A failed build raises: the evaluator has no silent numpy route.
The numpy loops of evaluation/coco_eval.py are the plain versions the
tests hold these functions against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..ops import _build


@functools.cache
def _lib():
    lib = _build.load_host("cocoeval")
    dp, u8p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)
    lib.bbox_iou_xywh.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int, u8p,
                                  dp]
    lib.evaluate_img.argtypes = [
        dp, u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, dp, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), u8p,
    ]
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def bbox_iou_xywh(dts, gts, iscrowd):
    """(n_dt, n_gt) IoU of xywh boxes, crowd GTs with union = dt area."""
    dts = np.ascontiguousarray(dts, dtype=np.float64).reshape(-1, 4)
    gts = np.ascontiguousarray(gts, dtype=np.float64).reshape(-1, 4)
    iscrowd = np.ascontiguousarray(iscrowd, dtype=np.uint8)
    n_dt, n_gt = len(dts), len(gts)
    out = np.zeros((n_dt, n_gt), dtype=np.float64)
    if n_dt and n_gt:
        _lib().bbox_iou_xywh(
            _ptr(dts, ctypes.c_double), n_dt,
            _ptr(gts, ctypes.c_double), n_gt,
            _ptr(iscrowd, ctypes.c_uint8),
            _ptr(out, ctypes.c_double),
        )
    return out


def evaluate_img(ious, g_ig, g_crowd, dt_out_of_range, thrs):
    """Greedy per-image matching at every threshold: (dtm, dt_ig), each
    (T, n_dt)."""
    ious = np.ascontiguousarray(ious, dtype=np.float64)
    n_dt, n_gt = ious.shape
    g_ig = np.ascontiguousarray(g_ig, dtype=np.uint8)
    g_crowd = np.ascontiguousarray(g_crowd, dtype=np.uint8)
    oor = np.ascontiguousarray(dt_out_of_range, dtype=np.uint8)
    thrs = np.ascontiguousarray(thrs, dtype=np.float64)
    t = len(thrs)
    dtm = np.full((t, n_dt), -1, dtype=np.int64)
    dt_ig = np.zeros((t, n_dt), dtype=np.uint8)
    _lib().evaluate_img(
        _ptr(ious, ctypes.c_double),
        _ptr(g_ig, ctypes.c_uint8),
        _ptr(g_crowd, ctypes.c_uint8),
        _ptr(oor, ctypes.c_uint8),
        n_dt, n_gt,
        _ptr(thrs, ctypes.c_double), t,
        _ptr(dtm, ctypes.c_int64),
        _ptr(dt_ig, ctypes.c_uint8),
    )
    return dtm, dt_ig.astype(bool)

from .deform_sampling import deform_col2im, deform_im2col
from .group_norm import group_norm_relu
from .nms import nms_batched

__all__ = ["deform_col2im", "deform_im2col", "group_norm_relu",
           "launch_counts", "nms_batched"]


def launch_counts():
    """The kernels' launch counters in this process: K1
    (``nms_batched.launches``), K2 (``nms._nms_global.launches``), K3
    (``group_norm_relu.launches``), K4 (``deform_im2col.launches``) and
    K5 (``deform_col2im.launches``):
    each wrapper adds one where it launches its kernel on the card, the
    plain versions count nothing; and ROIAlign's calls and rois
    (``roi_align.COUNTS``), plain PyTorch on every device, counted
    wherever it runs."""
    from . import roi_align
    from .nms import _nms_global

    return {"nms_batched": nms_batched.launches,
            "nms_global": _nms_global.launches,
            "group_norm_relu": group_norm_relu.launches,
            "deform_im2col": deform_im2col.launches,
            "deform_col2im": deform_col2im.launches,
            **roi_align.COUNTS}

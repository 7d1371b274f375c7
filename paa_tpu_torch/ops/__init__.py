from .group_norm import group_norm_relu
from .nms import nms_batched

__all__ = ["group_norm_relu", "launch_counts", "nms_batched"]


def launch_counts():
    """The kernels' launch counters in this process: K1
    (``nms_batched.launches``), K2 (``nms._nms_global.launches``) and K3
    (``group_norm_relu.launches``). Each wrapper adds one where it
    launches its kernel on the card; the plain versions count nothing."""
    from .nms import _nms_global

    return {"nms_batched": nms_batched.launches,
            "nms_global": _nms_global.launches,
            "group_norm_relu": group_norm_relu.launches}

from .group_norm import group_norm_relu
from .nms import nms_batched

__all__ = ["group_norm_relu", "nms_batched"]

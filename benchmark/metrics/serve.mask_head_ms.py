"""Device busy ms per call of the kernels launched inside the program's
span ``two_stage/mask_head`` at inference (the 14x14 ROIAlign, 4 convs,
the deconv and the predictor on the detections, and their class
channel's sigmoid)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "two_stage/mask_head")

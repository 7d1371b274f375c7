"""Device busy ms per call of the kernels launched inside the program's
span ``two_stage/box_head`` (a two-stage model's box head on its
proposals: the 7x7 ROIAlign, fc6, fc7 and the predictor)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "two_stage/box_head")

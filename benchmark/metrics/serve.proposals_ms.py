"""Device busy ms per call of the kernels launched inside the program's
span ``two_stage/proposals`` (a two-stage model's proposal selection:
per-level top-k, decode and clip, K1 over every level's rows, the top
FPN_POST_NMS_TOP_N an image)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "two_stage/proposals")

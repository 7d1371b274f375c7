"""Device busy ms per call of the kernels launched inside the program's
span ``two_stage/box_postprocess`` (softmax, the per-class decode and
clip, the score threshold and the class-aware NMS, K2 at 81 classes)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "two_stage/box_postprocess")

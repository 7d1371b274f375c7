"""Device busy ms per call of the kernels launched inside the program's
span ``detector/postprocess`` (per-level selection, decode, clip, K1
NMS and score voting)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "detector/postprocess")

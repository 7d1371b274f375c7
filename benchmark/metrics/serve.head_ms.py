"""Device busy ms per call of the kernels launched inside the program's
span ``detector/head`` (the dense head: its towers, with K3, and its
predictors)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "detector/head")

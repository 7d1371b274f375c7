"""Device busy ms per call of the kernels launched inside the program's
span ``deform_conv2d/forward`` (every deformable conv's sampling and
contraction, in the body and in the head)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "deform_conv2d/forward")

"""Device busy ms per call of the kernels launched inside the program's
span ``detector/body`` (the ResNet or ResNeXt body: convs, FrozenBN,
the DCN of X-152's stages 3-5)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "detector/body")

"""Device busy ms per step of the kernels launched by the backward ops
whose forward op ran inside the program's span ``detector/head``: the
towers' and predictors' gradient, K3's plain-VJP recompute (inside the
``GroupNormReLU`` backward op) among it."""

from benchmark.harness.spans import backward_device_ms_per_step


def read(view):
    return backward_device_ms_per_step(view, "detector/head")

"""Device busy ms per step of the kernels launched by the backward ops
whose forward op ran inside the program's span ``detector/body`` (the
profiler's forward-backward link): the body's gradient, the DCN's
recompute and VJP among it."""

from benchmark.harness.spans import backward_device_ms_per_step


def read(view):
    return backward_device_ms_per_step(view, "detector/body")

"""Device busy ms per call of the kernels launched inside the program's
span ``roi_align/forward`` (every ROIAlign pooler call: the box head's
7x7 and the mask head's 14x14 pools, their level mapping and gathers)."""

from benchmark.harness.spans import device_ms_per_call


def read(view):
    return device_ms_per_call(view, "roi_align/forward")

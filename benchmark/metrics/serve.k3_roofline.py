"""K3's share of its roofline, %: the least time of every
``paa_tpu_torch::group_norm_relu`` op in the window (its input read once
and its output written once, each of the input's size, and the float32
affine, over HBM bandwidth) over the device time of the kernels launched
inside those ops."""

import math

ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4}


def read(view):
    if view.peaks is None:
        return None
    busy_us, ops = view.device_us_in("paa_tpu_torch::group_norm_relu")
    bound_s = 0.0
    for e in ops:
        dims = e["args"]["Input Dims"][0]
        itemsize = ITEMSIZE[e["args"]["Input type"][0]]
        nbytes = 2 * math.prod(dims) * itemsize + 2 * dims[1] * 4
        bound_s += nbytes / view.peaks["hbm_bytes_per_s"]
    if busy_us <= 0:
        return None
    return 100.0 * bound_s / (busy_us * 1e-6)

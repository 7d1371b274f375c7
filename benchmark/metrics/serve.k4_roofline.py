"""K4's share of its roofline, %: the least time of every
``paa_tpu_torch::deform_im2col`` op in the window (x, the offsets and
the mask read once and the columns written once, over HBM bandwidth;
``tracemath.deform_im2col_bytes``) over the device time of the kernels
launched inside those ops, the channels-last copy of x among them."""

from benchmark.harness.tracemath import deform_im2col_bytes


def read(view):
    if view.peaks is None:
        return None
    busy_us, ops = view.device_us_in("paa_tpu_torch::deform_im2col")
    if busy_us <= 0:
        return None
    nbytes = sum(deform_im2col_bytes(e["args"]) for e in ops)
    return 100.0 * nbytes / view.peaks["hbm_bytes_per_s"] \
        / (busy_us * 1e-6)

"""K1's share of its roofline, %: the least time of the window's
``paa_tpu_torch::nms_batched`` ops (the larger of their bytes over HBM
bandwidth and the IoU tests greedy needs on these inputs over the
float32 rate, from the op's arguments and results captured on one call
of each pool batch outside the window) over the device time of the
kernels launched inside them."""

from benchmark.harness.tracemath import nms_bound_s


def read(view):
    caps = view.captures.get("nms_batched")
    if view.peaks is None or not caps:
        return None
    busy_us, ops = view.device_us_in("paa_tpu_torch::nms_batched")
    if busy_us <= 0:
        return None
    bounds = []
    for args, out in caps:
        boxes, scores, labels, valid, _, max_out, aware = args
        bounds.append(nms_bound_s(boxes, scores, labels, valid, out[0],
                                  out[2], max_out, aware, view.peaks))
    # the window cycles the pool's batches in turn
    bound_s = sum(bounds[i % len(bounds)] for i in range(len(ops)))
    return 100.0 * bound_s / (busy_us * 1e-6)

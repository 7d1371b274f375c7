"""The whole call's share of the card's bf16 peak, %: the convolutions
and matrix products of the plain reference's forward at the cell's
shapes (FlopCounterMode on the meta device), times the calls in the
traced window, over the window's wall time."""

from benchmark.harness.flops import reference_flops


def read(view):
    if view.peaks is None or view.calls == 0:
        return None
    tr = view.cell.traffic
    flops = reference_flops(view.cell.config["reference"], tr["batch"],
                            tuple(tr["hw"]))
    return 100.0 * flops * view.calls / (view.window_us * 1e-6) \
        / view.peaks["bf16_flops"]

"""The whole call's share of the card's bf16 peak, %: the convolutions
and matrix products of the plain reference's forward at the cell's
shapes (its family's ``flops``: FlopCounterMode on the meta device),
times the calls in the traced window, over the window's wall time."""


def read(view):
    if view.peaks is None or view.calls == 0:
        return None
    flops = view.cell.family.flops(view.cell, backward=False)
    return 100.0 * flops * view.calls / (view.window_us * 1e-6) \
        / view.peaks["bf16_flops"]

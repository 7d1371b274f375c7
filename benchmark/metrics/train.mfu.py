"""The whole step's share of the card's bf16 peak, %: the convolutions
and matrix products of the plain reference's forward and backward at
the cell's shapes (its family's ``flops``: FlopCounterMode on the meta
device; the frozen stages' weights get no gradient), times the steps in
the traced window, over the window's wall time."""


def read(view):
    if view.peaks is None or view.calls == 0:
        return None
    flops = view.cell.family.flops(view.cell, backward=True)
    return 100.0 * flops * view.calls / (view.window_us * 1e-6) \
        / view.peaks["bf16_flops"]

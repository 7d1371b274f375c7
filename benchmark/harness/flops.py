"""The work the mfu metrics count: the convolutions and matrix products
of a family's plain reference at a cell's shapes (its ``flops``),
counted by ``torch.utils.flop_counter.FlopCounterMode``, as a rule on
the meta device. It counts the same work whatever implements it in the
program."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def counted_flops(forward, backward=False):
    """FLOPs of ``forward()``, a dict of outputs; with ``backward`` also
    of the backward that a loss over every output needs."""
    with FlopCounterMode(display=False) as counter:
        out = forward()
        if backward:
            sum(v.sum() for v in out.values()).backward()
    return counter.get_total_flops()

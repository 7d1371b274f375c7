"""The work the mfu metrics count: the convolutions and matrix products
of the plain reference at a cell's shapes, counted by
``torch.utils.flop_counter.FlopCounterMode`` on the meta device. It
counts the same work whatever implements it in the program."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model


def reference_flops(ref, batch, hw, backward=False):
    """FLOPs of the reference's forward over a (batch, 3, H, W) input;
    with ``backward`` also of the backward that a loss over every
    output needs (the frozen stages' weights get no gradient)."""
    with torch.device("meta"):
        model = ref_model.build(ref)
        x = torch.empty(batch, 3, *hw)
    with FlopCounterMode(display=False) as counter:
        out = model(x)
        if backward:
            sum(v.sum() for v in out.values()).backward()
    return counter.get_total_flops()

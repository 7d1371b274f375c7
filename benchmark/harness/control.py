"""The correctness control and the planted faults, read at a cell's own
size by its family's ``control`` (``families/<family>.py`` says which
it plants): the numbers the check would compute if they stood in the
program's place. The benchmark's own runs never run them."""

from __future__ import annotations

import time


def readings(cell, seeds, device, log):
    """{seed: {fault: numbers}} over ``seeds``."""
    out = {}
    for seed in seeds:
        t = time.perf_counter()
        out[seed] = cell.family.control(cell, seed, device)
        log(f"seed {seed}: {out[seed]} ({time.perf_counter() - t:.1f} s)")
    return out

"""Device idle ms per step in the gaps that open while the window's
thread is inside one of the program's ``sync/`` spans, where the host
waits for the card (the batch's copy, the GMM's convergence reads)."""

from benchmark.harness.spans import SYNC_PREFIX, idle_ms_per_call


def read(view):
    return idle_ms_per_call(view, lambda name: name.startswith(SYNC_PREFIX))

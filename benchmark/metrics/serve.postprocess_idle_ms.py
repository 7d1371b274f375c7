"""Device idle ms per call in the gaps that open while the window's
thread is inside the program's span ``detector/postprocess`` (its
per-level host reads and the host's launches between small kernels)."""

from benchmark.harness.spans import idle_ms_per_call


def read(view):
    return idle_ms_per_call(view, lambda name: name == "detector/postprocess")

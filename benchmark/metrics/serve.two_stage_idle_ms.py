"""Device idle ms per call in the gaps that open while the window's
thread is inside one of the program's two-stage spans (``two_stage/``)
or ROIAlign's (``roi_align/``): host reads and the host's launches
between small kernels in the proposals, the heads and the
post-processing."""

from benchmark.harness.spans import idle_ms_per_call


def read(view):
    return idle_ms_per_call(view, lambda name: name.startswith(
        ("two_stage/", "roi_align/")))

"""Device idle ms per step in the gaps that open while the autograd
engine's thread is inside a backward op whose forward op ran inside
``detector/body``, ``detector/fpn`` or ``detector/head``: the idle that
the breakdown's ``train_step/backward`` bucket holds, put down to the
model's stages."""

from benchmark.harness.spans import backward_idle_ms_per_step


def read(view):
    return backward_idle_ms_per_step(view)

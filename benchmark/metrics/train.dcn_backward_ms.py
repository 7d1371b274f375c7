"""Device busy ms per step of the kernels launched inside the program's
span ``deform_conv2d/backward`` (the deformable convs' gradient: each
chunk of images recomputed and differentiated)."""

SPAN = "deform_conv2d/backward"


def read(view):
    busy_us, spans = view.device_us_in(SPAN)
    if not spans or busy_us <= 0 or view.calls == 0:
        return None
    return busy_us / 1e3 / view.calls

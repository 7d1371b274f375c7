"""Device busy ms per step of the kernels launched inside the program's
span ``group_norm_relu/backward`` (K3's gradient: the plain version's
VJP, recomputed)."""

SPAN = "group_norm_relu/backward"


def read(view):
    busy_us, spans = view.device_us_in(SPAN)
    if not spans or busy_us <= 0 or view.calls == 0:
        return None
    return busy_us / 1e3 / view.calls

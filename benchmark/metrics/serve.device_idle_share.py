"""The device's idle share of the traced window, %: 1 - the union of
kernel, memcpy and memset intervals over the window's wall time."""


def read(view):
    if not view.device:
        return None
    return 100.0 * (1.0 - view.busy_us() / view.window_us)

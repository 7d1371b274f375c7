"""Device ms per call of host-to-device copies (the profiler's memcpy
events of kind HtoD): the uint8 batch entering ``make_eval_fn``."""


def read(view):
    us = sum(k["dur"] for k in view.device
             if k.get("cat") == "gpu_memcpy" and "HtoD" in k["name"])
    return us / 1e3 / view.calls if us > 0 else None

"""Training metric smoothing (a copy of paa_tpu/utils/metric_logger.py;
reference paa_core/utils/metric_logger.py: SmoothedValue = 20-window
median/avg + global average; MetricLogger aggregates named values and
formats them)."""

from __future__ import annotations

from collections import defaultdict, deque


class SmoothedValue:
    def __init__(self, window_size=20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self):
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter="  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )

"""Wall-clock timer (a copy of paa_tpu/utils/timer.py; reference
paa_core/utils/timer.py): ``tic``/``toc`` pairs, their running average
and its ``H:MM:SS`` string."""

from __future__ import annotations

import datetime
import time


class Timer:
    def __init__(self):
        self.reset()

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls > 0 else 0.0

    def tic(self):
        self.start_time = time.time()

    def toc(self, average=True):
        self.add(time.time() - self.start_time)
        return self.average_time if average else self.diff

    def add(self, time_diff):
        self.diff = time_diff
        self.total_time += time_diff
        self.calls += 1

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0
        self.diff = 0.0

    def avg_time_str(self):
        return str(datetime.timedelta(seconds=self.average_time))


def get_time_str(time_diff):
    return str(datetime.timedelta(seconds=time_diff))

"""Wall-clock timing for the training budget (port of ``utils/timing.py``).

The reference stops training after a wall-clock budget (train_utils.py:
414-425). ``Timer.exclude()`` keeps set-up work out of that budget: the
dataset build, the first segment of each new shape, checkpoint saves and
mid-training evaluations.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class Timer:
    def __init__(self):
        self.start = time.perf_counter()
        self.excluded = 0.0

    def elapsed(self) -> float:
        return time.perf_counter() - self.start - self.excluded

    @contextmanager
    def exclude(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.excluded += time.perf_counter() - t0

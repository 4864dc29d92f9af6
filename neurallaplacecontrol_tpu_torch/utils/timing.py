"""Wall-clock timing for the training budget, and profiler traces (port of
``utils/timing.py``).

The reference stops training after a wall-clock budget (train_utils.py:
414-425). ``Timer.exclude()`` keeps set-up work out of that budget: the
dataset build, the first segment of each new shape, checkpoint saves and
mid-training evaluations. ``profile_trace`` and ``annotate`` are the JAX
module's ``jax.profiler`` switches on ``torch.profiler``.
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


@contextmanager
def profile_trace(trace_dir: str | None):
    """A ``torch.profiler`` trace of the block: the host's operations and, on
    a build of torch that can trace a CUDA device, its kernels, written on
    exit as a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``) into
    ``trace_dir``, which is made if need be. View it in Perfetto or
    chrome://tracing. ``trace_dir=None`` or ``""`` traces nothing, so call
    sites can pass an optional setting as it is."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities, tensorboard_trace_handler

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA) if a in supported_activities()]
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
        yield


@contextmanager
def annotate(name: str):
    """A named range in the profiler's timeline (``record_function``), for
    host-side phases too; costs nothing measurable when no profiler runs."""
    from torch.profiler import record_function

    with record_function(name):
        yield

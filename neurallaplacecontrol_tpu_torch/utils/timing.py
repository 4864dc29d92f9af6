"""Wall-clock timing for the training budget, profiler traces, and the
program's spans (port of ``utils/timing.py``).

The reference stops training after a wall-clock budget (train_utils.py:
414-425). ``Timer.exclude()`` keeps set-up work out of that budget: the
dataset build, the first segment of each new shape, checkpoint saves and
mid-training evaluations. ``profile_trace`` is the JAX module's
``jax.profiler`` switch on ``torch.profiler``.

``span(name)`` marks a stretch of host time at a layer boundary of the
program: the ``tick`` (one lockstep tick of an episode, one
``Controller.step``), the planner's ``plan`` and its phases
``plan.perturb``, ``plan.rollout`` and ``plan.weigh``, and each forward's
launch, ``fwd.resident``, ``fwd.streamed`` or ``fwd.plain``. Spans are off
until ``start()``: then each is one flag check that returns a shared null
context, allocates nothing and reads no clock. Between ``start()`` and
``stop()`` each span records its name, its start and end on
``time.perf_counter_ns()``, the span open around it, and the ``tick`` span
it falls in, into a buffer of ``CAPACITY`` spans allocated by ``start()``;
``dropped()`` counts the spans past it. ``records()`` returns what the last
recorder holds. Spans record nothing while ``torch.export`` or
``torch.compile`` traces. They read no tensor, so every output is the same
with the recorder on or off. One thread records at a time.
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import NamedTuple

import torch


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


TICK = "tick"  # the span whose record index is the tick identifier of the spans inside it
CAPACITY = 1 << 16  # spans a recorder holds: ~1,400 ticks of 45 spans


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns() as the span opened
    end_ns: int  # as it closed; -1 if it was still open when read
    parent: int  # index of the record of the span open around it, -1 at the top
    tick: int  # index of the record of the ``tick`` span it falls in (its own for a tick), -1 outside any


class Recorder:
    """The spans of one ``start()`` .. ``stop()``, in lists of ``CAPACITY``
    slots allocated up front; spans past them are counted in ``dropped``."""

    def __init__(self):
        capacity = self.capacity = CAPACITY
        self.names = [""] * capacity
        self.starts = [0] * capacity
        self.ends = [-1] * capacity
        self.parents = [-1] * capacity
        self.ticks = [-1] * capacity
        self.count = 0  # slots used
        self.dropped = 0
        self.open = -1  # the innermost open span's slot

    def records(self) -> list[SpanRecord]:
        return [SpanRecord(*r) for r in zip(self.names[:self.count], self.starts, self.ends, self.parents,
                                            self.ticks)]


class _Span:
    """One span while the recorder runs; closes into the recorder it opened in."""

    __slots__ = ("rec", "name", "slot")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        i = self.slot = rec.count
        if i == rec.capacity:
            self.slot = -1
            rec.dropped += 1
            return self
        rec.count = i + 1
        parent = rec.parents[i] = rec.open
        rec.names[i] = self.name
        rec.ticks[i] = i if self.name == TICK else (rec.ticks[parent] if parent >= 0 else -1)
        rec.open = i
        rec.starts[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter_ns()
        i = self.slot
        if i >= 0:
            rec = self.rec
            rec.ends[i] = t
            rec.open = rec.parents[i]
        return False


_OFF = nullcontext()
_running: Recorder | None = None  # the recorder spans write to; None while off
_last: Recorder | None = None  # the recorder ``records()`` reads


def span(name: str):
    """A context that records the stretch it encloses as the span ``name``
    while the recorder runs, and does nothing otherwise."""
    rec = _running
    if rec is None or torch.compiler.is_compiling():
        return _OFF
    return _Span(rec, name)


def start() -> None:
    """Start a new recorder; the spans of the one before are dropped."""
    global _running, _last
    _running = _last = Recorder()


def stop() -> None:
    """Stop recording; ``records()`` still reads what was recorded, and
    spans open at this point close into it."""
    global _running
    _running = None


def records() -> list[SpanRecord]:
    """The spans of the last recorder started, in the order they opened."""
    return _last.records() if _last is not None else []


def dropped() -> int:
    """Spans the last recorder started had no room for."""
    return _last.dropped if _last is not None else 0

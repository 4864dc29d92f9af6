"""The traced stretch of a ``--trace 1`` run and what is read from it.

A driver calls ``begin(tick)`` where each tick's host work starts. Over ticks
``start .. start + ticks - 1`` a ``torch.profiler`` trace of the CUDA
activity runs: the kernels, copies and sets on the device and the CUDA
runtime calls on the host. It records no host operator: tracing every
operator stretches a host-paced tick by two thirds (18 to 30 ms at the
serving tick), which would read as device idle time; the runtime calls alone
stretch it by about a quarter. The stretch starts and ends with a device
sync made inside the trace, so that exactly the device work of those ticks
falls between the two, and the window is the time between them on the
trace's clock. The program's counters of forwards and rows
(``nl_forward_fused.launches`` and ``.rows``) are read at both ends.

``Trace`` holds what the readers under ``metrics/`` take. Nothing here runs
unless the run asks for a trace.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch

# the forward's kernels: the resident kernel and the streamed chain's stage kernels
FORWARD_KERNEL = re.compile(r"\bnl_(forward|wide_\w+)_kernel\b")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "cudaDeviceSynchronize"


class Tracer:
    """Traces ticks ``start .. start + ticks - 1``. ``counters()`` returns
    the program's counts of forwards and of their rows."""

    def __init__(self, start: int, ticks: int, counters):
        self.start, self.ticks, self.counters = start, ticks, counters
        self.prof = None
        self.done = False
        self.counted = None

    def begin(self, tick: int):
        """A tick's host work starts: the trace starts at the first traced
        tick and ends at the first tick after them."""
        if self.done or not torch.cuda.is_available():
            return
        if tick == self.start:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
            self.prof.start()
            torch.cuda.synchronize()  # the window's first edge, on the trace's clock
            self.counted = self.counters()
        elif tick == self.start + self.ticks and self.prof is not None:
            self._stop()

    def pending(self) -> bool:
        """The traced ticks have not all run yet: a window must not close."""
        return torch.cuda.is_available() and not self.done

    def _stop(self):
        torch.cuda.synchronize()  # the window's last edge
        self.prof.stop()
        launches, rows = self.counters()
        self.counted = (launches - self.counted[0], rows - self.counted[1])
        self.done = True

    def finish(self):
        """Ends the trace if the driver's last tick was a traced one."""
        if self.prof is not None and not self.done:
            self._stop()

    def events(self) -> list[dict]:
        """The trace's complete events (Chrome trace format)."""
        if self.prof is None:
            return []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def _union_within(intervals, lo, hi):
    """Total length of the union of ``intervals`` (sorted by start) inside [lo, hi]."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


@dataclass
class Trace:
    """What a traced stretch showed. Times are seconds."""

    ticks: int
    window_s: float  # from the first edge's sync to the last's
    busy_s: float  # device time inside it in which an operation ran
    device_ops: int  # device operations (kernels, copies, sets) inside it
    fwd_device_s: float  # the forward kernels' device time inside it
    other_device_s: float  # every other device operation's
    fwd_launches: int  # forwards launched (program counter)
    fwd_rows: int  # rows over those forwards (program counter)
    host_tick_s: list  # the host's seconds a tick before the trace started
    cell: dict = field(default_factory=dict)  # the cell's dims for the yardsticks
    breakdown: dict = field(default_factory=dict)


def read(tracer: Tracer, host_tick_s, cell: dict) -> Trace:
    events = tracer.events()
    syncs = sorted(e["ts"] + e["dur"] for e in events if e.get("cat") == "cuda_runtime" and e.get("name") == SYNC)
    lo, hi = (syncs[0], syncs[-1]) if len(syncs) >= 2 else (0.0, 0.0)
    device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES and lo <= e["ts"] < hi)
    per_name, fwd, other = {}, 0.0, 0.0
    for a, b, name in device:
        dur = min(b, hi) - a
        per_name[name] = per_name.get(name, 0.0) + dur
        if FORWARD_KERNEL.search(name):
            fwd += dur
        else:
            other += dur
    intervals = [(a, b) for a, b, _ in device]
    runtime = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "cuda_runtime" and lo <= e["ts"] < hi)
    breakdown = {
        "device_ops": [[n[:200], s * 1e-6] for n, s in sorted(per_name.items(), key=lambda x: -x[1])[:10]],
        "idle_gaps": _idle_gaps(intervals, runtime, lo, hi),
    }
    launches, rows = tracer.counted or (0, 0)
    return Trace(ticks=tracer.ticks, window_s=(hi - lo) * 1e-6, busy_s=_union_within(intervals, lo, hi) * 1e-6,
                 device_ops=len(device), fwd_device_s=fwd * 1e-6, other_device_s=other * 1e-6,
                 fwd_launches=launches, fwd_rows=rows, host_tick_s=list(host_tick_s), cell=cell,
                 breakdown=breakdown)


def _idle_gaps(intervals, runtime, lo, hi):
    """The device's idle time in the window, summed by what the host was in
    at the middle of each gap: a CUDA runtime call (a launch, a copy, a
    sync), or "host" between calls (Python and the operators' host code).
    The 10 largest, in seconds."""
    starts = [a for a, _, _ in runtime]
    gaps, cur = {}, lo
    for a, b in intervals + [(hi, hi)]:
        if a > cur:
            mid = 0.5 * (cur + a)
            i = bisect.bisect_right(starts, mid) - 1
            label = runtime[i][2] if i >= 0 and runtime[i][1] > mid else "host"
            gaps[label] = gaps.get(label, 0.0) + (a - cur)
        cur = max(cur, b)
    return [[n, s * 1e-6] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:10]]

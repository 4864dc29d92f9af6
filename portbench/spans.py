"""The program's spans in a traced run, put on the device trace's clock.

The port records spans at its layer boundaries (``utils.timing.span``:
``tick``, ``plan`` and its phases ``plan.perturb``, ``plan.rollout`` and
``plan.weigh``, and each forward's ``fwd.resident``, ``fwd.streamed`` or
``fwd.plain``) on ``time.perf_counter_ns()`` while its recorder runs.
``SpanTracer`` is the ``trace.Tracer`` that also runs the recorder: from the
window's first tick to the traced stretch's last edge, so that the ticks
before the profiler starts (the ticks ``host_issue_ms`` reads) carry
untraced host spans and the traced stretch carries spans beside the device's
operations. At each of its two edges it makes the edge's sync and
``CALIBRATION`` more on the idle device, each between two
``perf_counter_ns()`` stamps. The trace holds each as a
``cudaDeviceSynchronize`` event, and a call's event lies inside its stamps:
the one offset between the clocks that puts every event of the edge inside
its pair finds the edge's run of events among the trace's syncs, and the two
edges' instants map the program's clock linearly onto the trace's ``ts``
(``Clock``). Where no run fits, there is no clock. A sync's midpoint would not do: on an H100 the first call after
the profiler starts held the host ~1.8 ms past the end of its event, and a
forward's launch call sits ~10 us inside its span.

``read`` joins each device operation to the span its launch call fell in,
through the ``correlation`` id a kernel shares with its runtime call, and
splits the device's idle time by the innermost span the host was in, with
``trace._idle_gaps``' labels.
The five readers under ``metrics/`` (``tick_host_ms``, ``plan_host_ms``,
``fwd_issue_ms``, ``plan_device_ms``, ``plan_idle_ms``) read ``Spans``
from a ``Trace``'s attribute ``spans``, and read nothing where a trace has
none.

``python3 portbench/span_run.py --workload <cell> --seed <n> --seconds <s>``
runs a cell's window under a ``SpanTracer`` and prints those metrics, the
existing per-layer ones and the two breakdowns as one JSON line.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import trace

TICK, PLAN = "tick", "plan"
FORWARD = "fwd."  # the prefix of the forward's spans
SPAN_METRICS = ("tick_host_ms", "plan_host_ms", "fwd_issue_ms", "plan_device_ms", "plan_idle_ms")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
CALIBRATION = 3  # stamped syncs after each edge's own
SLACK_US = 2.0  # how far outside its stamps, on the matched clock, a sync's event may read
DRIFT_US = 50.0  # how far the two edges' offsets may differ (the H100's drifted under 2 us a traced stretch)


class SpanTracer(trace.Tracer):
    """A ``trace.Tracer`` that also runs the program's span recorder, from the
    first tick it is told of to the traced stretch's last edge, and stamps
    each edge's syncs (``edges_ns``: an edge's list of (before, after) pairs
    of ``perf_counter_ns()``)."""

    def __init__(self, start: int, ticks: int, counters):
        super().__init__(start, ticks, counters)
        self.edges_ns = []
        self.recording = False
        self._events = None

    def begin(self, tick: int):
        from neurallaplacecontrol_tpu_torch.utils import timing

        if self.done or not torch.cuda.is_available():
            return
        if not self.recording:
            timing.start()
            self.recording = True
        if tick == self.start:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA], acc_events=True)
            self.prof.start()
            self.counted = self._edge()
        elif tick == self.start + self.ticks and self.prof is not None:
            self._stop()

    def _edge(self):
        """The sync that makes an edge of the window and the calibration
        syncs, each stamped; the program's counters after them."""
        pairs = []
        for _ in range(1 + CALIBRATION):
            t0 = time.perf_counter_ns()
            torch.cuda.synchronize()
            pairs.append((t0, time.perf_counter_ns()))
        self.edges_ns.append(pairs)
        return self.counters()

    def _stop(self):
        from neurallaplacecontrol_tpu_torch.utils import timing

        launches, rows = self._edge()
        timing.stop()
        self.prof.stop()
        self.counted = (launches - self.counted[0], rows - self.counted[1])
        self.done = True

    def events(self) -> list[dict]:
        if self._events is None:
            self._events = super().events()
        return self._events


@dataclass
class Clock:
    """``perf_counter_ns`` -> trace ``ts`` (us), through two matched instants."""

    host_ns: tuple  # two host instants, ns
    trace_us: tuple  # the same instants on the trace's clock, us

    @property
    def rate(self) -> float:  # trace us per host ns
        dh = self.host_ns[1] - self.host_ns[0]
        return (self.trace_us[1] - self.trace_us[0]) / dh if dh else 1e-3

    @property
    def drift_us(self) -> float:
        """How much longer the stretch reads on the trace's clock than on the host's."""
        return (self.trace_us[1] - self.trace_us[0]) - (self.host_ns[1] - self.host_ns[0]) * 1e-3

    def __call__(self, ns: float) -> float:
        return self.trace_us[0] + (ns - self.host_ns[0]) * self.rate


@dataclass
class Spans:
    """What the spans showed. ``*_host_ms``: medians over the untraced ticks;
    ``plan_*_ms``: over the traced stretch, a tick."""

    untraced_ticks: int
    traced_ticks: int
    tick_host_ms: float | None
    plan_host_ms: float | None
    fwd_issue_ms: float | None
    plan_device_ms: float | None
    plan_idle_ms: float | None
    host_by_span: dict  # span name -> mean self ms a tick over the untraced ticks
    idle_by_span: list  # [label, idle s] over the traced stretch, the largest first
    counts: dict  # spans by name opened inside the traced stretch
    dropped: int  # spans the recorder had no room for
    joined_ops: int  # device operations inside the stretch whose launch call the trace holds
    device_ops: int  # device operations inside the stretch
    clock: Clock | None  # the program's clock onto the trace's
    # each forward kernel in the stretch: (its launch call's middle, us, or None where the trace
    # holds no launch call for it; its start, us; the innermost span at the launch, or None)
    forward_launches: list = field(default_factory=list)


def _self_ns(recs) -> list[int]:
    """Each span's duration less the part its children cover (children nest)."""
    own = [r.end_ns - r.start_ns if r.end_ns >= 0 else 0 for r in recs]
    for r, d in zip(recs, list(own)):
        if r.parent >= 0:
            own[r.parent] -= d
    return own


def _median_ms(values):
    return float(np.median(values)) * 1e-6 if values else None


def _host(recs, first_edge_ns) -> dict:
    """The host's numbers over the ticks that ended before the first edge."""
    ticks = [i for i, r in enumerate(recs) if r.name == TICK and 0 <= r.end_ns <= first_edge_ns]
    index = {t: k for k, t in enumerate(ticks)}
    plan, fwd = [0] * len(ticks), [0] * len(ticks)
    by_name = {}
    for r, own in zip(recs, _self_ns(recs)):
        k = index.get(r.tick)
        if k is None:
            continue
        by_name[r.name] = by_name.get(r.name, 0) + own
        if r.name == PLAN:
            plan[k] += r.end_ns - r.start_ns
        elif r.name.startswith(FORWARD):
            fwd[k] += r.end_ns - r.start_ns
    n = len(ticks)
    return {"untraced_ticks": n,
            "tick_host_ms": _median_ms([recs[t].end_ns - recs[t].start_ns for t in ticks]),
            "plan_host_ms": _median_ms(plan),
            "fwd_issue_ms": _median_ms(fwd),
            "host_by_span": {k: v * 1e-6 / n for k, v in sorted(by_name.items(), key=lambda x: -x[1])} if n else {}}


class _Innermost:
    """The innermost span open at a time on the trace's clock."""

    def __init__(self, recs, clock: Clock, lo: float, hi: float):
        self.recs = recs
        bounds = []
        for i, r in enumerate(recs):
            a, b = clock(r.start_ns), clock(r.end_ns) if r.end_ns >= 0 else float("inf")
            if b >= lo and a <= hi:
                bounds += [(a, 1, i), (b, 0, i)]
        bounds.sort()
        self.times, self.spans, stack = [], [], []
        for t, opens, i in bounds:
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            self.times.append(t)
            self.spans.append(stack[-1] if stack else -1)
        # each span's flags: inside a plan, inside a forward (parents open before their children)
        self.in_plan, self.in_fwd = [False] * len(recs), [False] * len(recs)
        for i, r in enumerate(recs):
            up = r.parent if r.parent >= 0 else None
            self.in_plan[i] = r.name == PLAN or (up is not None and self.in_plan[up])
            self.in_fwd[i] = r.name.startswith(FORWARD) or (up is not None and self.in_fwd[up])

    def at(self, t: float) -> int:
        k = bisect.bisect_right(self.times, t) - 1
        return self.spans[k] if k >= 0 else -1

    def name(self, span: int) -> str:
        return self.recs[span].name if span >= 0 else "outside"

    def pieces(self, lo: float, hi: float) -> list:
        """[lo, hi] cut where a span opens or closes: (start, end, the innermost span or -1)."""
        cuts = [lo, *(t for t in self.times if lo < t < hi), hi]
        return [(a, b, self.at(0.5 * (a + b))) for a, b in zip(cuts, cuts[1:]) if b > a]


def read(records, dropped: int, edges_ns, events, ticks: int) -> Spans:
    """The spans ``records`` (``timing.records()``) of a run whose traced
    stretch of ``ticks`` ticks lies between the two edge syncs around which
    the host noted ``edges_ns``, joined to the trace's complete ``events``."""
    recs = list(records)
    first_edge = edges_ns[0][0][0] if edges_ns else float("inf")
    host = _host(recs, first_edge)
    syncs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "cuda_runtime" and e.get("name") == trace.SYNC)
    traced = dict(plan_device_ms=None, plan_idle_ms=None, idle_by_span=[], counts={}, joined_ops=0,
                  device_ops=0, clock=None, forward_launches=[])
    first = _instant(edges_ns[0], syncs) if len(edges_ns) == 2 and ticks else None
    last = _instant(edges_ns[1], syncs, near=first[1] - first[0] * 1e-3) if first else None
    if last:
        clock = Clock(host_ns=(first[0], last[0]), trace_us=(first[1], last[1]))
        traced.update(_device(recs, clock, events, syncs[0][1], syncs[-1][1], ticks))
        traced["clock"] = clock
        traced["counts"] = _counts(recs, edges_ns[0][-1][1], edges_ns[1][0][0])
    return Spans(traced_ticks=ticks if len(edges_ns) == 2 else 0, dropped=dropped, **host, **traced)


def _instant(pairs, syncs, near=None):
    """(host ns, trace us) of one instant at an edge, or None. The stamped
    ``pairs`` fit a run of as many consecutive sync events (start, end) where
    one offset (trace us less host us) puts each event inside its pair, to
    ``SLACK_US``; the offset is the middle of those that do. At the first edge
    (``near`` None) the earliest run that fits, since the trace holds no sync
    before the edge's own; at the last, the fitting run whose offset lies
    nearest ``near``, if within ``DRIFT_US`` of it."""
    k, fits = len(pairs), []
    for j in range(len(syncs) - k + 1):
        run = syncs[j:j + k]
        lo = max(b - t1 * 1e-3 for (_, t1), (_, b) in zip(pairs, run))
        hi = min(a - t0 * 1e-3 for (t0, _), (a, _) in zip(pairs, run))
        if lo <= hi + SLACK_US:
            fits.append(0.5 * (lo + hi))
    if not fits:
        return None
    offset = fits[0] if near is None else min(fits, key=lambda o: abs(o - near))
    if near is not None and abs(offset - near) > DRIFT_US:
        return None
    host = 0.5 * (pairs[0][0] + pairs[-1][1])
    return host, host * 1e-3 + offset


def _counts(recs, lo_ns, hi_ns) -> dict:
    counts = {}
    for r in recs:
        if lo_ns <= r.start_ns <= hi_ns:
            counts[r.name] = counts.get(r.name, 0) + 1
    return dict(sorted(counts.items()))


def _device(recs, clock: Clock, events, lo: float, hi: float, ticks: int) -> dict:
    """The device's side over the stretch [lo, hi] (trace us)."""
    inner = _Innermost(recs, clock, lo, hi)
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = e
    device = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], (e.get("args") or {}).get("correlation"))
                     for e in events if e.get("cat") in trace.DEVICE_CATEGORIES and lo <= e["ts"] < hi),
                    key=lambda d: d[:2])
    plan_us, joined, forward = 0.0, 0, []
    for a, b, name, corr in device:
        call = launches.get(corr)
        span = -1
        if call is not None:
            joined += 1
            span = inner.at(call["ts"] + 0.5 * call["dur"])
            if span >= 0 and inner.in_plan[span] and not inner.in_fwd[span]:
                plan_us += min(b, hi) - a
        if trace.FORWARD_KERNEL.search(name):
            at = call["ts"] + 0.5 * call["dur"] if call is not None else None
            forward.append((at, a, recs[span].name if span >= 0 else None))
    runtime = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "cuda_runtime" and lo <= e["ts"] < hi)
    busy, pieces = [(a, b) for a, b, _, _ in device], inner.pieces(lo, hi)

    def idle(inside, runtime):
        """``trace._idle_gaps`` over the pieces in which ``inside(span)`` holds, the rest counted busy."""
        return trace._idle_gaps(sorted(busy + [(a, b) for a, b, i in pieces if not inside(i)]), runtime, lo, hi)

    by_span = [[f"{n}/{call}", s] for n in sorted({inner.name(i) for _, _, i in pieces})
               for call, s in idle(lambda i, n=n: inner.name(i) == n, runtime)]
    plan_idle_s = sum(s for _, s in idle(lambda i: i >= 0 and inner.in_plan[i], []))
    return {"plan_device_ms": plan_us * 1e-3 / ticks, "plan_idle_ms": plan_idle_s * 1e3 / ticks,
            "idle_by_span": sorted(by_span, key=lambda x: -x[1])[:10],
            "joined_ops": joined, "device_ops": len(device), "forward_launches": forward}


def main(argv=None, *, t_start: float | None = None) -> int:
    """One cell's window under a ``SpanTracer``: the per-layer metrics the
    cell has, the span metrics, and the breakdowns, as one JSON line. No judge runs."""
    import importlib

    from . import cell as cells
    from . import harness

    t_start = time.perf_counter() if t_start is None else t_start
    args = harness.parse(argv)
    cell = cells.load(args.workload)
    if not (torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    from neurallaplacecontrol_tpu_torch.ops.pallas_nl import nl_forward_fused
    from neurallaplacecontrol_tpu_torch.utils import timing

    torch.set_num_threads(1)
    driver = importlib.import_module(f"{__package__}.drivers.{cell.traffic['kind']}").Driver(cell, args.seed, "cuda")
    driver.setup()
    setup_s = time.perf_counter() - t_start
    spec = cell.traffic["trace"]
    tracer = SpanTracer(int(spec["start_tick"]), int(spec["ticks"]),
                        lambda: (nl_forward_fused.launches, nl_forward_fused.rows))
    window = driver.window(args.seconds, tracer)
    traced = trace.read(tracer, window.host_tick_s, cell.dims)
    traced.spans = read(timing.records(), timing.dropped(), tracer.edges_ns, tracer.events(), traced.ticks)
    run = harness.Run(cell, setup_s, window, traced)
    names = [m["name"] for m in harness.metrics_for(cells.benchmark(), "per_layer", cell.name)]
    suffix = names[0].rpartition(".")[2] if names else ""
    names += [f"{n}.{suffix}" if suffix else n for n in SPAN_METRICS]
    metrics = {n: harness.reader("metrics", n)(run) for n in names}
    s = traced.spans
    out = {"cell": cell.name, "seed": args.seed, "metrics": metrics, "fwd_launches": traced.fwd_launches,
           "host_by_span": s.host_by_span, "idle_by_span": s.idle_by_span, "idle_gaps": traced.breakdown["idle_gaps"],
           "counts": s.counts, "dropped": s.dropped, "untraced_ticks": s.untraced_ticks,
           "joined_ops": s.joined_ops, "device_ops": s.device_ops,
           "drift_us": s.clock.drift_us if s.clock else None,
           "forward_kernels": len(s.forward_launches),
           "forwards_launched_in_fwd_spans": sum(1 for at, _, name in s.forward_launches
                                                 if at is not None and (name or "").startswith(FORWARD)),
           "device": torch.cuda.get_device_name(0), "power_limit": harness.power_limit()}
    print(json.dumps(out), flush=True)
    return 0

"""The program's spans on the device trace's clock (``portbench/spans.py``): on a
synthetic span list and Chrome trace, the clock through the two edge syncs,
the join of device operations to spans by correlation id, the host's numbers
over the untraced ticks, ``plan_device_ms``, ``plan_idle_ms``,
``idle_by_span`` and the five readers. On the card (``-m cuda``): every
forward kernel's launch lies inside a ``fwd.*`` span, and the stretch's
``fwd.*`` spans number the program's forward counter.

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/tests/test_portbench_spans.py
"""

import pytest
import torch

from neurallaplacecontrol_tpu_torch.utils.timing import SpanRecord
from portbench import harness, spans, trace

MS = 1_000_000  # ns
OFFSET_US = 1000.0  # the trace's clock: host ns / 1000 + OFFSET_US


class SpanList:
    """Builds ``SpanRecord``s with parents and tick identifiers as the recorder sets them."""

    def __init__(self):
        self.recs = []

    def add(self, name, a, b, parent=-1):
        i = len(self.recs)
        tick = i if name == "tick" else (self.recs[parent].tick if parent >= 0 else -1)
        self.recs.append(SpanRecord(name, int(a), int(b), parent, tick))
        return i

    def tick(self, t0, length, forwards):
        """One tick of ``length`` ns from ``t0``: the plan 1 ms in from each end,
        perturb 1 ms, rollout to 2 ms before the end holding ``forwards``
        (start, end) pairs, weigh 1 ms."""
        t = self.add("tick", t0, t0 + length)
        p = self.add("plan", t0 + 1 * MS, t0 + length - 1 * MS, t)
        self.add("plan.perturb", t0 + 1 * MS, t0 + 2 * MS, p)
        r = self.add("plan.rollout", t0 + 2 * MS, t0 + length - 2 * MS, p)
        for a, b in forwards:
            self.add("fwd.resident", t0 + a, t0 + b, r)
        self.add("plan.weigh", t0 + length - 2 * MS, t0 + length - 1 * MS, p)


def X(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def scenario():
    """Three untraced ticks of 10, 11 and 14 ms (two 0.5-ms forwards each), an
    orphan plan, then one traced tick from 41 to 58 ms between edge syncs at
    40 and 60 ms, each stamped and followed by three stamped calibration
    syncs; the device's operations on the trace's clock."""
    s = SpanList()
    s.add("plan", 0.2 * MS, 0.8 * MS)  # opened before its tick's span: in no tick
    t0 = 1 * MS
    for length in (10 * MS, 11 * MS, 14 * MS):
        s.tick(t0, length, [(3 * MS, 3.5 * MS), (4 * MS, 4.5 * MS)])
        t0 += length
    s.tick(41 * MS, 17 * MS, [(3 * MS, 4 * MS)])  # trace us: tick 42000..59000, plan 43000..58000,
    # perturb 43000..44000, rollout 44000..57000, forward 45000..46000, weigh 57000..58000
    # stamps around each edge's sync (10 us) and the calibration syncs at +20, +30 and +40 us, 2 us each
    brackets = [(-2_000, 12_000), (18_000, 24_000), (29_000, 33_000), (37_000, 45_000)]
    edges_ns = [[(40 * MS + a, 40 * MS + b) for a, b in brackets], [(60 * MS + a, 60 * MS + b) for a, b in brackets]]
    events = [
        X("cuda_runtime", trace.SYNC, 41000, 10),  # the first edge: lo = 41010
        *[X("cuda_runtime", trace.SYNC, 41020 + 10 * i, 2) for i in range(3)],
        X("cuda_runtime", "cudaLaunchKernel", 42500, 4, 1),  # the tick's noise draw
        X("kernel", "normal_kernel", 42510, 100, 1),
        X("cuda_runtime", "cudaLaunchKernel", 43500, 4, 2),  # in plan.perturb
        X("kernel", "clamp_kernel", 43600, 200, 2),
        X("cuda_driver", "cuLaunchKernel", 45500, 5, 3),  # the forward, in fwd.resident
        X("kernel", "(anonymous namespace)::nl_forward_kernel(float const*)", 45600, 5000, 3),
        X("cuda_runtime", "cudaLaunchKernel", 52000, 4, 4),  # in plan.rollout
        X("kernel", "cost_kernel", 52100, 300, 4),
        X("cuda_runtime", "cudaStreamSynchronize", 52300, 3750),  # over the gap 52400..57600's middle
        X("cuda_runtime", "cudaLaunchKernel", 57500, 4, 5),  # in plan.weigh
        X("kernel", "softmax_kernel", 57600, 100, 5),
        X("cuda_runtime", "cudaLaunchKernel", 58500, 4, 6),  # the plant's step, after the plan
        X("kernel", "step_kernel", 58600, 50, 6),
        X("kernel", "unlaunched_kernel", 59000, 10, 7),  # no launch call in the trace
        X("cuda_runtime", trace.SYNC, 60900, 5),  # a sync of the driver's
        X("cuda_runtime", trace.SYNC, 61000, 10),  # the last edge
        *[X("cuda_runtime", trace.SYNC, 61020 + 10 * i, 2) for i in range(3)],
        X("cuda_runtime", trace.SYNC, 61100, 3),  # the profiler's own, as it stops: hi = 61103
    ]
    return s.recs, edges_ns, events


def reading():
    recs, edges_ns, events = scenario()
    return spans.read(recs, 0, edges_ns, events, ticks=1)


def test_clock_through_the_edge_syncs():
    clock = spans.Clock(host_ns=(40 * MS, 60 * MS), trace_us=(41005.0, 61007.0))
    assert clock(40 * MS) == pytest.approx(41005.0)
    assert clock(60 * MS) == pytest.approx(61007.0)
    assert clock(50 * MS) == pytest.approx(51006.0)
    assert clock.drift_us == pytest.approx(2.0)
    s = reading()
    assert s.clock.drift_us == pytest.approx(0.0)
    assert s.clock(45 * MS) == pytest.approx(45 * 1000 + OFFSET_US)  # the midpoints of host pairs and syncs


def test_a_driver_sync_at_a_tick_start_leaves_the_clock():
    """A sync of the driver's as the traced tick starts, after the first edge's
    stamped syncs, fits none of the edges' stamps."""
    recs, edges_ns, events = scenario()
    events.append(X("cuda_runtime", trace.SYNC, 41060, 2))
    s = spans.read(recs, 0, edges_ns, events, ticks=1)
    assert s.clock(45 * MS) == pytest.approx(45 * 1000 + OFFSET_US) and s.clock.drift_us == pytest.approx(0.0)


@pytest.mark.parametrize("lost", ["first", "last"])
def test_no_clock_where_an_edge_fits_no_syncs(lost):
    """Where the trace lost an edge's calibration syncs, no run of its syncs
    fits that edge's stamps: no clock, and no device-side reading."""
    recs, edges_ns, events = scenario()
    edge = 41000 if lost == "first" else 61000
    events = [e for e in events if not (e["name"] == trace.SYNC and edge + 20 <= e["ts"] <= edge + 40)]
    s = spans.read(recs, 0, edges_ns, events, ticks=1)
    assert s.clock is None and s.plan_device_ms is None and s.plan_idle_ms is None
    assert s.tick_host_ms == pytest.approx(11.0)


def test_host_numbers_over_the_untraced_ticks():
    s = reading()
    assert s.untraced_ticks == 3 and s.traced_ticks == 1 and s.dropped == 0
    assert s.tick_host_ms == pytest.approx(11.0)
    assert s.plan_host_ms == pytest.approx(9.0)  # 8, 9, 12
    assert s.fwd_issue_ms == pytest.approx(1.0)
    want = {"tick": 2.0, "plan": 0.0, "plan.perturb": 1.0, "plan.rollout": (5 + 6 + 9) / 3,
            "fwd.resident": 1.0, "plan.weigh": 1.0}
    assert s.host_by_span == pytest.approx(want)


def test_device_joined_to_spans():
    s = reading()
    assert s.device_ops == 7 and s.joined_ops == 6
    assert s.plan_device_ms == pytest.approx((200 + 300 + 100) * 1e-3)  # not the draw, forward or plant
    # the idle gaps inside the plan (43000..58000): 43000..43600, 43800..45600, 50600..52100,
    # 52400..57600, 57700..58000
    assert s.plan_idle_ms == pytest.approx((600 + 1800 + 1500 + 5200 + 300) * 1e-3)
    # each idle gap cut where a span opens or closes, each piece labelled at its middle; together the
    # stretch's idle, 41010..61103 less 5,760 us busy
    assert dict(s.idle_by_span) == pytest.approx({
        "plan.rollout/cudaStreamSynchronize": 4600e-6, "outside/host": 3083e-6, "plan.rollout/host": 2500e-6,
        "tick/host": 1850e-6, "plan.weigh/host": 900e-6, "plan.perturb/host": 800e-6, "fwd.resident/host": 600e-6})
    assert sum(v for _, v in s.idle_by_span) == pytest.approx((61103 - 41010 - 5760) * 1e-6)
    assert [n for n, _ in s.idle_by_span][0] == "plan.rollout/cudaStreamSynchronize"
    assert s.forward_launches == [(45502.5, 45600, "fwd.resident")]
    assert s.counts == {"fwd.resident": 1, "plan": 1, "plan.perturb": 1, "plan.rollout": 1, "plan.weigh": 1,
                        "tick": 1}


def test_no_trace_reads_the_host_alone():
    recs, edges_ns, _ = scenario()
    s = spans.read(recs, 2, edges_ns[:1], [], ticks=0)
    assert s.tick_host_ms == pytest.approx(11.0) and s.dropped == 2
    assert s.plan_device_ms is None and s.plan_idle_ms is None and s.idle_by_span == [] and s.clock is None


@pytest.mark.parametrize("name, want", [("tick_host_ms", 11.0), ("plan_host_ms.eval", 9.0),
                                        ("fwd_issue_ms.wide", 1.0), ("plan_device_ms.serve", 0.6),
                                        ("plan_idle_ms.eval", 9.4)])
def test_readers(name, want):
    traced = trace.read(type("T", (), {"events": lambda self: [], "ticks": 1, "counted": None})(), [], {})
    run = harness.Run(None, 0.0, None, traced)
    read = harness.reader("metrics", name)
    assert read(run) is None  # a trace without spans, as a run of the benchmark has it
    traced.spans = reading()
    assert read(run) == pytest.approx(want)


def test_span_run_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert spans.main(["--workload", "nl128-eval-s20", "--seed", "1", "--seconds", "1"]) != 0


SMALL = {
    "nl128-eval-s20": {"seeds": 2, "episode_ticks": 16, "warmup_ticks": 1, "trace": {"start_tick": 5, "ticks": 5}},
    "nl512-eval-s10": {"seeds": 1, "episode_ticks": 16, "warmup_ticks": 1, "trace": {"start_tick": 5, "ticks": 5}},
    "nl128-serve-k32768": {"rollouts": 1000, "episode_ticks": 16, "warmup_ticks": 1,
                           "trace": {"start_tick": 5, "ticks": 5}},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_forward_launches_inside_their_spans(card, name):
    """A small window of the cell under a ``SpanTracer``: each forward kernel's
    launch call lies inside a ``fwd.*`` span (where the trace holds no launch
    call for it, the kernel starts after a ``fwd.*`` span has started), and the
    stretch's ``fwd.*`` spans, ticks and plans number the forward counter and
    the traced ticks."""
    import importlib

    from neurallaplacecontrol_tpu_torch.ops.pallas_nl import nl_forward_fused
    from neurallaplacecontrol_tpu_torch.utils import timing
    from portbench import cell as cells

    cell = cells.load(name, traffic_overrides=SMALL[name])
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}").Driver(cell, 4_100_000_017, "cuda")
    driver.setup()
    tracer = spans.SpanTracer(5, 5, lambda: (nl_forward_fused.launches, nl_forward_fused.rows))
    window = driver.window(0.1, tracer)
    traced = trace.read(tracer, window.host_tick_s, cell.dims)
    records = timing.records()
    s = spans.read(records, timing.dropped(), tracer.edges_ns, tracer.events(), traced.ticks)
    assert s.dropped == 0 and s.untraced_ticks >= 3 and s.tick_host_ms > 0
    forwards = sum(v for k, v in s.counts.items() if k.startswith(spans.FORWARD))
    assert forwards == traced.fwd_launches > 0
    assert s.counts["tick"] == s.counts["plan"] == 5 and forwards == 5 * cell.horizon
    assert s.forward_launches
    if all(at is not None for at, _, _ in s.forward_launches):
        assert all((span or "").startswith(spans.FORWARD) for _, _, span in s.forward_launches)
    else:
        starts = sorted(s.clock(r.start_ns) for r in records if r.name.startswith(spans.FORWARD))
        assert all(any(a <= k for a in starts) for _, k, _ in s.forward_launches)
    assert s.plan_device_ms > 0 and s.plan_idle_ms is not None

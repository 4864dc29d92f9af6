"""The reading of a trace, on a synthetic Chrome trace."""

import pytest

from portbench import trace


class FakeTracer:
    ticks, counted = 2, (4, 80_000)

    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_window_busy_and_split():
    events = [
        X("kernel", "early_kernel", 0, 5),  # before the first edge: left out
        X("cuda_runtime", "cudaDeviceSynchronize", 5, 5),  # first edge at 10
        X("cuda_runtime", "cudaLaunchKernel", 13, 4),
        X("kernel", "(anonymous namespace)::nl_forward_kernel(float const*)", 20, 30),
        X("kernel", "void at::native::add_kernel", 40, 20),  # overlaps the forward: busy counts once
        X("gpu_memcpy", "Memcpy DtoH", 70, 5),
        X("kernel", "void (anonymous namespace)::nl_wide_gemm_kernel<3, 4>(GemmArgs)", 80, 10),
        X("cuda_runtime", "cudaDeviceSynchronize", 90, 20),  # last edge at 110
        X("kernel", "late_kernel", 115, 5),
    ]
    t = trace.read(FakeTracer(events), [0.02, 0.021], {"n_obs": 5})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((40 + 5 + 10) * 1e-6)
    assert t.device_ops == 4 and t.ticks == 2
    assert t.fwd_device_s == pytest.approx(40e-6) and t.other_device_s == pytest.approx(25e-6)
    assert (t.fwd_launches, t.fwd_rows) == (4, 80_000)
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)  # 10..20, the launch call at 13..17 over its middle
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(20e-6)  # 90..110
    assert gaps["host"] == pytest.approx(15e-6)  # 60..70 and 75..80
    names = [n for n, _ in t.breakdown["device_ops"]]
    assert names[0].startswith("(anonymous namespace)::nl_forward_kernel") and "early_kernel" not in names


def test_nothing_traced_reads_nothing():
    t = trace.read(FakeTracer([]), [], {})
    assert t.window_s == t.busy_s == 0 and t.device_ops == 0

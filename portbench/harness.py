"""One run of one cell: set-up, the measured window, the judge, the result line.

``main`` reads the cell's files (``cell.load``), refuses to run without the
CUDA devices the cell asks for, runs the driver of the traffic's kind,
reads the metrics that ``BENCHMARK.json`` lists for the cell (the end-to-end
ones in an untraced run, the per-layer ones in a traced run) with the reader
file of each, judges the outputs, and prints the checks on standard error and
one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

from . import cell as cells
from . import check, trace
from .cell import BENCH_DIR
from .seeds import stream_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "neurallaplacecontrol_tpu")


class Run:
    """What a metric's reader reads: the cell, the set-up seconds, the
    window and, in a traced run, the trace."""

    def __init__(self, cell, setup_s, window, traced):
        self.cell, self.setup_s, self.window, self.trace = cell, setup_s, window, traced


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared as whole names."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def reader(kind: str, name: str):
    """The ``read`` function of ``<kind>/<name>.py``, or of the file named
    without the last dotted part (``mfu.eval`` reads with ``mfu.py``)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / kind / f"{name.rpartition('.')[0] or name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, section: str, cell_name: str) -> list[dict]:
    return [m for m in bench[section] if cell_name in m.get("workloads", [cell_name])]


def power_limit() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def summary(window, setup_s, judge_s) -> dict:
    """A line on the window for the run's log: its seconds and answers, the
    judge's seconds, the tick times' quantiles in ms."""
    out = {"setup_s": setup_s, "seconds": window.seconds, "attempted": window.attempted, "work": window.work,
           "judge_s": judge_s}
    for name, values in (("tick_ms", window.tick_s), ("host_tick_ms", window.host_tick_s)):
        if values:
            q = np.percentile(np.asarray(values) * 1e3, [50, 90, 95, 99, 100])
            out[name] = dict(zip(("p50", "p90", "p95", "p99", "max"), q.tolist()), n=len(values))
    return out


def main(argv=None, *, t_start: float | None = None, device: str = "cuda", require_cuda: bool = True,
         traffic_overrides: dict | None = None, out=None) -> int:
    """One run; returns the exit code. ``require_cuda=False`` (tests only)
    skips the look for a card and runs on ``device``."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    args = parse(argv)
    cell = cells.load(args.workload, traffic_overrides=traffic_overrides)
    if require_cuda and not (torch.cuda.is_available() and torch.cuda.device_count() >= cell.chips):
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    dev = torch.device(device)
    torch.set_num_threads(1)
    driver = importlib.import_module(f"{__package__}.drivers.{cell.traffic['kind']}").Driver(cell, args.seed, dev)
    driver.setup()
    setup_s = time.perf_counter() - t_start

    tracer = None
    if args.trace:
        from neurallaplacecontrol_tpu_torch.ops.pallas_nl import nl_forward_fused

        spec = cell.traffic["trace"]
        tracer = trace.Tracer(int(spec["start_tick"]), int(spec["ticks"]),
                              lambda: (nl_forward_fused.launches, nl_forward_fused.rows))
    window = driver.window(args.seconds, tracer)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traced = trace.read(tracer, window.host_tick_s, cell.dims) if tracer is not None else None

    t_judge = time.perf_counter()
    numbers = driver.judge(np.random.default_rng(stream_seed(args.seed, "judge")))
    judge_s = time.perf_counter() - t_judge

    bench = cells.benchmark()
    run = Run(cell, setup_s, window, traced)
    section, kind = ("per_layer", "metrics") if args.trace else ("end_to_end", "e2e")
    metrics = {}
    for m in metrics_for(bench, section, cell.name):
        value = reader(kind, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = check.verdict(numbers, cell.limits) and window.failed == 0
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if traced is not None:
        device_info.update(busy_s=traced.busy_s, window_s=traced.window_s)
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed, "metrics": metrics,
              "device": device_info}
    if traced is not None:
        result["breakdown"] = traced.breakdown
    if dev.type == "cuda":
        result["power_limit"] = power_limit()
    result["checks"] = {k: {"value": numbers.get(k), "limit": cell.limits.get(k)}
                        for k in sorted(set(numbers) | set(cell.limits))}
    found = forbidden_modules()  # after every reader has run, as the line is printed
    if found:
        print(f"portbench: the run loaded {', '.join(found)}, which the port must not import", file=sys.stderr)
        return 3
    print("window " + json.dumps(summary(window, setup_s, judge_s)), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0

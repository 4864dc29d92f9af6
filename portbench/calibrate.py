"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9 [--out FILE]

In one process, on the cell's own sizes: for each ``--seeds`` seed, the
port's run of one episode batch (or one plant episode) from that seed's
inputs, judged as a benchmark run judges it; for each ``--control-seeds``
seed, the control (the reference in TF32 and bfloat16, ``check``) in the
port's place on that seed's inputs, judged the same way. Prints one JSON
object: every reading, the largest of the port's and the smallest of the
control's per number. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np
import torch

from portbench import cell as cells
from portbench import inputs
from portbench.seeds import stream_seed


def readings(name: str, seeds, control_seeds, device="cuda", traffic_overrides=None) -> dict:
    cell = cells.load(name, traffic_overrides=traffic_overrides)
    kind = importlib.import_module(f"portbench.drivers.{cell.traffic['kind']}")
    port, control = {}, {}
    for seed in seeds:
        t0 = time.perf_counter()
        driver = kind.Driver(cell, seed, device)
        driver.setup()
        if cell.traffic["kind"] == "plant":  # one whole plant episode
            draws = inputs.PlantDraws(cell, seed, 0, driver.device)
            driver.episodes = [(0, *driver._episode(draws, driver.ticks, None, None, 0)[:3])]
        else:  # one episode batch
            driver.window(0.0, None)
        port[seed] = driver.judge(np.random.default_rng(stream_seed(seed, "judge")))
        port[seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"port": seed, **port[seed]}), file=sys.stderr, flush=True)
    for seed in control_seeds:
        t0 = time.perf_counter()
        driver = kind.Driver(cell, seed, device)
        driver.params = inputs.params(cell, seed, driver.device)
        control[seed] = driver.control(np.random.default_rng(stream_seed(seed, "judge")))
        control[seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({"control": seed, **control[seed]}), file=sys.stderr, flush=True)
    numbers = sorted({k for r in list(port.values()) + list(control.values()) for k in r if k != "seconds"})
    summary = {k: {"port_max": max((r[k] for r in port.values()), default=None),
                   "control_min": min((r[k] for r in control.values()), default=None)} for k in numbers}
    device_name = torch.cuda.get_device_name() if torch.device(device).type == "cuda" else "cpu"
    return {"workload": name, "device": device_name, "port": port, "control": control, "summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    result = readings(args.workload, seeds, control_seeds)
    text = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

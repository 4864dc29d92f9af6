#!/usr/bin/env python3
"""The forward kernel's checks and times of phase ``widths`` of
``chip_smoke.py`` (``width_forward_checks``, held to their limits by
``width_failures``) at chosen widths, with each stage kernel's device time.

    python3 scripts/port_wide_check.py [--widths 256,512,1024,2048,4096] [--profile]

Builds the kernel library and prints ptxas's report of the wide kernels
(registers, spills), then one line per record as phase ``widths`` prints
them, and last the failures with the card's name and power limit.
``--profile`` adds, at the
timed row counts, the device ms per forward of each stage kernel
(torch.profiler over 10 forwards). Exits 1 if a check fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def stage_times(fn, calls: int = 10) -> dict:
    """Device ms per call of ``fn`` by kernel name (torch.profiler, CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if ev.device_type.name == "CUDA" and t:
            key = ev.key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
            out[key] = out.get(key, 0.0) + t / 1e3 / calls
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="256,512,1024,2048,4096")
    ap.add_argument("--profile", action="store_true", help="device ms per stage kernel at the timed row counts")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from neurallaplacecontrol_tpu_torch.ops import nl_cuda
    from neurallaplacecontrol_tpu_torch.utils.device import card

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    log = (nl_cuda.build().parent / "build.log").read_text()
    print("\n".join(line for line in log.splitlines() if any(w in line for w in ("wide", "spill", "Used", "arning"))))
    _, tracked, _ = cs.load_nl(cs.MAIN_ENV, device)
    checks = [rec for w in args.widths.split(",")
              for rec in cs.width_forward_checks(device, int(w), tracked, stages=stage_times if args.profile else None)]
    failures = cs.width_failures(checks)
    print(json.dumps({"failures": failures, **card(device)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

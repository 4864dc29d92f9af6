"""A cell's window with the program's spans recorded and put on the device
trace's clock (``spans.SpanTracer``):

    python3 portbench/span_run.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card. It prints one JSON line: the cell's
per-layer metrics, the span metrics (``spans.SPAN_METRICS``), the host's self
ms a tick by span over the untraced ticks, the device's idle by span over the
traced stretch, and the span counts against the program's forward counter.
It runs no judge.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path[0] = str(Path(__file__).resolve().parents[1])

import portbench.run  # noqa: E402, F401  (the build and kernel caches a run sets)
from portbench import spans  # noqa: E402

if __name__ == "__main__":
    sys.exit(spans.main(sys.argv[1:], t_start=T_START))

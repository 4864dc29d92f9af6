"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. It prints one JSON line last
on standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks`` last) and
the checks, each number beside its limit, as the last lines on standard
error. It exits with another code than 0, and prints no result, without the
CUDA devices the cell asks for or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout, not this directory, whose module names are generic

# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(ROOT / "build" / "portbench-cache" / _sub)

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t_start=T_START))

"""Phase ``deploy`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 scripts/port_deploy_check.py

Builds the kernels, runs phase ``controller`` (whose eager tick the exported
tick is compared with) and phase ``collect`` (whose buffer the ``.rbuf`` check
reads) into a temporary directory, then phase ``deploy``: the exported fused
controller against the eager one, 200 served ticks with the tick log, the
``.rbuf`` round trip, a cold and a warm start on one compile cache, and
``tune.autotune``. Prints the phases' lines and the card; exits non-zero on
any failure.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from neurallaplacecontrol_tpu_torch.ops import nl_cuda  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: phase deploy needs a GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    with cs.phase("build"):
        nl_cuda.library()
    with cs.phase("controller"):
        result = cs.run_controller(device, smi)
    with tempfile.TemporaryDirectory() as tmp:
        with cs.phase("collect"):
            cs.run_collect(device, tmp)
        with cs.phase("deploy"):
            cs.run_deploy(device, smi, tmp, result["tick_ms_mean"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

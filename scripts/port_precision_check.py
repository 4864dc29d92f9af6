"""Phase ``precision`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 scripts/port_precision_check.py

Builds the kernels, runs phase ``eval`` (whose float32 20-seed batch the
bfloat16 and int8 batches are held to), then phase ``precision``: the
reference ``.pt`` through ``interop`` and ``latent_ode_ref``, the bfloat16
and int8 NL routes against float32, and one plan's time per route at K=1,000
and 65,536. Prints the phases' lines and the card; exits non-zero on any
failure.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from neurallaplacecontrol_tpu_torch.ops import nl_cuda  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: phase precision needs a GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    with cs.phase("build"):
        nl_cuda.library()
    with cs.phase("eval"):
        evaluation = cs.run_eval(device, smi)
    with cs.phase("precision"):
        cs.run_precision(device, smi, evaluation["nl_returns"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

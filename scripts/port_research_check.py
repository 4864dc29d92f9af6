"""Phase ``research`` of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 scripts/port_research_check.py

Runs phase ``research``: the five ODE-RL dynamics families' f32 rollouts
against their f64 ones, ENODE against the JAX package's f64 run
(``artifacts/port/jax_research_pendulum.npz``), the f32 demo with each
trainer traced, the three sequence models and the latent data. It builds no
kernel: the phase launches none. Prints the phase's lines and the card;
exits non-zero on any failure.
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: phase research needs a GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp, cs.phase("research"):
        cs.run_research(device, smi, tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""neurallaplacecontrol_tpu_torch — the PyTorch/CUDA port of neurallaplacecontrol_tpu.

The port runs the Neural Laplace Control stack on an NVIDIA H100. It mirrors
the JAX package's module layout and names, so every module here has its
counterpart at the same relative path under ``neurallaplacecontrol_tpu/``,
which stays the reference the port is tested against. The port imports
``torch`` and numpy only; it never imports ``jax`` or the JAX package.

This slice covers one serving-controller tick of the NL flagship
(``serving.make_controller``): checkpoint loading, the NL model with its
fourier ILT, the delay-aware MPPI core, the environments' physics and
rewards, and the planner-path NL forward as a hand-written CUDA kernel
(``ops.pallas_nl``; ``ops.pallas_ilt`` holds its head-only sibling).

Entry points take ``device="cuda"`` by default and raise when CUDA is
absent; pass ``device="cpu"`` to run on the CPU, where every kernel wrapper
computes its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from .config import Config  # noqa: F401
from .envs import make_env  # noqa: F401
from .models import make_model  # noqa: F401
from .serving import Controller, ControllerState, make_controller  # noqa: F401

"""The vendored ODE-RL stack on tensors (port of ``oderl``; SURVEY.md §2.2;
reference envs/oderl/{ctrl,utils}/ — the ICML'21 continuous-time
model-based RL training stack that ships with the reference repo).

Components:
- nets: uncertainty-aware function approximators (BNN, deep ensemble ENN,
  probabilistic ensemble EPNN, batch-ensemble BENN, implicit BNN, MC-dropout)
  with ensemble members on a leading axis.
- dynamics: forward simulation of learned vector fields with the policy in
  the loop — ENODE ensembles, PETS particle propagation, DeepPILCO moment
  matching — and ``OderlDraws``, the stack's random draws.
- dataset: trajectory datasets + RBF kernel action interpolants (smooth
  exploration policies, GP-interpolated replay actions).
- ctrl: the CTRL model container (dynamics + policy + value function).
- train: dynamics fitting (trajectory likelihood / ds-dt regression /
  Gaussian NLL) and actor-critic policy optimization through imagined
  rollouts.
"""

from .nets import (  # noqa: F401
    make_mlp,
    make_bnn,
    make_enn,
    make_epnn,
    make_benn,
    make_ibnn,
    make_dropout_bnn,
)
from .dataset import (  # noqa: F401
    Dataset,
    kernel_interpolate,
    make_kernel_interpolate_policy,
    draw_from_gp,
    collect_data,
)
from .dynamics import (  # noqa: F401
    OderlDraws,
    simulate_enode,
    simulate_pets,
    simulate_deep_pilco,
)
from .ctrl import CTRL, DEFAULTS, DYNAMICS_FAMILIES, ctrl_params_from_jax, make_ctrl  # noqa: F401
from .train import (  # noqa: F401
    gradient_match,
    train_dynamics,
    train_pets,
    train_deep_pilco,
    train_policy,
)

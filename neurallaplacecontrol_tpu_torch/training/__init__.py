"""Training, delay ensembles, episodes, planner closures, policy evaluation
and the MPPI sweep."""

from .ensemble import train_model_ensemble  # noqa: F401
from .eval import evaluate_policy  # noqa: F401
from .rollout import (  # noqa: F401
    EpisodeRecords,
    EpisodeSettings,
    SeedDraws,
    build_goal_running_cost,
    build_learned_dynamics,
    build_oracle_dynamics,
    build_running_cost,
    initial_state,
    make_batched_episode_fn,
    make_episode_fn,
)
from .sweep import SweepSpec, run_mppi_sweep  # noqa: F401
from .train import make_optimizer, make_train_segment_fn, train_model  # noqa: F401

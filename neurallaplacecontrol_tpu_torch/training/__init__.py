"""Training, episodes, planner closures and policy evaluation."""

from .eval import evaluate_policy  # noqa: F401
from .rollout import (  # noqa: F401
    EpisodeRecords,
    EpisodeSettings,
    SeedDraws,
    build_learned_dynamics,
    build_oracle_dynamics,
    build_running_cost,
    initial_state,
    make_batched_episode_fn,
    make_episode_fn,
)
from .train import make_optimizer, make_train_segment_fn, train_model  # noqa: F401

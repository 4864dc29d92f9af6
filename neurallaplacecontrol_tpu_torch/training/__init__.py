"""Episodes, planner closures and policy evaluation (training itself is a later slice)."""

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

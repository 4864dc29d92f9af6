"""Planner closures of ``training/rollout.py``: learned dynamics and the running cost."""

from __future__ import annotations

from typing import Callable

import torch

from ..envs import Env


def build_learned_dynamics(model_apply: Callable, params, dt: float) -> Callable:
    """Wrap a learned model as the planner dynamics closure
    (mppi_with_model.py:103-122): next = state + model(state, window, dt).

    The JAX function also takes the env, the rollout count and the buffer
    size, which it does not use either; here the batch size comes from the
    incoming state, and the query-time column is made once per batch shape."""
    ts_cache = {}

    def dynamics(state, window):
        key = (state.shape[0], state.dtype, state.device)
        ts_pred = ts_cache.get(key)
        if ts_pred is None:
            ts_pred = ts_cache[key] = torch.full(
                (state.shape[0], 1), dt, dtype=state.dtype, device=state.device
            )
        return state + model_apply(params, state, window, ts_pred)

    return dynamics


def build_running_cost(env: Env, state_constraint: bool = False) -> Callable:
    """cost = -(diff_obs_reward_ + diff_ac_reward_) (mppi_with_model.py:145-171).

    With ``state_constraint`` the cartpole cost adds the exponential position
    barrier (mppi_with_model.py:146-151)."""
    if state_constraint:
        if env.reward_state_ext is None:
            raise ValueError(f"{env.spec.name} has no state-constraint reward")

        def running_cost(state, action):
            return -(
                env.reward_state_ext(state, 0.0, state_constraint=True)
                + env.reward_action(action)
            )

        return running_cost

    def running_cost(state, action):
        return -(env.reward_state(state) + env.reward_action(action))

    return running_cost

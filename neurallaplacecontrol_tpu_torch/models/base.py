"""Dynamics-model interface and per-env normalization stats (port of ``models/base.py``).

    delta = model.apply(params, obs[B,n], action_buffer[B,A,m], ts[B,1])

``delta`` predicts the state difference over horizon ``ts``; planners use
``next = obs + delta``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class DynamicsModel:
    name: str
    init: Callable  # (generator) -> params
    apply: Callable  # (params, obs, action_buffer, ts) -> state_diff
    # (params, t) -> apply-compatible forward through the fused kernel (NL only)
    make_fused_planner_apply: Optional[Callable] = None
    # (params) -> encode(windows [K, T, A, m(+1)]) -> action latents [K, T, 2] (NL only)
    make_planner_window_encoder: Optional[Callable] = None
    # (params, obs, latent, ts) -> state_diff: apply with the window pre-encoded (NL only)
    apply_encoded: Optional[Callable] = None


@dataclass(frozen=True)
class NormStats:
    """Hard-coded per-env normalization (reference train_utils.py:187-215)."""

    state_mean: np.ndarray
    state_std: np.ndarray
    action_mean: np.ndarray
    action_std: np.ndarray


def norm_stats_for(env_name: str, action_high: float, action_dim: int) -> NormStats:
    if "cartpole" in env_name:
        state_mean = np.zeros(5)
        state_std = np.array([2.88646771, 11.54556671, 0.70729307, 0.70692035, 17.3199048])
    elif "pendulum" in env_name:
        state_mean = np.zeros(3)
        state_std = np.array([0.70634571, 0.70784512, 2.89072771])
    elif "acrobot" in env_name:
        state_mean = np.zeros(6)
        state_std = np.array(
            [0.70711024, 0.70710328, 0.7072186, 0.7069949, 2.88642115, 2.88627309]
        )
    else:
        raise ValueError(f"No normalization stats for env {env_name}")
    return NormStats(
        state_mean=state_mean,
        state_std=state_std,
        action_mean=np.zeros(action_dim),
        action_std=np.full(action_dim, action_high / 2.0),
    )

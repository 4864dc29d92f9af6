"""Oracle-as-ground-truth model validation (port of ``data/validation.py``).

Rebuild of the reference's de-facto unit tests (overlay.py:86-219):
synthetic (state, action-buffer) pairs are generated, the "true" next state
is recomputed with the closed-form oracle at a fixed horizon ts=dt, and the
model's predicted state difference is scored with MSE against the oracle's.
"""

from __future__ import annotations

import torch

from ..envs import Env
from ..envs.oracle import ORACLES
from .synthetic import SyntheticDraws, generate_irregular_data_delay_time_multi


def compute_val_data_delay(
    env: Env,
    delay: int,
    draws,
    samples_per_dim: int = 5,
    action_buffer_size: int = 4,
    encode_obs_time: bool = False,
):
    """(s0, a0, sn, ts) with sn replaced by the oracle's one-step prediction
    at ts = dt (overlay.compute_val_data_delay:118-134 /
    get_val_loss_delay_time_multi:137-177); ``draws`` as for the generator."""
    s0, a0, sn, _ = generate_irregular_data_delay_time_multi(
        env, draws, delay,
        samples_per_dim=samples_per_dim,
        action_buffer_size=action_buffer_size,
        encode_obs_time=encode_obs_time,
    )
    ts = torch.full((s0.shape[0], 1), env.spec.dt, dtype=s0.dtype, device=s0.device)
    oracle = ORACLES[env.spec.name]
    sn = oracle(s0, a0, ts, delay, friction=env.spec.friction)
    return s0, a0, sn, ts


def get_val_loss_delay_time_multi(
    model_apply,
    params,
    env: Env,
    delay: int,
    draws=None,
    samples_per_dim: int = 5,
    action_buffer_size: int = 4,
    encode_obs_time: bool = False,
    dtype=torch.float32,
    device="cuda",
) -> float:
    """MSE(model state-diff, oracle state-diff) on fresh synthetic data
    (overlay.get_val_loss_delay_time_multi:137-177). Without ``draws`` the
    data come from ``SyntheticDraws(0, dtype, device)``, the counterpart of
    the JAX function's ``PRNGKey(0)``."""
    draws = SyntheticDraws(0, dtype=dtype, device=device) if draws is None else draws
    s0, a0, sn, ts = compute_val_data_delay(
        env, delay, draws,
        samples_per_dim=samples_per_dim,
        action_buffer_size=action_buffer_size,
        encode_obs_time=encode_obs_time,
    )
    return get_val_loss_delay_precomputed(model_apply, params, s0, a0, sn, ts)


def get_val_loss_delay_precomputed(model_apply, params, s0, a0, sn, ts) -> float:
    """MSE on a fixed validation set (overlay.get_val_loss_delay_precomputed
    :112-116)."""
    with torch.no_grad():
        pred_sd = model_apply(params, s0, a0, ts)
        return float(torch.mean((pred_sd - (sn - s0)) ** 2))

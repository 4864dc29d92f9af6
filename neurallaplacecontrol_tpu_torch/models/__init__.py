"""Dynamics model families with the (obs, action_buffer, ts) -> delta interface.

This slice ports the Neural Laplace flagship; the other families of the JAX
package are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..config import Config
from .base import DynamicsModel, NormStats, norm_stats_for  # noqa: F401
from .nl import make_nl_model


def make_model(
    model_name: str,
    env_name: str,
    state_dim: int,
    action_dim: int,
    action_high: float,
    config: Config = Config(),
    dtype=torch.float32,
    device="cuda",
) -> DynamicsModel:
    """Model factory (the JAX package's ``models.make_model``), NL only."""
    if model_name != "nl":
        raise NotImplementedError(f"model {model_name!r} is not ported yet; only 'nl' is")
    norm = norm_stats_for(env_name, action_high, action_dim)
    return make_nl_model(
        state_dim,
        action_dim,
        norm,
        s_recon_terms=config.nl_s_recon_terms,
        ilt_algorithm=config.nl_ilt_algorithm,
        compute_dtype=config.nl_compute_dtype,
        encode_obs_time=config.encode_obs_time,
        normalize=config.normalize,
        normalize_time=config.normalize_time,
        dt=config.dt,
        dtype=dtype,
        device=device,
    )

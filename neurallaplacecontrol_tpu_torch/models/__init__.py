"""Dynamics model families with the (obs, action_buffer, ts) -> delta interface:
Neural Laplace (the flagship), RNN, DeltaT-RNN, NODE and the latent ODE,
and ``latent_ode_ref``, the reference-layout latent ODE into which
reference ``.pt`` checkpoints transplant (``interop``).
"""

from __future__ import annotations

import torch

from ..config import Config
from .base import DynamicsModel, NormStats, norm_stats_for  # noqa: F401
from .common import count_params  # noqa: F401
from .latent_ode import LatentODEModel, make_carried_dynamics, make_latent_ode_model  # noqa: F401
from .latent_ode_ref import RefLatentODEModel, make_ref_latent_ode_model  # noqa: F401
from .nl import make_nl_model
from .node import make_node_model
from .rnn import make_delta_t_rnn_model, make_rnn_model

MODEL_NAMES = ("nl", "rnn", "delta_t_rnn", "node", "latent_ode")


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
    """Model factory (the JAX package's ``models.make_model``, after reference
    train_utils.py:29-156: latent dims, hidden sizes, normalization stats)."""
    norm = norm_stats_for(env_name, action_high, action_dim)
    common = dict(
        encode_obs_time=config.encode_obs_time,
        normalize=config.normalize,
        normalize_time=config.normalize_time,
        dt=config.dt,
        dtype=dtype,
        device=device,
    )
    if model_name == "nl":
        return make_nl_model(
            state_dim, action_dim, norm,
            hidden_units=config.nl_hidden_units,
            s_recon_terms=config.nl_s_recon_terms,
            ilt_algorithm=config.nl_ilt_algorithm,
            compute_dtype=config.nl_compute_dtype,
            **common,
        )
    if model_name == "rnn":
        return make_rnn_model(state_dim, action_dim, norm, hidden_units=config.rnn_hidden_units, **common)
    if model_name == "delta_t_rnn":
        return make_delta_t_rnn_model(state_dim, action_dim, norm, hidden_units=config.rnn_hidden_units,
                                      **common)
    if model_name == "node":
        return make_node_model(
            state_dim, action_dim, norm,
            hidden_units=config.node_hidden_units,
            augment_dim=config.node_augment_dim,
            method=config.node_method,
            **common,
        )
    if model_name == "latent_ode":
        return make_latent_ode_model(
            state_dim, action_dim, norm,
            hidden_units=config.latent_ode_hidden_units,
            obsrv_std=config.latent_ode_obsrv_std,
            action_buffer_size=config.action_buffer_size,
            noise_rows=config.mppi_roll_outs,
            **common,
        )
    if model_name == "latent_ode_ref":
        # the reference-layout twin for transplanted `.pt` checkpoints
        # (interop.latent_ode_params_from_state_dict); it plans through the
        # generic learned path
        return make_ref_latent_ode_model(
            state_dim, action_dim, norm,
            hidden_units=config.latent_ode_hidden_units,
            action_buffer_size=config.action_buffer_size,
            **common,
        )
    raise ValueError(f"Unknown model: {model_name}")

"""Configuration for the port: the fields of the JAX ``Config`` that the port reads.

Same names and defaults as ``neurallaplacecontrol_tpu/config.py``; a field
that no ported module reads is left out until a later slice needs it, and so
is ``parse_args``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Config:
    dt: float = 0.05

    # training
    learning_rate: float = 1e-4
    training_epochs: int = 10_000_000
    training_batch_size: int = 16
    iters_per_log: int = 500
    clip_grad_norm: float = 0.1
    # reject-don't-clip guard: an update whose batch loss exceeds this factor
    # times the previous segment's median loss (or is non-finite) leaves the
    # params and the Adam state untouched; None or 0 disables the factor cap
    # (non-finite losses are always skipped)
    training_loss_skip_factor: Optional[float] = 100.0
    normalize: bool = True
    normalize_time: bool = True
    train_dt_multiple: float = 1.0
    ts_grid: str = "exp"  # ['fixed', 'uniform', 'exp']
    train_samples_per_dim: int = 10
    weight_decay: float = 0.0
    lr_scheduler_step_size: int = 20
    lr_scheduler_gamma: float = 0.1
    use_lr_scheduler: bool = False
    iters_per_evaluation: float = 1e15
    end_training_after_seconds: Optional[float] = 180.0
    training_use_only_samples: Optional[int] = None
    train_with_expert_trajectories: bool = True
    rand_sample: bool = True
    reuse_state_actions_when_sampling_times: bool = False

    # models
    nl_ilt_algorithm: str = "fourier"
    nl_hidden_units: int = 128
    nl_s_recon_terms: int = 17
    nl_compute_dtype: str = "float32"

    # baseline families
    node_method: str = "euler"
    node_augment_dim: int = 1
    node_hidden_units: int = 270
    rnn_hidden_units: int = 160
    latent_ode_hidden_units: int = 128
    latent_ode_obsrv_std: float = 0.01

    # MPPI planner
    mppi_roll_outs: int = 1000
    mppi_time_steps: int = 40
    mppi_lambda: float = 1.0
    mppi_sigma: float = 1.0
    # run the NL planner dynamics through the fused forward kernel
    # (ops.pallas_nl); fourier ILT only
    fused_nl_planner: bool = False
    # hoist the NL window encoding out of the horizon loop (not ported:
    # evaluation raises when it is set without fused_nl_planner)
    nl_planner_precompute: bool = False

    # expert data collection
    collect_expert_samples: float = 1e6
    collect_expert_ts_grid: str = "exp"
    collect_expert_force_generate_new_data: bool = False
    collect_expert_random_action_noise: Optional[float] = 1.0

    # episode / env protocol
    encode_obs_time: bool = False
    action_buffer_size: int = 4
    observation_noise: float = 0.0
    friction: bool = False

    # bookkeeping
    saved_models_path: str = "./saved_models/"
    offline_datasets_path: str = "./offlinedata/"
    save_video: bool = False  # not ported: evaluation raises when it is set
    model_seed: int = 0
    retrain: bool = False
    force_retrain: bool = False
    start_from_checkpoint: bool = True

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def cme_reconstruction_terms() -> tuple:
    """Valid CME term counts (reference: config.py:278-418): odd orders
    assembled from the published table."""
    base = tuple(range(3, 76))
    mid = tuple(range(101, 212, 10)) + (216,) + tuple(range(221, 392, 10)) + (396,)
    high = tuple(range(401, 482, 20)) + tuple(range(501, 1002, 20))
    return base + mid + high


def snap_cme_terms(s_recon_terms: int) -> int:
    """Snap a requested term count to a valid CME order (w_nl.py:86-88)."""
    terms = np.asarray(cme_reconstruction_terms())
    return int(terms[np.argmin(terms < s_recon_terms) - 2])

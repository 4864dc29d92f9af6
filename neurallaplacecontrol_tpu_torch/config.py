"""Configuration for the port: the fields of the JAX ``Config`` that the port reads.

Same names and defaults as ``neurallaplacecontrol_tpu/config.py``; a field
that no ported module reads is left out until a later slice needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Config:
    dt: float = 0.05
    normalize: bool = True
    normalize_time: bool = True

    # NL model
    nl_ilt_algorithm: str = "fourier"
    nl_s_recon_terms: int = 17
    nl_compute_dtype: str = "float32"

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
    offline_datasets_path: str = "./offlinedata/"
    save_video: bool = False  # not ported: evaluation raises when it is set

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

"""Configuration for the port: the fields of the JAX ``Config`` this slice reads.

Same names and defaults as ``neurallaplacecontrol_tpu/config.py``; a field
the serving tick does not read is left out until a later slice needs it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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

    # episode / env protocol
    encode_obs_time: bool = False
    action_buffer_size: int = 4
    friction: bool = False

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

"""Planners: delay-aware MPPI."""

from .mppi_delay import (  # noqa: F401
    MPPIConfig,
    MPPIParams,
    default_noise_sigma,
    make_mppi_params,
    mppi_command,
    mppi_command_core,
    mppi_reset,
)

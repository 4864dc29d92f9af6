"""Toy trajectory datasets for sequence-model experiments (port of ``data/toy.py``).

Rebuild of reference baseline_models/latent_ode_lib/parse_datasets.py:14-43
(sine and delayed-ramp-loading DDE solutions) with the same grids and
scaling; ``subsample_irregular`` picks the irregular time points the
sequence models train on.

The grids use ``jnp.linspace``'s formula (start (1 - i/div) + stop i/div,
the last point exactly ``stop``); XLA's CPU kernel rounds some points up to
two ulps away from it (as it does from ``torch.linspace``), so the two
packages' grids agree to two ulps.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device


def _linspace(start: float, stop: float, num: int, dtype, device) -> torch.Tensor:
    step = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def sine(trajectories_to_sample: int = 100, t_end: float = 20.0, t_nsamples: int = 200,
         dtype=torch.float32, device="cuda"):
    """(trajectories [N,T,1], t [T]) — parse_datasets.sine:14-22."""
    t = _linspace(t_end / t_nsamples, t_end, t_nsamples, dtype, resolve_device(device))
    y = torch.sin(t)
    return y[None, :, None].expand(trajectories_to_sample, t_nsamples, 1), t


def dde_ramp_loading_time_sol(trajectories_to_sample: int = 100, t_end: float = 20.0,
                              t_nsamples: int = 200, dtype=torch.float32, device="cuda"):
    """Closed-form solution of the delayed ramp-loading problem
    (parse_datasets.dde_ramp_loading_time_sol:25-42)."""
    t = _linspace(t_end / t_nsamples, t_end, t_nsamples, dtype, resolve_device(device))
    seg1 = 0.25 * ((t - 5) - 0.5 * torch.sin(2 * (t - 5)))
    seg2 = 0.25 * ((t - 5) - (t - 10) - 0.5 * torch.sin(2 * (t - 5)) + 0.5 * torch.sin(2 * (t - 10)))
    y = torch.where(t < 5, torch.zeros_like(t), torch.where(t < 10, seg1, seg2)) / 5.0
    return y[None, :, None].expand(trajectories_to_sample, t_nsamples, 1), t


TOY_DATASETS = {"sine": sine, "dde_ramp": dde_ramp_loading_time_sol}


def subsample_irregular(generator: Optional[torch.Generator], trajectories: torch.Tensor, t: torch.Tensor,
                        n_points: int, idx: Optional[torch.Tensor] = None):
    """A sorted random subset of ``n_points`` time points, drawn without
    replacement from ``generator``, or the given index draw ``idx`` (sorted
    here). Returns (trajectories[:, idx], t[idx])."""
    if idx is None:
        idx = torch.randperm(t.shape[0], generator=generator, device=generator.device)[:n_points]
    idx = torch.sort(torch.as_tensor(idx, device=t.device)).values
    return trajectories[:, idx], t[idx]

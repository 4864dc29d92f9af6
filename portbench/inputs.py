"""The inputs the benchmark makes from ``--seed`` and hands to the port and to
the reference alike: the weights, the noise covariance, and the draws of each
episode batch or plant episode."""

from __future__ import annotations

import torch

from . import weights
from .cell import ROOT, Cell
from .seeds import stream_seed


def params(cell: Cell, seed: int, device) -> dict:
    """The cell's weights on ``device``: the checkpoint, widened where the
    configuration says (new units drawn from ``seed``)."""
    tree = weights.load_checkpoint(ROOT / cell.config["checkpoint"])
    widen = cell.config.get("widen")
    if widen:
        return weights.widen(tree, int(widen["width"]), float(widen["std"]), seed, device)
    return weights.to_device(tree, device)


def noise_cov(cell: Cell) -> torch.Tensor:
    """Sigma = sigma^2 (0.5 I + 0.5 1 1^T), the planner's perturbation
    covariance (the Neural Laplace Control code's ``mppi_with_model.py``), float64."""
    nu, sigma = cell.config["m"], cell.config["mppi_sigma"]
    return sigma ** 2 * (0.5 * torch.eye(nu, dtype=torch.float64) + 0.5 * torch.ones((nu, nu), dtype=torch.float64))


def noise_chol(cell: Cell, device, dtype=torch.float32) -> torch.Tensor:
    """The Cholesky factor of ``noise_cov``."""
    return torch.linalg.cholesky(noise_cov(cell)).to(dtype=dtype, device=device)


def initial_states(cell: Cell, generator, count: int, dtype, device) -> torch.Tensor:
    """[count, n_state] initial raw states, uniform in the traffic's box."""
    box = cell.traffic["initial_state"]
    center = torch.tensor(box["center"], dtype=dtype, device=device)
    half = torch.tensor(box["half_width"], dtype=dtype, device=device)
    u = torch.rand((count, center.numel()), generator=generator, dtype=dtype, device=device)
    return center + (2.0 * u - 1.0) * half


class EpisodeDraws:
    """The draws of one batch of S lockstep episodes, with the methods of the
    port's ``training.rollout.SeedDraws`` that an evaluation episode calls.
    The initial states and the first plans come from one stream, the
    planner's perturbations from another, both seeded from (``seed``,
    ``batch``), so a replay draws the same values. ``on_tick(it)`` runs as
    each tick asks for its perturbations, before it plans."""

    def __init__(self, cell: Cell, seed: int, batch, device, on_tick=None):
        self.cell, self.device, self.on_tick = cell, torch.device(device), on_tick
        self.S = int(cell.traffic["seeds"])
        self.chol = noise_chol(cell, device)
        self.g_init = torch.Generator(device=self.device).manual_seed(stream_seed(seed, "batch", batch, "init"))
        self.g_noise = torch.Generator(device=self.device).manual_seed(stream_seed(seed, "batch", batch, "noise"))

    def __len__(self) -> int:
        return self.S

    def reset_state(self, env=None) -> torch.Tensor:  # [S, n_state]
        return initial_states(self.cell, self.g_init, self.S, torch.float32, self.device)

    def plan0(self, cfg=None, params=None) -> torch.Tensor:  # [S, T, nu]
        z = torch.randn((self.S, self.cell.horizon, self.cell.config["m"]), generator=self.g_init,
                        dtype=torch.float32, device=self.device)
        return z @ self.chol.T

    def planner_noise(self, it: int, cfg=None, params=None) -> torch.Tensor:  # [S, K, T, nu]
        if self.on_tick is not None:
            self.on_tick(it)
        z = torch.randn((self.S, self.cell.rollouts, self.cell.horizon, self.cell.config["m"]),
                        generator=self.g_noise, dtype=torch.float32, device=self.device)
        return z @ self.chol.T

    def dt(self, it: int, ts_grid: str, dt: float) -> torch.Tensor:  # [S]
        if ts_grid != "fixed":
            raise ValueError(f"the traffic steps the plant on a fixed grid, not {ts_grid!r}")
        return torch.full((self.S,), dt, dtype=torch.float32, device=self.device)


class PlantDraws:
    """The draws of one plant episode: its initial raw state (float64, on the
    host), its first plan and each tick's perturbations [K, T, nu] (on the
    device), seeded from (``seed``, ``episode``)."""

    def __init__(self, cell: Cell, seed: int, episode, device):
        self.cell, self.device = cell, torch.device(device)
        self.chol = noise_chol(cell, device)
        host = torch.Generator().manual_seed(stream_seed(seed, "episode", episode, "init"))
        self.raw0 = initial_states(cell, host, 1, torch.float64, "cpu")[0]
        g = torch.Generator(device=self.device).manual_seed(stream_seed(seed, "episode", episode, "plan"))
        self.U0 = torch.randn((cell.horizon, cell.config["m"]), generator=g, dtype=torch.float32,
                              device=self.device) @ self.chol.T
        self.g_noise = torch.Generator(device=self.device).manual_seed(
            stream_seed(seed, "episode", episode, "noise"))

    def noise(self) -> torch.Tensor:
        """The next tick's perturbations [K, T, nu]."""
        z = torch.randn((self.cell.rollouts, self.cell.horizon, self.cell.config["m"]), generator=self.g_noise,
                        dtype=torch.float32, device=self.device)
        return z @ self.chol.T

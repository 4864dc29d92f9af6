"""Expert dataset collection: oracle-MPPI episodes with exploration noise
(port of ``data/collector.py``).

Rebuild of reference mppi_dataset_collector.mppi_with_model_collect_data
(:324-443): cache-first, then chunks of full episodes. Each chunk is one
seed-batched episode run (training.rollout), its episodes in lockstep.

Collection protocol (inner_mppi_with_model_collect_data :33-321):
- env with ts_grid='exp' (irregular realized step durations are recorded)
- oracle dynamics inside the planner, delay-aware
- uniform exploration noise on the planned action, amplitude
  collect_expert_random_action_noise * ACTION_HIGH, clipped to bounds
- per-step records (s0, action_buffer_after, sn, realized dt)
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..envs import make_env
from ..planners import MPPIConfig, default_noise_sigma, make_mppi_params
from ..training.rollout import EpisodeSettings, SeedDraws, build_oracle_dynamics, make_episode_fn
from ..utils.device import resolve_device
from .replay import load_replay_buffer, replay_buffer_filename, save_replay_buffer

logger = logging.getLogger(__name__)


def episode_seed(seed: int, episode: int) -> int:
    """The generator seed of one collected episode: distinct per (seed, episode)."""
    return int(np.random.SeedSequence([seed, episode]).generate_state(1, np.uint64)[0]) >> 1


def collect_expert_data(
    env_name: str,
    delay: int,
    config: Config = Config(),
    collect_samples: Optional[float] = None,
    seed: int = 0,
    chunk_episodes: int = 100,
    force_new: Optional[bool] = None,
    dtype=torch.float32,
    device="cuda",
):
    """Returns (s0, a0, sn, ts) on ``device``; loads the cache when present.

    collect_samples transitions => collect_samples / n_steps episodes
    (mppi_dataset_collector.py:402). Episode ``i`` draws from a generator
    seeded with ``episode_seed(seed, i)``.
    """
    device = resolve_device(device)
    collect_samples = collect_samples or config.collect_expert_samples
    force_new = (
        config.collect_expert_force_generate_new_data if force_new is None else force_new
    )
    fname = replay_buffer_filename(
        env_name,
        delay,
        encode_obs_time=config.encode_obs_time,
        action_buffer_size=config.action_buffer_size,
        ts_grid=config.collect_expert_ts_grid,
        random_action_noise=config.collect_expert_random_action_noise,
        observation_noise=config.observation_noise,
        friction=config.friction,
    )
    path = os.path.join(config.offline_datasets_path, fname)
    if not force_new and os.path.isfile(path):
        return load_replay_buffer(path, device=device)

    env = make_env(
        env_name,
        dt=config.dt,
        ts_grid=config.collect_expert_ts_grid,
        friction=config.friction,
    )
    spec = env.spec
    n_steps = int(10.0 / config.dt)
    total_episodes = max(1, int(collect_samples / n_steps))

    mppi_cfg = MPPIConfig(
        num_samples=config.mppi_roll_outs,
        horizon=config.mppi_time_steps,
        nu=spec.m,
        lambda_=1.0,  # collector hardcodes lambda like the evaluator (:76)
        u_scale=spec.action_high,
        u_min=-spec.action_high,
        u_max=spec.action_high,
        encode_obs_time=config.encode_obs_time,
        dt=config.dt,
    )
    mppi_params = make_mppi_params(default_noise_sigma(spec.m, config.mppi_sigma, dtype=dtype, device=device))
    dynamics = build_oracle_dynamics(env, config.dt, delay)
    settings = EpisodeSettings(
        delay=delay,
        n_steps=n_steps,
        action_buffer_size=config.action_buffer_size,
        observation_noise=config.observation_noise,
        explore_noise=config.collect_expert_random_action_noise,
        encode_obs_time=config.encode_obs_time,
    )
    episode = make_episode_fn(env, dynamics, mppi_cfg, mppi_params, settings)

    chunks = []
    done = 0
    while done < total_episodes:
        n = min(chunk_episodes, total_episodes - done)
        draws = SeedDraws([episode_seed(seed, done + i) for i in range(n)], dtype=dtype, device=device)
        totals, rec = episode(draws)
        logger.info(
            "[collect %s d=%d] episodes %d-%d mean return %.1f",
            env_name, delay, done, done + n, float(torch.mean(totals)),
        )
        # flatten [E, n_steps, ...] -> [E * n_steps, ...]
        chunks.append((
            rec.s0.reshape(-1, rec.s0.shape[-1]),
            rec.a0.reshape(-1, *rec.a0.shape[2:]),
            rec.sn.reshape(-1, rec.sn.shape[-1]),
            rec.ts.reshape(-1, 1),
        ))
        done += n

    s0, a0, sn, ts = (torch.cat(parts) for parts in zip(*chunks))
    save_replay_buffer(path, s0, a0, sn, ts)
    return s0, a0, sn, ts


def load_expert_irregular_data_delay_time_multi(env_name, delay, config: Config = Config(), device="cuda"):
    """Name-parity wrapper (reference overlay.py:740-778): ``collect_expert_data``."""
    return collect_expert_data(env_name, delay, config=config, device=device)

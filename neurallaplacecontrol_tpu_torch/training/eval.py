"""Policy evaluation: model + delay-aware MPPI on real env episodes (port of ``training/eval.py``).

Equivalent of reference mppi_with_model.mppi_with_model_evaluate_single_step
(:31-325). The seeds run in lockstep as one seed-batched episode
(training.rollout), the port's counterpart of the JAX module's vmap over
PRNG keys; the NL planner dynamics run through the fused forward kernel
under ``Config.fused_nl_planner``.

The baseline families plan through their plain forward. The latent ODE's
contract is the JAX module's: handed the model itself (a
``models.LatentODEModel``) as ``model_apply``, it plans with the rollout's
own history carried through the horizon (``make_carried_dynamics``); handed
its bare ``apply``, with the current observation tiled as history. Its
planner window carries no age channel.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..envs import make_env, render
from ..models import make_carried_dynamics, make_model
from ..parallel.sharding import Mesh, gather_seeds, make_grid_sharded_episodes, make_k_sharded_mppi_command
from ..planners import MPPIConfig, default_noise_sigma, make_mppi_params, mppi_command
from ..utils.device import resolve_device
from ..utils.timing import profile_trace
from .rollout import (
    EpisodeSettings,
    SeedDraws,
    build_goal_running_cost,
    build_learned_dynamics,
    build_learned_dynamics_encoded,
    build_oracle_dynamics,
    build_running_cost,
    make_episode_fn,
)

logger = logging.getLogger(__name__)

EVAL_MODELS = (
    "nl", "oracle", "random", "delta_t_rnn", "rnn", "node", "latent_ode",
    # the reference-layout latent-ODE twin for transplanted `.pt` checkpoints
    # (models.latent_ode_ref); it plans through the generic learned path
    "latent_ode_ref",
)


def build_planner(
    model_name: str,
    env_name: str,
    action_delay: int,
    config: Config = Config(),
    model_apply=None,
    params=None,
    roll_outs: Optional[int] = None,
    time_steps: Optional[int] = None,
    dtype=torch.float32,
    device="cuda",
):
    """(env, mppi_cfg, mppi_params, dynamics, dynamics_carry_init,
    window_encoder) for one policy, as ``evaluate_policy`` plans it; dynamics
    is None for "random", dynamics_carry_init None but for the latent ODE's
    carried history, window_encoder None but for NL under
    ``Config.nl_planner_precompute`` (without the fused planner)."""
    if model_name not in EVAL_MODELS:
        raise ValueError(f"unknown model {model_name!r}")
    device = resolve_device(device)
    roll_outs = roll_outs or config.mppi_roll_outs
    time_steps = time_steps or config.mppi_time_steps
    dt = config.dt
    env = make_env(env_name, dt=dt, friction=config.friction)
    spec = env.spec
    mppi_cfg = MPPIConfig(
        num_samples=roll_outs,
        horizon=time_steps,
        nu=spec.m,
        # the reference hardcodes lambda=1.0 at mppi_with_model.py:72,
        # ignoring the configured mppi_lambda; the JAX package honours the
        # config, and so does the port
        lambda_=config.mppi_lambda,
        u_scale=spec.action_high,
        u_min=-spec.action_high,
        u_max=spec.action_high,
        # the latent ODE takes no age channel (models.latent_ode)
        encode_obs_time=config.encode_obs_time and model_name != "latent_ode",
        dt=dt,
    )
    mppi_params = make_mppi_params(default_noise_sigma(spec.m, config.mppi_sigma, dtype=dtype, device=device))

    if model_name == "oracle":
        return env, mppi_cfg, mppi_params, build_oracle_dynamics(env, dt, action_delay), None, None
    if model_name == "random":
        return env, mppi_cfg, mppi_params, None, None, None
    if model_apply is None or params is None:
        raise ValueError("learned models need model_apply/params (utils.checkpoint.load_pytree)")
    if model_name == "latent_ode" and hasattr(model_apply, "predict_diff"):
        carry_init, dynamics = make_carried_dynamics(model_apply, params, dt, spec.n_obs, spec.m,
                                                     action_buffer_size=config.action_buffer_size)
        return env, mppi_cfg, mppi_params, dynamics, carry_init, None
    if not callable(model_apply):
        raise ValueError(f"model_apply for {model_name!r} must be callable; for latent_ode pass the "
                         "model itself (carried history) or its apply (tiled history)")
    if model_name == "nl" and config.fused_nl_planner and config.nl_ilt_algorithm == "fourier":
        # the planner-path forward through the fused kernel (ops.pallas_nl);
        # the model structure is rebuilt from config to reach the specializer
        if dtype != torch.float32:
            raise ValueError("the fused NL planner runs in float32")
        model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, config,
                           dtype=torch.float32, device=device)
        model_apply = model.make_fused_planner_apply(params, dt, config.action_buffer_size)
    elif model_name == "nl" and config.nl_planner_precompute:
        # the reverse-GRU window encoding out of the horizon loop: the model
        # rebuilt from config reaches the encoder/decoder split, and all K x T
        # windows of a plan encode in one call
        model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, config,
                           dtype=dtype, device=device)
        encoder, dynamics = build_learned_dynamics_encoded(model, params, dt)
        return env, mppi_cfg, mppi_params, dynamics, None, encoder
    return env, mppi_cfg, mppi_params, build_learned_dynamics(model_apply, params, dt), None, None


def _warm_up_tick(env, mppi_cfg, mppi_params, dynamics, n_seeds: int, action_buffer_size: int,
                 state_constraint: bool = False, dynamics_carry_init=None, window_encoder=None):
    """One throwaway seed-batched planner tick on noise from a generator of
    its own: it builds and loads the kernel and sets up the device's
    libraries and memory pool, the counterpart of the JAX evaluator's
    ahead-of-time compile. Returns when the device is done."""
    chol = mppi_params.noise_chol
    S, T, nu = n_seeds, mppi_cfg.horizon, mppi_cfg.nu
    like = dict(dtype=chol.dtype, device=chol.device)
    g = torch.Generator(device=chol.device).manual_seed(0)
    obs = env.observe(torch.zeros((S, env.spec.n_state), **like))
    noise = torch.randn((S, mppi_cfg.num_samples, T, nu), generator=g, **like) @ chol.T
    mppi_command(mppi_cfg, mppi_params, dynamics, build_running_cost(env, state_constraint),
                 torch.zeros((S, T, nu), **like), obs, torch.zeros((S, action_buffer_size, nu), **like),
                 noise=noise, dynamics_carry_init=dynamics_carry_init, window_encoder=window_encoder)
    if chol.device.type == "cuda":
        torch.cuda.synchronize(chol.device)


def _shard_plan(model_name, seeds, shard_seeds, shard_rollouts, shard_grid, devices, window_encoder):
    """(mode, ranks, fallback) of a shard request, refused as the JAX
    function's asserts refuse it; mode None is the unsharded path.

    ``ranks`` are the global ranks that take part (``devices``, or every
    rank of the group). The JAX function's two quiet fallbacks are kept and
    named in ``fallback``: the random policy has no rollout batch to shard
    under "rollouts" or "grid", and seeds that do not divide the group run
    unsharded under "seeds"."""
    if shard_grid is not None and (shard_seeds or shard_rollouts):
        raise ValueError("shard_grid is exclusive with shard_seeds/shard_rollouts")
    if shard_seeds and shard_rollouts:
        raise ValueError("shard_rollouts and shard_seeds are exclusive")
    if not (shard_seeds or shard_rollouts or shard_grid is not None):
        if devices is not None:
            raise ValueError("devices restricts a shard mode: pass shard_seeds, shard_rollouts or shard_grid")
        return None, None, None
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    me = dist.get_rank() if dist.is_initialized() else 0
    if me not in ranks:
        raise ValueError(f"rank {me} is not among the devices {ranks}")
    if shard_grid is not None:
        n_s, n_k = shard_grid
        if window_encoder is not None:
            raise ValueError("nl_planner_precompute is not supported on the 2-D grid mesh")
        if model_name == "random":
            return None, ranks, "random policy: no rollout batch to shard (grid)"
        if len(seeds) % n_s:
            raise ValueError(f"{len(seeds)} seeds do not split over shard_grid's seeds axis ({n_s})")
        if len(ranks) < n_s * n_k:
            raise ValueError(f"shard_grid={tuple(shard_grid)} needs {n_s * n_k} devices, only {len(ranks)} available")
        return "grid", ranks, None
    if shard_rollouts:
        if model_name == "random":
            return None, ranks, "random policy: no rollout batch to shard (rollouts)"
        return "rollouts", ranks, None
    if len(seeds) % len(ranks):
        return None, ranks, f"{len(seeds)} seeds do not divide the group of {len(ranks)} (seeds)"
    return "seeds", ranks, None


def evaluate_policy(
    model_name: str,
    env_name: str,
    action_delay: int,
    seeds,
    config: Config = Config(),
    model_apply=None,
    params=None,
    roll_outs: Optional[int] = None,
    time_steps: Optional[int] = None,
    state_constraint: bool = False,
    change_goal: bool = False,
    save_video: Optional[bool] = None,
    profile_trace_dir: Optional[str] = None,
    shard_seeds: bool = False,
    shard_rollouts: bool = False,
    shard_grid: Optional[tuple] = None,
    devices: Optional[list] = None,
    dtype=torch.float32,
    device="cuda",
    draws=None,
) -> dict:
    """Run one episode per seed, all seeds in lockstep; returns the
    reference's result dict fields plus per-seed returns.

    total_reward is rescaled by 200/n_steps (mppi_with_model.py:301).
    ``draws`` replaces the per-seed generators (``rollout.SeedDraws``) with
    any object that has their methods (and ``select`` under a shard mode).
    The timed region starts after the kernel build, the weight repack and
    one warm-up tick (``_warm_up_tick``) and ends when the device is done.

    The shard modes run over ``torch.distributed`` ranks, one process per
    device, and every rank of the group (or of ``devices``, a list of
    global ranks) calls this function together and gets the whole record:

    - ``shard_seeds``: the seeds split over the ranks in contiguous blocks;
    - ``shard_rollouts``: each plan's K rollouts split over the ranks
      (``parallel.sharding.make_k_sharded_mppi_command``), the seeds in
      lockstep on every rank;
    - ``shard_grid=(n_seeds, n_k)``: both, on a 2-D mesh of the first
      n_seeds * n_k ranks (``parallel.sharding.make_grid_sharded_episodes``).

    Outside a process group a process is a world of one, and the modes run
    their one-rank form. Refused with ``ValueError`` as in the JAX package:
    exclusive flags, K or the seeds not divisible by their axis, too few
    ranks, ``nl_planner_precompute`` on the grid. The random policy under
    "rollouts" or "grid" and seeds that do not divide the group under
    "seeds" run unsharded, as in the JAX package, and the port logs it and
    names it in the record's ``shard_fallback``. A shard request adds
    ``shard`` (the mode asked), ``shard_group_size`` and ``shard_fallback``
    to the record.

    ``change_goal`` plans against a goal at x = -2 that moves to +2 once
    half the episode has elapsed (cartpole; ``rollout.build_goal_running_cost``);
    the recorded reward stays the standard one, as in the reference.
    ``save_video`` (default ``config.save_video``) writes the first seed's
    episode to ``{config.log_folder}/{model}_{env}_d{delay}.gif`` after the
    timed region (``envs.render``; under a shard mode, the first rank
    writes it) and raises ``ImportError`` before any episode runs where
    matplotlib or imageio is missing.

    ``profile_trace_dir`` traces the timed episode with ``torch.profiler``
    (``utils.timing.profile_trace``); the trace's writing is timed with it,
    as in the JAX package.
    For ``latent_ode``, ``model_apply`` is the model itself (carried
    history) or its ``apply`` (tiled history), as in the JAX package.
    """
    video = config.save_video if save_video is None else save_video
    if video:
        render.require()
    seeds = [int(s) for s in seeds]  # consumed more than once below
    env, mppi_cfg, mppi_params, dynamics, carry_init, encoder = build_planner(
        model_name, env_name, action_delay, config, model_apply, params, roll_outs, time_steps,
        dtype=dtype, device=device,
    )
    mode, ranks, fallback = _shard_plan(model_name, seeds, shard_seeds, shard_rollouts, shard_grid, devices,
                                        encoder)
    if fallback:
        logger.warning("evaluate_policy %s %s d=%d: %s; running unsharded", model_name, env_name, action_delay,
                       fallback)
    settings = EpisodeSettings(
        delay=action_delay,
        n_steps=int(10.0 / config.dt),  # 10-second episodes (mppi_with_model.py:235-238)
        action_buffer_size=config.action_buffer_size,
        observation_noise=config.observation_noise,
        random_policy=model_name == "random",
        encode_obs_time=mppi_cfg.encode_obs_time,
        state_constraint=state_constraint,
        change_goal=change_goal,
    )
    chol = mppi_params.noise_chol
    if draws is None:
        draws = SeedDraws(seeds, dtype=chol.dtype, device=chol.device)
    if len(draws) != len(seeds):
        raise ValueError(f"draws for {len(draws)} seeds, {len(seeds)} seeds given")
    S = len(seeds)
    group = None
    run_draws, warm_cfg, warm_seeds = draws, mppi_cfg, S
    if mode == "rollouts":
        mesh = Mesh(ranks, ("k",), device=chol.device)
        group = mesh.group()
        cost_fn = build_goal_running_cost(env) if change_goal else build_running_cost(env, state_constraint)
        command_fn = make_k_sharded_mppi_command(mppi_cfg, mppi_params, dynamics, cost_fn, mesh,
                                                 dynamics_carry_init=carry_init, window_encoder=encoder)
        episode = make_episode_fn(env, dynamics, mppi_cfg, mppi_params, settings, command_fn=command_fn)
        warm_cfg = replace(mppi_cfg, num_samples=mppi_cfg.num_samples // mesh.size)
    elif mode == "grid":
        n_s, n_k = shard_grid
        mesh_ranks = np.asarray(ranks[: n_s * n_k]).reshape(n_s, n_k)
        group = Mesh(ranks, ("devices",), device=chol.device).group()
        if (dist.get_rank() if dist.is_initialized() else 0) in mesh_ranks:
            mesh = Mesh(mesh_ranks, ("seeds", "k"), device=chol.device)
            episode = make_grid_sharded_episodes(env, dynamics, mppi_cfg, mppi_params, settings, mesh,
                                                 dynamics_carry_init=carry_init)
            warm_cfg = replace(mppi_cfg, num_samples=mppi_cfg.num_samples // n_k)
            warm_seeds = S // n_s
        else:  # a rank beyond the grid: it only receives the results
            episode = None
    else:
        episode = make_episode_fn(env, dynamics, mppi_cfg, mppi_params, settings, dynamics_carry_init=carry_init,
                                  window_encoder=encoder)
        if mode == "seeds":
            mesh = Mesh(ranks, ("seeds",), device=chol.device)
            group = mesh.group()
            index = range(mesh.coord["seeds"] * (S // mesh.size), (mesh.coord["seeds"] + 1) * (S // mesh.size))
            run_draws, warm_seeds = draws.select(index), S // mesh.size
    if dynamics is not None and episode is not None:
        _warm_up_tick(env, warm_cfg, mppi_params, dynamics, warm_seeds, settings.action_buffer_size,
                      state_constraint, carry_init, encoder)
    if group is not None:  # the group's communicators are set up outside the timed region
        dist.all_reduce(torch.zeros(1, dtype=chol.dtype, device=chol.device), group=group)

    t0 = time.perf_counter()
    with profile_trace(profile_trace_dir):
        if episode is not None:
            totals, records = episode(run_draws)
        if mode == "seeds":
            totals = gather_seeds(totals, index, S, True, group)
        elif mode == "grid" and len(ranks) > n_s * n_k:
            if episode is None:
                totals = torch.zeros(S, dtype=chol.dtype, device=chol.device)
            dist.broadcast(totals, src=ranks[0], group=group)
        if chol.device.type == "cuda":
            torch.cuda.synchronize(chol.device)
    elapsed = time.perf_counter() - t0
    if group is not None:  # the slowest rank's time
        slowest = torch.tensor([elapsed], dtype=torch.float64 if chol.device.type == "cpu" else chol.dtype,
                               device=chol.device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX, group=group)
        elapsed = float(slowest)

    video_path = None
    if video:
        # the first seed's episode (mppi_with_model.py:282-285), written by
        # the rank that holds it
        video_path = f"{config.log_folder}/{model_name}_{env_name}_d{action_delay}.gif"
        if ranks is None or (dist.get_rank() if dist.is_initialized() else 0) == ranks[0]:
            os.makedirs(config.log_folder, exist_ok=True)
            first = type(records)(*(x[0] for x in records))
            video_path = render.save_video(render.render_episode(env, first, delay=action_delay), video_path,
                                           fps=int(1.0 / config.dt))

    scale = 200.0 / settings.n_steps
    totals = totals * scale
    n = len(seeds)
    record = {
        "model_name": model_name,
        "env_name": env_name,
        "roll_outs": mppi_cfg.num_samples,
        "time_steps": mppi_cfg.horizon,
        "dt": config.dt,
        "delay": action_delay,
        "planner": "mpc",
        "seeds": seeds,
        "total_rewards": [float(x) for x in totals],
        "total_reward": float(torch.mean(totals)),
        "total_reward_std": float(torch.std(totals, unbiased=False)),
        "episode_elapsed_time": elapsed,
        "episode_elapsed_time_per_it": elapsed / (settings.n_steps * n),
        "mppi_rollouts_per_sec": mppi_cfg.num_samples * settings.n_steps * n / elapsed,
        "video_path": video_path,
    }
    if ranks is not None:
        asked = "seeds" if shard_seeds else "rollouts" if shard_rollouts else "grid:{}x{}".format(*shard_grid)
        record.update(shard=asked, shard_group_size=len(ranks), shard_fallback=fallback)
    return record

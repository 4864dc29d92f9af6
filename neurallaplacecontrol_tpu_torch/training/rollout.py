"""Control episodes: env + delay buffer + MPPI (port of ``training/rollout.py``).

The JAX module compiles a whole episode into one ``lax.scan`` and batches
seeds with ``jax.vmap``. Here an episode is a Python loop over its steps
that runs S seeds in lockstep: every tensor of the episode carries a leading
seed axis, each step plans all S seeds in one seed-batched planner call
(``planners.mppi_delay``), and nothing in the loop waits for the device.

Each step of the loop, one tick of the S seeds, is one ``tick`` span
(``utils.timing.span``). The same loop serves evaluation (training.eval)
and expert data collection (data.collector): collection adds exploration
noise to the planned action (mppi_dataset_collector.py:250-254), and the
per-step transition records are always kept.

Randomness comes from a draws object (``SeedDraws``): one ``torch.Generator``
per seed, seeded from the seed. Every draw the episode makes goes through
its methods, each of which returns one value per seed; a test may hand in
any object with the same methods, for example one that replays the JAX
package's draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..envs import Env, sample_dt
from ..envs.base import uniform
from ..envs.oracle import ORACLES
from ..planners import MPPIConfig, MPPIParams, mppi_command, mppi_reset
from ..utils.device import resolve_device
from ..utils.timing import TICK, span


class EpisodeRecords(NamedTuple):
    """Per-step transition tuples (mppi_dataset_collector.py:245-268), each
    with a leading seed axis S."""

    s0: torch.Tensor  # [S, n_steps, n_obs] observation before the step
    a0: torch.Tensor  # [S, n_steps, A, m(+1)] action buffer after the step
    sn: torch.Tensor  # [S, n_steps, n_obs] observation after the step
    ts: torch.Tensor  # [S, n_steps] realized step duration
    reward: torch.Tensor  # [S, n_steps]


@dataclass(frozen=True)
class EpisodeSettings:
    delay: int
    n_steps: int = 200
    action_buffer_size: int = 4
    observation_noise: float = 0.0
    explore_noise: Optional[float] = None  # expert-collection action noise
    random_policy: bool = False
    encode_obs_time: bool = False
    # planner-cost variants (mppi_with_model.py:145-163); the recorded episode
    # reward stays the standard diff reward like the reference
    state_constraint: bool = False
    change_goal: bool = False


def build_learned_dynamics(model_apply: Callable, params, dt: float) -> Callable:
    """Wrap a learned model as the planner dynamics closure
    (mppi_with_model.py:103-122): next = state + model(state, window, dt).

    The JAX function also takes the env, the rollout count and the buffer
    size, which it does not use either; here the batch size comes from the
    incoming state, and the query-time column is made once per batch shape."""
    ts_cache = {}

    def dynamics(state, window):
        key = (state.shape[0], state.dtype, state.device)
        ts_pred = ts_cache.get(key)
        if ts_pred is None:
            ts_pred = ts_cache[key] = torch.full(
                (state.shape[0], 1), dt, dtype=state.dtype, device=state.device
            )
        return state + model_apply(params, state, window, ts_pred)

    return dynamics


def build_learned_dynamics_encoded(model, params, dt: float):
    """Planner dynamics with the model's action-window encoding taken out of
    the horizon loop (the planner's ``window_encoder``): the NL window
    encoding depends only on the candidate actions, which MPPI draws in full
    before the rollout, so all K x T windows encode in one call and each
    horizon step only decodes. Returns ``(window_encoder, dynamics)``, with
    the semantics of ``build_learned_dynamics`` (next = state + model(state,
    window, dt))."""
    encode = model.make_planner_window_encoder(params)
    ts_cache = {}

    def dynamics(state, p_action_t):
        key = (state.shape[0], state.dtype, state.device)
        ts_pred = ts_cache.get(key)
        if ts_pred is None:
            ts_pred = ts_cache[key] = torch.full(
                (state.shape[0], 1), dt, dtype=state.dtype, device=state.device
            )
        return state + model.apply_encoded(params, state, p_action_t, ts_pred)

    return encode, dynamics


def build_oracle_dynamics(env: Env, dt: float, delay: int) -> Callable:
    """Closed-form oracle dynamics closure (mppi_with_model.py:129-143). The
    JAX function's unused rollout-count argument is left out."""
    oracle = ORACLES[env.spec.name]

    def dynamics(state, window):
        ts = torch.full((state.shape[0], 1), dt, dtype=state.dtype, device=state.device)
        return oracle(state, window, ts, delay, friction=env.spec.friction)

    return dynamics


def build_running_cost(env: Env, state_constraint: bool = False) -> Callable:
    """cost = -(diff_obs_reward_ + diff_ac_reward_) (mppi_with_model.py:145-171).

    With ``state_constraint`` the cartpole cost adds the exponential position
    barrier (mppi_with_model.py:146-151)."""
    if state_constraint:
        if env.reward_state_ext is None:
            raise ValueError(f"{env.spec.name} has no state-constraint reward")

        def running_cost(state, action):
            return -(
                env.reward_state_ext(state, 0.0, state_constraint=True)
                + env.reward_action(action)
            )

        return running_cost

    def running_cost(state, action):
        return -(env.reward_state(state) + env.reward_action(action))

    return running_cost


def build_goal_running_cost(env: Env) -> Callable:
    """change_goal planner cost: (state, action, goal_x) -> cost
    (mppi_with_model.py:152-162; the goal flips -2 -> +2 mid-episode)."""
    if env.reward_state_ext is None:
        raise ValueError(f"{env.spec.name} has no goal-dependent reward: change_goal needs cartpole")

    def running_cost(state, action, goal_x):
        return -(env.reward_state_ext(state, goal_x) + env.reward_action(action))

    return running_cost


def goal_at(it: int, n_steps: int) -> float:
    """change_goal's goal position at episode step ``it``: -2, then +2 once
    half the episode has elapsed (mppi_with_model.py:236-253)."""
    return 2.0 if it > n_steps / 2.0 else -2.0


def initial_state(env: Env, generator=None, dtype=torch.float32, device=None) -> torch.Tensor:
    """Episode start state; pendulum starts downward-spinning
    (mppi_with_model.py:188-189 overrides reset with [pi, 1])."""
    if device is None and generator is not None:
        device = generator.device
    if env.spec.name == "pendulum":
        return torch.tensor([math.pi, 1.0], dtype=dtype, device=device)
    return env.reset(generator, dtype, device)


class SeedDraws:
    """The randomness of S episodes: one ``torch.Generator`` per seed, on
    ``device``, seeded from the seed. Every method returns one draw per seed,
    stacked on a leading axis; ``it`` is the episode step (a replaying
    stand-in uses it, the generators do not need it)."""

    def __init__(self, seeds, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.generators = [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def __len__(self) -> int:
        return len(self.generators)

    def select(self, index) -> "SeedDraws":
        """The draws of the seeds at positions ``index``: the same
        generators, so a subset of seeds draws what it would in the whole."""
        sub = SeedDraws.__new__(SeedDraws)
        sub.device, sub.dtype = self.device, self.dtype
        sub.generators = [self.generators[i] for i in index]
        return sub

    def _stack(self, draw) -> torch.Tensor:
        return torch.stack([draw(g) for g in self.generators])

    def reset_state(self, env: Env) -> torch.Tensor:  # [S, n_state]
        return self._stack(lambda g: initial_state(env, g, self.dtype, self.device))

    def plan0(self, cfg: MPPIConfig, params: MPPIParams) -> torch.Tensor:  # [S, T, nu]
        return self._stack(lambda g: mppi_reset(g, cfg, params))

    def planner_noise(self, it: int, cfg: MPPIConfig, params: MPPIParams) -> torch.Tensor:
        """[S, K, T, nu] draws of N(0, Sigma), as ``planners.mppi_delay._sample_noise``."""
        z = torch.empty((len(self), cfg.num_samples, cfg.horizon, cfg.nu),
                        dtype=params.noise_chol.dtype, device=self.device)
        for z_s, g in zip(z, self.generators):
            z_s.normal_(generator=g)
        return z @ params.noise_chol.T

    def random_action(self, it: int, nu: int, low: float, high: float) -> torch.Tensor:  # [S, nu]
        return self._stack(lambda g: uniform(g, (nu,), low, high, self.dtype, self.device))

    def dt(self, it: int, ts_grid: str, dt: float) -> torch.Tensor:  # [S]
        if ts_grid == "fixed":  # no draw
            return torch.full((len(self),), dt, dtype=self.dtype, device=self.device)
        return self._stack(lambda g: sample_dt(g, ts_grid, dt, (), self.dtype, self.device))

    def obs_noise(self, it: int, n: int) -> torch.Tensor:  # [S, n] standard normal
        z = torch.empty((len(self), n), dtype=self.dtype, device=self.device)
        for z_s, g in zip(z, self.generators):
            z_s.normal_(generator=g)
        return z

    def explore(self, it: int, nu: int) -> torch.Tensor:  # [S, nu] uniform on [0, 1)
        return self._stack(lambda g: uniform(g, (nu,), 0.0, 1.0, self.dtype, self.device))


def make_episode_fn(
    env: Env,
    dynamics_fn: Optional[Callable],
    mppi_cfg: MPPIConfig,
    mppi_params: MPPIParams,
    settings: EpisodeSettings,
    dynamics_carry_init: Optional[Callable] = None,
    command_fn: Optional[Callable] = None,
    window_encoder: Optional[Callable] = None,
    vary_axis=None,
):
    """Build the episode function: draws -> (total_reward [S], records).

    ``draws`` is a ``SeedDraws`` (or a stand-in with its methods) for S
    seeds; the S episodes run in lockstep. total_reward is each episode's raw
    return (sum of per-step diff rewards, reference
    mppi_with_model.py:272,288); callers rescale by 200/n_steps.
    ``dynamics_carry_init`` makes ``dynamics_fn`` carried dynamics (the
    planner's ``mppi_command_core``): the latent ODE's history.

    ``command_fn`` swaps the planner, for example the K-sharded one of
    ``parallel.sharding.make_k_sharded_mppi_command``: ``command_fn(U, obs,
    action_buffer, noise=..., time_buffer=None, cost_args=()) -> (action,
    U_new, aux)``, handed the episode's global [S, K, T, nu] draw, with the
    running cost built in; under ``settings.change_goal`` that cost is
    ``build_goal_running_cost``'s and the step's goal comes in
    ``cost_args``. ``window_encoder`` goes to the planner.
    ``vary_axis`` is accepted and does nothing: the JAX module promotes the
    episode carry to device-varying inside ``shard_map``, and a rank's
    tensors are its own.
    """
    del vary_axis
    spec = env.spec
    running_cost = build_running_cost(env, state_constraint=settings.state_constraint)
    goal_cost = build_goal_running_cost(env) if settings.change_goal else None
    A, nu = settings.action_buffer_size, spec.m
    delay = settings.delay
    dtype, device = mppi_params.noise_chol.dtype, mppi_params.noise_chol.device

    def episode(draws):
        S = len(draws)
        raw = draws.reset_state(env)  # [S, n_state]
        U = draws.plan0(mppi_cfg, mppi_params)  # [S, T, nu]
        buffer = torch.zeros((S, A, nu), dtype=dtype, device=device)
        # entry ages for encode_obs_time (collector :231-233 initializes
        # flip(arange(A)) * dt)
        ages = (torch.flip(torch.arange(A, dtype=dtype, device=device), dims=(0,)) * spec.dt).repeat(S, 1)
        steps = []
        for it in range(settings.n_steps):
            with span(TICK):
                obs = env.observe(raw)
                # change_goal: the goal goes to the planner's cost as its argument
                cost_args = () if goal_cost is None else (goal_at(it, settings.n_steps),)
                if settings.random_policy:
                    action = draws.random_action(it, nu, -spec.action_high, spec.action_high)
                elif command_fn is not None:
                    action, U, _ = command_fn(
                        U, obs, buffer, noise=draws.planner_noise(it, mppi_cfg, mppi_params),
                        time_buffer=ages if settings.encode_obs_time else None, cost_args=cost_args,
                    )
                else:
                    action, U, _ = mppi_command(
                        mppi_cfg, mppi_params, dynamics_fn, goal_cost or running_cost, U, obs, buffer,
                        noise=draws.planner_noise(it, mppi_cfg, mppi_params),
                        time_buffer=ages if settings.encode_obs_time else None, cost_args=cost_args,
                        dynamics_carry_init=dynamics_carry_init, window_encoder=window_encoder,
                    )
                if settings.explore_noise is not None and not settings.random_policy:
                    # expert-collection exploration on top of the planner action
                    # (collector :250-254)
                    action = action + (
                        (draws.explore(it, nu) - 0.5) * 2.0 * spec.action_high * settings.explore_noise
                    )
                    action = torch.clamp(action, -spec.action_high, spec.action_high)

                # delay buffer roll; delayed action executes (get_action :25-28)
                buffer = torch.roll(buffer, -1, dims=1)
                buffer[:, -1] = action
                executed = buffer[:, -(delay + 1)]

                # env transition: one Euler step over a sampled interval
                delta_t = draws.dt(it, spec.ts_grid, spec.dt)  # [S]
                raw_next = raw + delta_t[:, None] * env.rhs(raw, executed)
                reward = env.reward_state(raw_next) + env.reward_action(executed)

                # entry ages advance by the REALIZED interval; newest entry is 0
                # (collector get_action_with_encode_obs_time :20-24, :206-208)
                ages = torch.roll(ages, -1, dims=1) + delta_t[:, None]
                ages[:, -1] = 0.0

                # observation noise persisted into env state
                # (mppi_with_model.py:203-204)
                if settings.observation_noise > 0.0:
                    raw_next = raw_next + draws.obs_noise(it, raw_next.shape[-1]) * settings.observation_noise

                rec_buffer = buffer
                if settings.encode_obs_time:
                    rec_buffer = torch.cat([buffer, ages[:, :, None]], dim=2)
                steps.append(EpisodeRecords(
                    s0=obs, a0=rec_buffer, sn=env.observe(raw_next), ts=delta_t, reward=reward,
                ))
                raw = raw_next
        records = EpisodeRecords(*(torch.stack(field, dim=1) for field in zip(*steps)))
        return torch.sum(records.reward, dim=1), records

    return episode


def make_batched_episode_fn(env, dynamics_fn, mppi_cfg, mppi_params, settings,
                            dynamics_carry_init=None, command_fn=None, window_encoder=None):
    """seeds -> (total_reward [S], records): the episodes of ``seeds`` in
    lockstep, each drawing from its own generator (``SeedDraws``) on the
    planner's device. The counterpart of the JAX function's vmap over PRNG
    keys (run_exp_multi.py:145 / mppi_dataset_collector.py:411)."""
    episode = make_episode_fn(env, dynamics_fn, mppi_cfg, mppi_params, settings,
                              dynamics_carry_init=dynamics_carry_init,
                              command_fn=command_fn, window_encoder=window_encoder)
    chol = mppi_params.noise_chol

    def episodes(seeds):
        return episode(SeedDraws(seeds, dtype=chol.dtype, device=chol.device))

    return episodes

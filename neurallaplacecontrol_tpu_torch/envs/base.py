"""Functional continuous-time environment API (port of ``envs/base.py``).

An environment is a frozen spec plus pure functions on tensors:

    rhs(state, action)        d(state)/dt; shape-dispatches raw/trig
    observe(raw_state)        raw -> trig observation
    obs_to_state(obs)         trig observation -> raw
    reward_state(s)           state reward (raw or trig form)
    reward_action(a)          action penalty
    reset(generator)          initial raw state

Irregular observation-time sampling follows base_env.build_time_grid:99-134
(``fixed`` / ``uniform`` / ``exp`` grids, ``sample_dt``) with explicit
``torch.Generator``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class EnvSpec:
    """Static environment description."""

    name: str
    n_obs: int  # trig-transformed observation dim
    n_state: int  # raw (angle-form) state dim
    m: int  # action dim
    action_high: float
    dt: float = 0.05
    ts_grid: str = "fixed"  # 'fixed' | 'uniform' | 'exp'
    obs_noise: float = 0.0
    friction: bool = False
    ac_rew_const: float = 0.01
    vel_rew_const: float = 0.01
    n_steps: int = 200


@dataclass(frozen=True)
class Env:
    """Bundle of the spec and the pure physics/reward functions."""

    spec: EnvSpec
    rhs: Callable  # rhs(state, action) -> dstate
    observe: Callable  # raw -> obs
    obs_to_state: Callable  # obs -> raw
    reward_state: Callable  # state (raw or obs form) -> reward
    reward_action: Callable  # action -> reward
    reset: Callable  # (generator, dtype, device) -> raw state
    state_max: tuple  # synthetic-data sampling box (overlay.py:689-694)
    # variant-aware state reward (s, goal_x, state_constraint) for the
    # state-constraint planner cost; None for envs without variants
    reward_state_ext: Optional[Callable] = None

    def diff_reward(self, s, a):
        """reward_state + reward_action (base_env.py:94-97)."""
        return self.reward_state(s) + self.reward_action(a)


def trig_to_angle(cos_t: torch.Tensor, sin_t: torch.Tensor) -> torch.Tensor:
    """Angle from possibly-unnormalized (cos, sin) pairs, with the reference's
    stop-gradient on the normalization constant (base_env.py:297-301)."""
    c = (cos_t * cos_t + sin_t * sin_t).detach()
    return torch.atan2(sin_t / (c * c), cos_t / (c * c))


def uniform(generator, shape, low: float, high: float, dtype, device) -> torch.Tensor:
    """U(low, high) draws from ``generator``, on its device unless ``device`` is given."""
    if device is None and generator is not None:
        device = generator.device
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return u * (high - low) + low


def sample_dt(generator, ts_grid: str, dt: float, shape=(), dtype=torch.float32,
              device=None) -> torch.Tensor:
    """One observation-interval sample per element of ``shape``, drawn from
    ``generator`` (on its device unless ``device`` is given).

    fixed:   dt
    uniform: U(0, 2 dt)
    exp:     Exponential with mean dt
    (base_env.build_time_grid:103-123.)
    """
    if device is None and generator is not None:
        device = generator.device
    if ts_grid == "fixed":
        return torch.full(shape, dt, dtype=dtype, device=device)
    if ts_grid in ("uniform", "random"):
        return uniform(generator, shape, 0.0, 2.0 * dt, dtype, device)
    if ts_grid == "exp":
        return torch.empty(shape, dtype=dtype, device=device).exponential_(generator=generator) * dt
    raise ValueError(f"Unknown ts_grid: {ts_grid}")


def df_du(env: Env, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """Action Jacobian of the dynamics rhs at (state, action), [n_state, m]
    for one state. The reference hand-derives these per env
    (ctcartpole.df_du:136-157, ctpendulum.df_du:86-89); forward-mode AD over
    the shared rhs gives them for every env, as in the JAX package."""
    return torch.func.jacfwd(lambda a: env.rhs(state, a))(action)


def env_step(env: Env, raw_state: torch.Tensor, action: torch.Tensor, delta_t) -> torch.Tensor:
    """One environment transition: a single explicit Euler step of the raw
    dynamics under a constant action (base_env.py:136-163, solver 'euler')."""
    return raw_state + delta_t * env.rhs(raw_state, action)

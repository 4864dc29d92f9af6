"""Continuous-time environments (pendulum / cartpole / acrobot) as pure functions on tensors."""

from . import acrobot, cartpole, oracle, pendulum, render  # noqa: F401
from .base import Env, EnvSpec, df_du, env_step, sample_dt, trig_to_angle  # noqa: F401
from .oracle import ORACLES, oracle_for  # noqa: F401

_FACTORIES = {
    "oderl-pendulum": pendulum.make,
    "oderl-cartpole": cartpole.make,
    "oderl-acrobot": acrobot.make,
    "pendulum": pendulum.make,
    "cartpole": cartpole.make,
    "acrobot": acrobot.make,
}

ENV_NAMES = ("oderl-pendulum", "oderl-cartpole", "oderl-acrobot")


def make_env(env_name: str, dt: float = 0.05, ts_grid: str = "fixed",
             noise: float = 0.0, friction: bool = False) -> Env:
    """Environment factory; the transition is one Euler step (``env_step``)."""
    if env_name not in _FACTORIES:
        raise ValueError(f"Unknown environment: {env_name}")
    return _FACTORIES[env_name](dt=dt, ts_grid=ts_grid, obs_noise=noise, friction=friction)

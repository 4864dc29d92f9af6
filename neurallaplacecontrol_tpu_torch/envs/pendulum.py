"""Continuous-time pendulum swing-up (port of ``envs/pendulum.py``).

Physics and rewards match reference envs/oderl/envs/ctpendulum.py. Raw state
[theta, theta_dot]; trig obs [cos, sin, theta_dot]. g=10, m=1, l=1; action
range +-2.
"""

from __future__ import annotations

import math

import torch

from .base import Env, EnvSpec, trig_to_angle, uniform

_G, _M, _L = 10.0, 1.0, 1.0


def _accel(theta, action0):
    return -3.0 * _G / (2.0 * _L) * torch.sin(theta + math.pi) + 3.0 / (_M * _L**2) * action0


def rhs(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """d(state)/dt; dispatches on raw (2) vs trig (3) last-dim size. The
    action is not clamped here (ctpendulum.torch_rhs applies none)."""
    if state.shape[-1] == 2:
        th, thdot = state[..., 0], state[..., 1]
        return torch.stack([thdot, _accel(th, action[..., 0])], dim=-1)
    costh, sinth, thdot = state[..., 0], state[..., 1], state[..., 2]
    th = trig_to_angle(costh, sinth)
    return torch.stack([-sinth * thdot, costh * thdot, _accel(th, action[..., 0])], dim=-1)


def observe(raw: torch.Tensor) -> torch.Tensor:
    th, thdot = raw[..., 0], raw[..., 1]
    return torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)


def obs_to_state(obs: torch.Tensor) -> torch.Tensor:
    if obs.shape[-1] == 2:
        return obs
    th = trig_to_angle(obs[..., 0], obs[..., 1])
    return torch.stack([th, obs[..., 2]], dim=-1)


def make(dt=0.05, ts_grid="fixed", obs_noise=0.0, friction=False) -> Env:
    spec = EnvSpec(
        name="pendulum", n_obs=3, n_state=2, m=1, action_high=2.0,
        dt=dt, ts_grid=ts_grid, obs_noise=obs_noise, friction=friction,
    )

    def reward_state(s):
        # ctpendulum.diff_obs_reward_:139-151
        if s.shape[-1] == 2:
            th, thdot = s[..., 0], s[..., 1]
            cos_th, sin_th = torch.cos(th), torch.sin(th)
        else:
            cos_th, sin_th, thdot = s[..., 0], s[..., 1], s[..., 2]
        state_reward = -(_L**2) * ((1.0 - cos_th) ** 2 + sin_th**2)
        velocity_reward = -(thdot**2)
        return state_reward + spec.vel_rew_const * velocity_reward

    def reward_action(a):
        return -spec.ac_rew_const * torch.sum(a**2, dim=-1)

    def reset(generator=None, dtype=torch.float32, device=None):
        # ctpendulum.reset:92-98 — start near downward
        s = uniform(generator, (2,), -0.1, 0.1, dtype, device)
        return s + torch.tensor([math.pi, 0.0], dtype=dtype, device=s.device)

    return Env(
        spec=spec, rhs=rhs, observe=observe, obs_to_state=obs_to_state,
        reward_state=reward_state, reward_action=reward_action, reset=reset,
        state_max=(math.pi, 5.0),  # overlay.py:692
    )

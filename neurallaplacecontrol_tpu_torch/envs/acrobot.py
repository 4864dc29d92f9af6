"""Continuous-time fully-actuated acrobot (port of ``envs/acrobot.py``).

Physics and rewards match reference envs/oderl/envs/ctacrobot.py. Raw state
[theta1, theta2, dtheta1, dtheta2]; trig obs [cos1, sin1, cos2, sin2,
dtheta1, dtheta2]. Action range +-5, m=2; ac_rew_const=1e-4,
vel_rew_const=1e-1.
"""

from __future__ import annotations

import math

import torch

from .base import Env, EnvSpec, trig_to_angle, uniform

_M1 = _M2 = 1.0
_L1 = 1.0
_LC1 = _LC2 = 0.5
_I1 = _I2 = 1.0
_G = 9.8
_LINK1 = 1.0
_LINK2 = 1.0


def _accels(theta1, theta2, dtheta1, dtheta2, a0, a1):
    d1 = _M1 * _LC1**2 + _M2 * (_L1**2 + _LC2**2 + 2 * _L1 * _LC2 * torch.cos(theta2)) + _I1 + _I2
    d2 = _M2 * (_LC2**2 + _L1 * _LC2 * torch.cos(theta2)) + _I2
    phi2 = _M2 * _LC2 * _G * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -_M2 * _L1 * _LC2 * dtheta2**2 * torch.sin(theta2)
        - 2 * _M2 * _L1 * _LC2 * dtheta2 * dtheta1 * torch.sin(theta2)
        + (_M1 * _LC1 + _M2 * _L1) * _G * torch.cos(theta1 - math.pi / 2)
        + phi2
    )
    ddtheta2 = (
        a0 + d2 / d1 * phi1 - _M2 * _L1 * _LC2 * dtheta1**2 * torch.sin(theta2) - phi2
    ) / (_M2 * _LC2**2 + _I2 - d2**2 / d1)
    ddtheta1 = -(a1 + d2 * ddtheta2 + phi1) / d1
    return ddtheta1, ddtheta2


def rhs(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    six_d = state.shape[-1] == 6
    if six_d:
        cos1, sin1 = state[..., 0], state[..., 1]
        cos2, sin2 = state[..., 2], state[..., 3]
        dtheta1, dtheta2 = state[..., 4], state[..., 5]
        c1 = (cos1**2 + sin1**2).detach()
        c2 = (cos2**2 + sin2**2).detach()
        theta1 = trig_to_angle(cos1, sin1)
        theta2 = trig_to_angle(cos2, sin2)
    else:
        theta1, theta2 = state[..., 0], state[..., 1]
        dtheta1, dtheta2 = state[..., 2], state[..., 3]
    ddtheta1, ddtheta2 = _accels(theta1, theta2, dtheta1, dtheta2, action[..., 0], action[..., 1])
    if six_d:
        return torch.stack(
            [
                -sin1 * dtheta1 / c1,
                cos1 * dtheta1 / c1,
                -sin2 * dtheta2 / c2,
                cos2 * dtheta2 / c2,
                ddtheta1,
                ddtheta2,
            ],
            dim=-1,
        )
    return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], dim=-1)


def observe(raw: torch.Tensor) -> torch.Tensor:
    t1, t2, v1, v2 = raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3]
    return torch.stack(
        [torch.cos(t1), torch.sin(t1), torch.cos(t2), torch.sin(t2), v1, v2], dim=-1
    )


def obs_to_state(obs: torch.Tensor) -> torch.Tensor:
    if obs.shape[-1] == 4:
        return obs
    theta1 = trig_to_angle(obs[..., 0], obs[..., 1])
    theta2 = trig_to_angle(obs[..., 2], obs[..., 3])
    return torch.stack([theta1, theta2, obs[..., 4], obs[..., 5]], dim=-1)


def make(dt=0.05, ts_grid="fixed", obs_noise=0.0, friction=False) -> Env:
    spec = EnvSpec(
        name="acrobot", n_obs=6, n_state=4, m=2, action_high=5.0,
        dt=dt, ts_grid=ts_grid, obs_noise=obs_noise, friction=friction,
        ac_rew_const=1e-4, vel_rew_const=1e-1,
    )

    def reward_state(s):
        # ctacrobot.diff_obs_reward_:233-252 — tip distance to full extension
        if s.shape[-1] == 6:
            s = obs_to_state(s)
        th1, th2, vel1, vel2 = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
        velocity_reward = -(vel1**2) - vel2**2
        p2x = -_LINK1 * torch.cos(th1) - _LINK2 * torch.cos(th1 + th2)
        p2y = _LINK1 * torch.sin(th1) + _LINK2 * torch.sin(th1 + th2)
        state_reward = -((p2x - _LINK1 - _LINK2) ** 2) - p2y**2
        return state_reward + spec.vel_rew_const * velocity_reward

    def reward_action(a):
        return -spec.ac_rew_const * torch.sum(a**2, dim=-1)

    def reset(generator=None, dtype=torch.float32, device=None):
        # ctacrobot.reset:148-151
        return uniform(generator, (4,), -0.1, 0.1, dtype, device)

    return Env(
        spec=spec, rhs=rhs, observe=observe, obs_to_state=obs_to_state,
        reward_state=reward_state, reward_action=reward_action, reset=reset,
    )

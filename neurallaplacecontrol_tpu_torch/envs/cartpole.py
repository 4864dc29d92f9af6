"""Continuous-time cartpole swing-up (port of ``envs/cartpole.py``).

Physics and rewards match reference envs/oderl/envs/ctcartpole.py. Raw state
[x, x_dot, theta, theta_dot]; trig obs [x, x_dot, l cos, l sin, theta_dot].
Action range +-3.
"""

from __future__ import annotations

import math

import torch

from .base import Env, EnvSpec, trig_to_angle, uniform

_GRAVITY = 9.8
_MASSCART = 1.0
_MASSPOLE = 0.1
_LENGTH = 1.0  # actually half the pole's length
_TOTAL_MASS = _MASSPOLE + _MASSCART
_POLEMASS_LENGTH = _MASSPOLE * _LENGTH
_FORCE_MAG = 3.0
_FRICTION_CART = 5e-4
_FRICTION_POLE = 2e-6


def _accels(x_dot, costheta, sintheta, theta_dot, action0, friction: bool):
    # torch_rhs clamps the action to +-force_mag before scaling (:210-211)
    action0 = torch.clamp(action0, -_FORCE_MAG, _FORCE_MAG)
    force = action0 * _FORCE_MAG
    if friction:
        temp = (
            force
            + _POLEMASS_LENGTH * theta_dot * theta_dot * sintheta
            - _FRICTION_CART * torch.sign(x_dot)
        ) / _TOTAL_MASS
        thetaacc = (
            _GRAVITY * sintheta
            - costheta * temp
            - _FRICTION_POLE * theta_dot / _POLEMASS_LENGTH
        ) / (_LENGTH * (4.0 / 3.0 - _MASSPOLE * costheta * costheta / _TOTAL_MASS))
    else:
        temp = (force + _POLEMASS_LENGTH * theta_dot * theta_dot * sintheta) / _TOTAL_MASS
        thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
            _LENGTH * (4.0 / 3.0 - _MASSPOLE * costheta * costheta / _TOTAL_MASS)
        )
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS
    return xacc, thetaacc


def make_rhs(friction: bool):
    def rhs(state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        five_d = state.shape[-1] == 5
        if five_d:
            x_dot = state[..., 1]
            costheta, sintheta, theta_dot = state[..., 2], state[..., 3], state[..., 4]
            c = (costheta**2 + sintheta**2).detach()
        else:
            x_dot, theta, theta_dot = state[..., 1], state[..., 2], state[..., 3]
            costheta, sintheta = torch.cos(theta), torch.sin(theta)
        xacc, thetaacc = _accels(x_dot, costheta, sintheta, theta_dot, action[..., 0], friction)
        if five_d:
            return torch.stack(
                [x_dot, xacc, -sintheta * theta_dot / c, costheta * theta_dot / c, thetaacc],
                dim=-1,
            )
        return torch.stack([x_dot, xacc, theta_dot, thetaacc], dim=-1)

    return rhs


def observe(raw: torch.Tensor) -> torch.Tensor:
    x, x_dot, theta, theta_dot = raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3]
    return torch.stack(
        [x, x_dot, _LENGTH * torch.cos(theta), _LENGTH * torch.sin(theta), theta_dot], dim=-1
    )


def obs_to_state(obs: torch.Tensor) -> torch.Tensor:
    if obs.shape[-1] == 4:
        return obs
    theta = trig_to_angle(obs[..., 2], obs[..., 3])
    return torch.stack([obs[..., 0], obs[..., 1], theta, obs[..., 4]], dim=-1)


def end_effector_reward(s, goal_x=0.0, state_constraint: bool = False,
                        vel_rew_const: float = 0.01):
    """Variant-aware end-effector state reward (ctcartpole.diff_obs_reward_,
    swing_up branch); state_constraint adds the barrier exp(10 err_x + 7)."""
    if s.shape[-1] == 4:
        x, xdot, theta, thetadot = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
        cos_len, sin_len = _LENGTH * torch.cos(theta), _LENGTH * torch.sin(theta)
    else:
        x, xdot = s[..., 0], s[..., 1]
        cos_len, sin_len, thetadot = s[..., 2], s[..., 3], s[..., 4]
    err_x = (x + sin_len) - goal_x
    err_y = cos_len - _LENGTH
    if state_constraint:
        position_error = err_x**2 + torch.exp(err_x * 10.0 + 7.0)
    else:
        position_error = err_x**2
    state_reward = -(position_error + err_y**2)
    velocity_reward = -(xdot**2) - thetadot**2
    return state_reward + vel_rew_const * velocity_reward


def make(dt=0.05, ts_grid="fixed", obs_noise=0.0, friction=False) -> Env:
    spec = EnvSpec(
        name="cartpole", n_obs=5, n_state=4, m=1, action_high=3.0,
        dt=dt, ts_grid=ts_grid, obs_noise=obs_noise, friction=friction,
    )

    def reward_state(s):
        return end_effector_reward(s, vel_rew_const=spec.vel_rew_const)

    def reward_state_ext(s, goal_x, state_constraint=False):
        return end_effector_reward(
            s, goal_x=goal_x, state_constraint=state_constraint,
            vel_rew_const=spec.vel_rew_const,
        )

    def reward_action(a):
        return -spec.ac_rew_const * torch.sum(a**2, dim=-1)

    def reset(generator=None, dtype=torch.float32, device=None):
        # ctcartpole.reset:160-170 (swing_up: pole starts downward)
        s = uniform(generator, (4,), -0.05, 0.05, dtype, device)
        return s + torch.tensor([0.0, 0.0, math.pi, 0.0], dtype=dtype, device=s.device)

    return Env(
        spec=spec, rhs=make_rhs(friction), observe=observe, obs_to_state=obs_to_state,
        reward_state=reward_state, reward_action=reward_action, reset=reset,
        reward_state_ext=reward_state_ext,
    )

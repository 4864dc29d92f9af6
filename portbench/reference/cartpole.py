"""The continuous-time cartpole swing-up, from its published equations.

ODE-RL's ``ctcartpole.py``, as the Neural Laplace Control code vendors it
(``envs/oderl/envs/ctcartpole.py``), swing-up, explicit Euler: gravity 9.8, cart mass 1.0, pole mass 0.1, pole
half-length 1.0, force 3 times the action clipped to [-3, 3], no friction.
The raw state is (x, x', theta, theta'); the observation is (x, x', l cos
theta, l sin theta, theta'). The reward of a state is minus the squared
distance of the pole's tip from its upright goal above x = 0, less 0.01
times the squared velocities; an action costs 0.01 times its square.
"""

from __future__ import annotations

import torch

GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
LENGTH = 1.0
FORCE_MAG = 3.0
TOTAL_MASS = MASS_CART + MASS_POLE
POLE_MASS_LENGTH = MASS_POLE * LENGTH
VEL_REWARD = 0.01
ACTION_REWARD = 0.01


def rhs(raw: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """d(raw state)/dt [..., 4] under the action [..., 1]."""
    x_dot, theta, theta_dot = raw[..., 1], raw[..., 2], raw[..., 3]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    force = torch.clamp(action[..., 0], -FORCE_MAG, FORCE_MAG) * FORCE_MAG
    temp = (force + POLE_MASS_LENGTH * theta_dot * theta_dot * sin_t) / TOTAL_MASS
    theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
        LENGTH * (4.0 / 3.0 - MASS_POLE * cos_t * cos_t / TOTAL_MASS))
    x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS
    return torch.stack([x_dot, x_acc, theta_dot, theta_acc], dim=-1)


def observe(raw: torch.Tensor) -> torch.Tensor:
    theta = raw[..., 2]
    return torch.stack([raw[..., 0], raw[..., 1], LENGTH * torch.cos(theta), LENGTH * torch.sin(theta),
                        raw[..., 3]], dim=-1)


def raw_from_obs(obs: torch.Tensor) -> torch.Tensor:
    """The raw state of an observation, the angle taken in (-pi, pi]."""
    return torch.stack([obs[..., 0], obs[..., 1], torch.atan2(obs[..., 3], obs[..., 2]), obs[..., 4]], dim=-1)


def reward_obs(obs: torch.Tensor) -> torch.Tensor:
    """The state reward of observations [..., 5]."""
    err_x = obs[..., 0] + obs[..., 3]
    err_y = obs[..., 2] - LENGTH
    return -(err_x * err_x + err_y * err_y) - VEL_REWARD * (obs[..., 1] ** 2 + obs[..., 4] ** 2)


def reward_action(action: torch.Tensor) -> torch.Tensor:
    return -ACTION_REWARD * torch.sum(action * action, dim=-1)


def step(raw: torch.Tensor, action: torch.Tensor, delta_t) -> tuple[torch.Tensor, torch.Tensor]:
    """One explicit Euler step of ``delta_t`` seconds: (next raw state, reward
    of the next state and the action)."""
    nxt = raw + delta_t * rhs(raw, action)
    return nxt, reward_obs(observe(nxt)) + reward_action(action)

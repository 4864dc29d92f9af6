"""Closed-form one-Euler-step oracle dynamics with action delay (port of ``envs/oracle.py``).

Each oracle selects the delayed action ``buffer[..., -(delay+1), :nu]`` from
the action-history buffer, clamps it to the env's action bounds, advances
the raw (angle-form) state by one explicit Euler step of the physics rhs,
and returns the state in the form (raw or trig) it was given. The reference
(oracle.py:11-224) updates velocities with the new acceleration and
positions with the old velocity, which is exactly that Euler step, so the
oracle equals the env transition by construction.

The ``*_dynamics_dt`` variants take a single action (delay 0). The
two-frame ``cartpole_dynamics_dt_latent*`` variants reconstruct velocities
from the current and previous frames and step semi-implicit Euler
(``data.synthetic.generate_irregular_data_delay_latent`` reads them).
"""

from __future__ import annotations

from functools import partial

import torch

from . import acrobot as _acrobot
from . import cartpole as _cartpole
from . import pendulum as _pendulum
from .base import trig_to_angle


def _delayed_action(action_buffer: torch.Tensor, delay: int, nu: int) -> torch.Tensor:
    """The action executed ``delay`` steps ago (oracle.py:23,99,187).

    ``action_buffer``: [..., A, m(+time-channel)]; returns [..., nu].
    """
    return action_buffer[..., -(delay + 1), :nu]


def _flat_ts(ts: torch.Tensor) -> torch.Tensor:
    """[B, 1] or [B] query times -> [B]."""
    return ts.reshape(ts.shape[:1]) if ts.dim() > 1 else ts


def pendulum_dynamics_dt_delay(
    state, action_buffer, ts, delay, action_low=-2.0, action_high=2.0, friction=False
):
    """oracle.pendulum_dynamics_dt_delay:177-224. state [...,2] or [...,3]."""
    u = torch.clamp(_delayed_action(action_buffer, delay, 1), action_low, action_high)
    raw = _pendulum.obs_to_state(state)
    new_raw = raw + _flat_ts(ts)[..., None] * _pendulum.rhs(raw, u)
    if state.shape[-1] == 2:
        return new_raw
    return _pendulum.observe(new_raw)


def cartpole_dynamics_dt_delay(
    state, action_buffer, ts, delay, action_low=-3.0, action_high=3.0, friction=False
):
    """oracle.cartpole_dynamics_dt_delay:11-86. state [...,4] or [...,5]."""
    u = torch.clamp(_delayed_action(action_buffer, delay, 1), action_low, action_high)
    raw = _cartpole.obs_to_state(state)
    new_raw = raw + _flat_ts(ts)[..., None] * _cartpole.make_rhs(friction)(raw, u)
    if state.shape[-1] == 4:
        return new_raw
    return _cartpole.observe(new_raw)


def acrobot_dynamics_dt_delay(
    state, action_buffer, ts, delay, action_low=-5.0, action_high=5.0, friction=False
):
    """oracle.acrobot_dynamics_dt_delay:89-174. state [...,4] or [...,6]."""
    u = torch.clamp(_delayed_action(action_buffer, delay, 2), action_low, action_high)
    raw = _acrobot.obs_to_state(state)
    new_raw = raw + _flat_ts(ts)[..., None] * _acrobot.rhs(raw, u)
    if state.shape[-1] == 4:
        return new_raw
    return _acrobot.observe(new_raw)


def _finite_diff_angles(cos_t, sin_t, cos_p, sin_p, ts):
    """theta, theta_dot from two trig frames (oracle.py:240-253, 312-325)."""
    theta = trig_to_angle(cos_t, sin_t)
    return theta, (theta - trig_to_angle(cos_p, sin_p)) / ts


def _latent_ts(ts: torch.Tensor) -> torch.Tensor:
    return ts[..., 0] if ts.dim() > 1 else ts


def cartpole_dynamics_dt_latent(state, prev_state, action, ts, action_low=-3.0, action_high=3.0):
    """Two-frame cartpole step (oracle.cartpole_dynamics_dt_latent:299-375).

    Velocities are reconstructed by finite differences of the current and
    previous frame; the update is SEMI-IMPLICIT Euler (the new velocity
    advances the position, oracle.py:355-366), unlike the explicit-Euler
    delay oracle. state/prev_state: [..., 5] trig form
    (x, x_dot, l cos, l sin, theta_dot; stored velocities are ignored) or
    [..., 4] raw (x, x_dot, theta, theta_dot).
    """
    u = torch.clamp(action[..., 0], action_low, action_high)
    ts = _latent_ts(ts)
    x = state[..., 0]
    x_dot = (x - prev_state[..., 0]) / ts
    trig = state.shape[-1] == 5
    if trig:
        theta, theta_dot = _finite_diff_angles(state[..., 2], state[..., 3], prev_state[..., 2],
                                               prev_state[..., 3], ts)
    else:
        theta = state[..., 2]
        theta_dot = (theta - prev_state[..., 2]) / ts
    xacc, thetaacc = _cartpole._accels(x_dot, torch.cos(theta), torch.sin(theta), theta_dot, u, False)
    new_theta_dot = theta_dot + thetaacc * ts
    new_theta = theta + new_theta_dot * ts
    new_x_dot = x_dot + xacc * ts
    new_x = x + new_x_dot * ts
    if trig:
        return torch.stack([new_x, new_x_dot, torch.cos(new_theta), torch.sin(new_theta), new_theta_dot], dim=-1)
    return torch.stack([new_x, new_x_dot, new_theta, new_theta_dot], dim=-1)


def cartpole_dynamics_dt_latent_reduced(state, prev_state, action, ts, action_low=-3.0, action_high=3.0):
    """Position-only two-frame cartpole step
    (oracle.cartpole_dynamics_dt_latent_reduced:227-296): state [..., 3] is
    (x, l cos, l sin); velocities come entirely from finite differences and
    the returned frame is position-only again.
    """
    u = torch.clamp(action[..., 0], action_low, action_high)
    ts = _latent_ts(ts)
    x = state[..., 0]
    x_dot = (x - prev_state[..., 0]) / ts
    theta, theta_dot = _finite_diff_angles(state[..., 1], state[..., 2], prev_state[..., 1], prev_state[..., 2], ts)
    xacc, thetaacc = _cartpole._accels(x_dot, torch.cos(theta), torch.sin(theta), theta_dot, u, False)
    new_theta_dot = theta_dot + thetaacc * ts
    new_theta = theta + new_theta_dot * ts
    new_x = x + (x_dot + xacc * ts) * ts
    return torch.stack([new_x, torch.cos(new_theta), torch.sin(new_theta)], dim=-1)


# Non-delayed single-action variants (oracle.py:378-552): delay 0 with the
# action viewed as a one-entry buffer.
def pendulum_dynamics_dt(state, action, ts, **kw):
    return pendulum_dynamics_dt_delay(state, action[..., None, :], ts, 0, **kw)


def cartpole_dynamics_dt(state, action, ts, **kw):
    return cartpole_dynamics_dt_delay(state, action[..., None, :], ts, 0, **kw)


def acrobot_dynamics_dt(state, action, ts, **kw):
    return acrobot_dynamics_dt_delay(state, action[..., None, :], ts, 0, **kw)


ORACLES = {
    "pendulum": pendulum_dynamics_dt_delay,
    "cartpole": cartpole_dynamics_dt_delay,
    "acrobot": acrobot_dynamics_dt_delay,
    "oderl-pendulum": pendulum_dynamics_dt_delay,
    "oderl-cartpole": cartpole_dynamics_dt_delay,
    "oderl-acrobot": acrobot_dynamics_dt_delay,
}


def oracle_for(env_name: str, ts, delay: int, friction: bool = False):
    """Partial out (ts, delay, friction) the way mppi_with_model.py:129-143
    wires the oracle planner dynamics."""
    fn = ORACLES[env_name]
    return partial(fn, ts=ts, delay=delay, friction=friction)

"""Delay-aware Model Predictive Path Integral control (port of ``planners/mppi_delay.py``).

Williams et al. 2017 Algorithm 2 with an action-history buffer for delayed
systems. The receding-horizon plan ``U`` is explicit state: ``command``
takes and returns it.

  1. U <- roll(U, -1); U[-1] = u_init
  2. noise ~ N(0, Sigma)  [K, T, nu];  perturbed = U + noise, bounded to
     [u_min, u_max] in scaled units; noise recomputed after bounding
  3. windows: prepend the action history buffer[1:] to the scaled perturbed
     actions; the dynamics at step t sees full[:, t : t + A, :]
  4. rollout under the dynamics closure, accumulating running costs
  5. cost += lambda * sum_t U_t . (Sigma^-1 noise_t)
  6. omega = softmax(-(cost - min cost)/lambda); U += sum_k omega_k noise_k
  7. action = u_scale * U[0]

The JAX horizon ``lax.scan`` is a Python loop over T here, and the JAX
evaluator's ``vmap`` over seeds is a leading seed axis S on the planner's
inputs. This module ports the flags the serving controller and the evaluator
set, carried dynamics (``dynamics_carry_init``) among them; the JAX module's
``sample_null_action``, ``noise_abs_cost`` and ``u_per_command`` are not
fields here, and its other planner features raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class MPPIConfig:
    """Static planner shape/knobs (the JAX MPPIConfig's fields)."""

    num_samples: int  # K
    horizon: int  # T
    nu: int
    lambda_: float = 1.0
    u_scale: float = 1.0  # multiplies unit-scale controls into env units
    u_min: float = -1.0  # env units (ACTION_LOW)
    u_max: float = 1.0  # env units (ACTION_HIGH)
    encode_obs_time: bool = False
    dt: float = 0.05
    rollout_samples: int = 1  # M; only 1 is ported
    step_dependent_dynamics: bool = False  # not ported


class MPPIParams(NamedTuple):
    noise_sigma: torch.Tensor  # [nu, nu]
    noise_sigma_inv: torch.Tensor  # [nu, nu]
    noise_chol: torch.Tensor  # [nu, nu] lower-triangular
    u_init: torch.Tensor  # [nu]


def make_mppi_params(noise_sigma: torch.Tensor, u_init: Optional[torch.Tensor] = None) -> MPPIParams:
    noise_sigma = torch.atleast_2d(noise_sigma)
    nu = noise_sigma.shape[0]
    return MPPIParams(
        noise_sigma=noise_sigma,
        noise_sigma_inv=torch.linalg.inv(noise_sigma),
        noise_chol=torch.linalg.cholesky(noise_sigma),
        u_init=noise_sigma.new_zeros(nu) if u_init is None else u_init,
    )


def default_noise_sigma(nu: int, sigma: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sigma = sigma^2 * (0.5 I + 0.5 * 11^T) (mppi_with_model.py:66-70)."""
    gamma = sigma**2
    off = 0.5 * gamma
    return (
        torch.ones((nu, nu), dtype=dtype, device=device) * off
        + torch.eye(nu, dtype=dtype, device=device) * (gamma - off)
    )


def _normal(generator, shape, params: MPPIParams) -> torch.Tensor:
    chol = params.noise_chol
    z = torch.randn(shape, generator=generator, dtype=chol.dtype, device=chol.device)
    return z @ chol.T


def mppi_reset(generator, cfg: MPPIConfig, params: MPPIParams) -> torch.Tensor:
    """Fresh control sequence U ~ N(0, Sigma) per timestep."""
    return _normal(generator, (cfg.horizon, cfg.nu), params)


def _sample_noise(generator, cfg: MPPIConfig, params: MPPIParams) -> torch.Tensor:
    return _normal(generator, (cfg.num_samples, cfg.horizon, cfg.nu), params)


def _stack_windows(full: torch.Tensor, T: int, A: int) -> torch.Tensor:
    """All T sliding action windows of ``full`` [K, A-1+T, nu]:
    windows[k, t, a] = full[k, t + a] -> [K, T, A, nu]."""
    return torch.stack([full[:, a : a + T, :] for a in range(A)], dim=2)


def _not_ported(what: str):
    raise NotImplementedError(f"MPPI {what} is not ported yet")


def mppi_command_core(
    cfg: MPPIConfig,
    params: MPPIParams,
    dynamics_fn: Callable,  # (state [S*K,nx], action_window [S*K,A,nu]) -> [S*K,nx]
    running_cost_fn: Callable,  # (state [S*K,nx], action [S*K,nu], *cost_args) -> [S*K]
    U: torch.Tensor,  # [S, T, nu] or [T, nu] — ALREADY receding-horizon shifted
    obs: torch.Tensor,  # [S, nx] or [nx] current observation
    action_buffer: torch.Tensor,  # [S, A, nu] or [A, nu] action history (env units)
    noise: torch.Tensor,  # [S, K, T, nu] or [K, T, nu] pre-sampled noise
    terminal_state_cost: Optional[Callable] = None,
    dynamics_carry_init: Optional[Callable] = None,
    time_buffer: Optional[torch.Tensor] = None,  # [S, A] or [A] ages, encode_obs_time
    cost_args: tuple = (),
    axis=None,
    window_encoder: Optional[Callable] = None,
):
    """The planning step given pre-sampled noise (steps 2-7 of the module
    docstring). Returns (action, U, {"cost_total", "omega"}).

    With a leading seed axis S on every input, S independent plans run in
    lockstep: the dynamics closure sees all S*K rollouts in one call per
    horizon step, and the softmax weighting reduces over each seed's K rows
    only. This is the port's counterpart of ``jax.vmap`` over the planner.
    Without the seed axis the outputs have none either (action [nu], U
    [T, nu], cost_total and omega [K]).

    With ``dynamics_carry_init`` the dynamics carry state through the
    rollout: ``carry = dynamics_carry_init(state0 [S*K, nx])`` is built anew
    at every plan, and ``dynamics_fn(carry, state, window) -> (carry,
    next_state)`` runs at each horizon step (the latent ODE's history,
    ``models.latent_ode.make_carried_dynamics``).
    """
    if terminal_state_cost is not None:
        _not_ported("terminal_state_cost")
    if axis is not None:
        _not_ported("sharding (axis)")
    if window_encoder is not None:
        _not_ported("window_encoder")
    if cfg.rollout_samples != 1:
        _not_ported("rollout_samples > 1")
    if cfg.step_dependent_dynamics:
        _not_ported("step_dependent_dynamics")

    if U.dim() == 2:  # one plan: the S=1 case without its seed axis
        action, U, aux = mppi_command_core(
            cfg, params, dynamics_fn, running_cost_fn, U[None], obs[None], action_buffer[None],
            noise[None], dynamics_carry_init=dynamics_carry_init,
            time_buffer=None if time_buffer is None else time_buffer[None], cost_args=cost_args,
        )
        return action[0], U[0], {k: v[0] for k, v in aux.items()}

    T, nu = cfg.horizon, cfg.nu
    S, K = noise.shape[0], noise.shape[1]
    A = action_buffer.shape[1]

    # 2. bound, recompute noise
    perturbed = torch.clamp((U[:, None] + noise) * cfg.u_scale, cfg.u_min, cfg.u_max) / cfg.u_scale
    noise = perturbed - U[:, None]

    # action perturbation cost
    action_cost = cfg.lambda_ * noise @ params.noise_sigma_inv

    # 3. sliding action windows with prepended history
    scaled = perturbed * cfg.u_scale  # [S, K, T, nu] env units
    hist = action_buffer[:, None, 1:].expand(S, K, A - 1, nu)
    full = torch.cat([hist, scaled], dim=2)  # [S, K, A-1+T, nu]

    if time_buffer is not None:
        ages = time_buffer
    else:
        ages = torch.flip(torch.arange(A, dtype=scaled.dtype, device=scaled.device), dims=(0,)) * cfg.dt
        ages = ages.expand(S, A)

    # 4. rollout over the horizon, all S*K rows in one dynamics call per step
    state = obs[:, None].expand((S, K) + tuple(obs.shape[1:])).reshape((S * K,) + tuple(obs.shape[1:]))
    carry = dynamics_carry_init(state) if dynamics_carry_init is not None else None
    costs = []
    for t in range(T):
        window = full[:, :, t : t + A, :].reshape(S * K, A, nu)
        dyn_in = window
        if cfg.encode_obs_time:
            # time_buffer += dt; roll; newest age = 0
            ages = torch.roll(ages + cfg.dt, -1, dims=1)
            ages[:, -1] = 0.0
            a = ages[:, None, :, None].expand(S, K, A, 1).reshape(S * K, A, 1).to(window.dtype)
            dyn_in = torch.cat([window, a], dim=2)
        if carry is None:
            state = dynamics_fn(state, dyn_in)
        else:
            carry, state = dynamics_fn(carry, state, dyn_in)
        costs.append(running_cost_fn(state, window[:, -1, :], *cost_args))
    cost_total = torch.sum(torch.stack(costs), dim=0).reshape(S, K)

    # 5. perturbation cost
    cost_total = cost_total + torch.sum(U[:, None] * action_cost, dim=(2, 3))

    # 6. softmax weighting + control update, per seed over its K rollouts
    beta = torch.min(cost_total, dim=1, keepdim=True).values
    weights = torch.exp(-(cost_total - beta) / cfg.lambda_)
    omega = weights / torch.sum(weights, dim=1, keepdim=True)
    U = U + torch.sum(omega[:, :, None, None] * noise, dim=1)

    # 7. leading action, env units
    action = U[:, 0] * cfg.u_scale
    return action, U, {"cost_total": cost_total, "omega": omega}


def mppi_command(
    cfg: MPPIConfig,
    params: MPPIParams,
    dynamics_fn: Callable,
    running_cost_fn: Callable,
    U: torch.Tensor,  # [S, T, nu] or [T, nu] carry
    obs: torch.Tensor,  # [S, nx] or [nx] current observation
    action_buffer: torch.Tensor,  # [S, A, nu] or [A, nu] action history (env units)
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    time_buffer: Optional[torch.Tensor] = None,
    cost_args: tuple = (),
    dynamics_carry_init: Optional[Callable] = None,
):
    """One planning step. Returns (action [S, nu] or [nu] in env units, new U, aux).

    ``noise`` [S, K, T, nu] (or [K, T, nu]) replaces the draw from
    ``generator`` when given; a draw from ``generator`` is one plan's.
    """
    # 1. receding horizon shift
    U = torch.roll(U, -1, dims=-2)
    U[..., -1, :] = params.u_init
    if noise is None:
        if U.dim() != 2:
            raise ValueError("a seed-batched plan takes its noise as an argument, one draw per seed")
        noise = _sample_noise(generator, cfg, params)
    return mppi_command_core(
        cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise,
        dynamics_carry_init=dynamics_carry_init, time_buffer=time_buffer, cost_args=cost_args,
    )

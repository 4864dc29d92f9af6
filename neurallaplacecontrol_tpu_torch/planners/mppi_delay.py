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
inputs. Every planner flag of the JAX module is here. Under K-sharding
(``axis``, a ``torch.distributed`` process group) each rank runs this same
code on its K/n block of the noise, and the three reductions of step 6
become ``all_reduce`` MIN and SUM over the group. The JAX module's
``scan_unroll`` has no counterpart: a Python loop has nothing to unroll.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


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
    sample_null_action: bool = False
    noise_abs_cost: bool = False
    # time-age channel on the action window (reference mppi_delay.py:279-287)
    encode_obs_time: bool = False
    dt: float = 0.05
    # M state trajectories per control sequence with a discounted
    # cost-variance penalty: cost = mean over M + rollout_var_cost *
    # discounted var over M (the JAX module's reading of the reference's
    # vestigial M>1 math, :84-86, :108-112)
    rollout_samples: int = 1  # M
    rollout_var_cost: float = 0.0
    rollout_var_discount: float = 0.95
    # pass the horizon step index (an int) to the dynamics as a third argument
    step_dependent_dynamics: bool = False
    # number of leading actions a command returns (1: shape [nu])
    u_per_command: int = 1


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


def shard_block(noise: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of the K axis (dim -3) of a global noise
    draw [(S,) K, T, nu], as ``shard_map``'s ``P(axis)`` splits it."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    K = noise.shape[-3]
    if K % n:
        raise ValueError(f"the group's {n} ranks must divide K={K} (num_samples)")
    return noise.narrow(-3, r * (K // n), K // n)


def mppi_command_core(
    cfg: MPPIConfig,
    params: MPPIParams,
    dynamics_fn: Callable,  # (state [S*M*K,nx], action_window [S*M*K,A,nu]) -> [S*M*K,nx]
    running_cost_fn: Callable,  # (state [S*M*K,nx], action [S*M*K,nu], *cost_args) -> [S*M*K]
    U: torch.Tensor,  # [S, T, nu] or [T, nu] — ALREADY receding-horizon shifted
    obs: torch.Tensor,  # [S, nx] or [nx] current observation
    action_buffer: torch.Tensor,  # [S, A, nu] or [A, nu] action history (env units)
    noise: torch.Tensor,  # [S, K(_local), T, nu] or [K(_local), T, nu] pre-sampled noise
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
    lockstep: the dynamics closure sees all S*M*K rollouts in one call per
    horizon step (rows ordered seed, trajectory sample, rollout), and the
    softmax weighting reduces over each seed's K rows only. This is the
    port's counterpart of ``jax.vmap`` over the planner. Without the seed
    axis the outputs have none either (action [nu], U [T, nu], cost_total
    and omega [K]).

    ``axis`` is a ``torch.distributed`` process group over which the K
    rollouts are split: ``noise`` is this rank's block, the min and the two
    sums of step 6 are ``all_reduce`` MIN and SUM over the group (the only
    communication of the plan), ``sample_null_action`` zeroes the last row
    of the group's last rank, and aux holds this rank's rows. The JAX
    module promotes its carries to device-varying here (``_pvary``); a
    rank's tensors are its own, so that has no counterpart.

    With ``dynamics_carry_init`` the dynamics carry state through the
    rollout: ``carry = dynamics_carry_init(state0)`` is built anew at every
    plan, and ``dynamics_fn(carry, state, window) -> (carry, next_state)``
    runs at each horizon step (the latent ODE's history,
    ``models.latent_ode.make_carried_dynamics``). ``window_encoder``
    (``windows [S*K, T, A, nu(+age)] -> ctx [S*K, T, ...]``) encodes every
    candidate window in one call before the rollout, and the dynamics then
    receive ``ctx[:, t]`` in place of the window; it excludes carried
    dynamics. ``terminal_state_cost(states [S*K, T, nx], actions [S*K, T,
    nu]) -> [S*K]`` is added per trajectory sample and averaged over M; the
    states are recorded only when it is given.
    """
    if U.dim() == 2:  # one plan: the S=1 case without its seed axis
        action, U, aux = mppi_command_core(
            cfg, params, dynamics_fn, running_cost_fn, U[None], obs[None], action_buffer[None],
            noise[None], terminal_state_cost=terminal_state_cost, dynamics_carry_init=dynamics_carry_init,
            time_buffer=None if time_buffer is None else time_buffer[None], cost_args=cost_args,
            axis=axis, window_encoder=window_encoder,
        )
        return action[0], U[0], {k: v[0] for k, v in aux.items()}
    if window_encoder is not None and dynamics_carry_init is not None:
        raise ValueError("window_encoder is for state-independent window encodings; "
                         "carried dynamics encode history themselves")

    T, nu = cfg.horizon, cfg.nu
    S, K = noise.shape[0], noise.shape[1]  # K is the local K under ``axis``
    A = action_buffer.shape[1]
    M = cfg.rollout_samples

    # 2. bound, recompute noise
    perturbed = U[:, None] + noise
    if cfg.sample_null_action:
        # the globally-last rollout of each seed: the last rank's last row
        if axis is None or dist.get_rank(axis) == dist.get_world_size(axis) - 1:
            perturbed[:, K - 1] = 0.0
    perturbed = torch.clamp(perturbed * cfg.u_scale, cfg.u_min, cfg.u_max) / cfg.u_scale
    noise = perturbed - U[:, None]

    # action perturbation cost
    action_cost = cfg.lambda_ * (noise.abs() if cfg.noise_abs_cost else noise) @ params.noise_sigma_inv

    # 3. sliding action windows with prepended history
    scaled = perturbed * cfg.u_scale  # [S, K, T, nu] env units
    hist = action_buffer[:, None, 1:].expand(S, K, A - 1, nu)
    full = torch.cat([hist, scaled], dim=2)  # [S, K, A-1+T, nu]

    def step_ages(ages):
        """time_buffer += dt; roll; newest age = 0."""
        ages = torch.roll(ages + cfg.dt, -1, dims=1)
        ages[:, -1] = 0.0
        return ages

    if time_buffer is not None:
        ages = time_buffer
    else:
        ages = torch.flip(torch.arange(A, dtype=scaled.dtype, device=scaled.device), dims=(0,)) * cfg.dt
        ages = ages.expand(S, A)

    def tile(x):
        """[S*K, ...] -> [S*M*K, ...]: each seed's K rows repeated M times."""
        if M == 1:
            return x
        x = x.reshape((S, 1, K) + tuple(x.shape[1:]))
        return x.expand((S, M, K) + tuple(x.shape[3:])).reshape((S * M * K,) + tuple(x.shape[3:]))

    ctx = None
    if window_encoder is not None:
        windows_all = _stack_windows(full.reshape(S * K, A - 1 + T, nu), T, A).reshape(S, K, T, A, nu)
        if cfg.encode_obs_time:
            # the ages the rollout would see at step t: advanced t+1 times
            ages_all, ages_t = [], ages
            for _ in range(T):
                ages_t = step_ages(ages_t)
                ages_all.append(ages_t)
            ages_all = torch.stack(ages_all, dim=1)  # [S, T, A]
            a = ages_all[:, None, :, :, None].expand(S, K, T, A, 1).to(windows_all.dtype)
            windows_all = torch.cat([windows_all, a], dim=-1)
        ctx = window_encoder(windows_all.reshape((S * K, T) + tuple(windows_all.shape[3:])))

    # 4. rollout over the horizon, all S*M*K rows in one dynamics call per step
    nx = tuple(obs.shape[1:])
    state = obs[:, None].expand((S, M * K) + nx).reshape((S * M * K,) + nx)
    carry = dynamics_carry_init(state) if dynamics_carry_init is not None else None
    costs, cost_var, states = [], None, []
    for t in range(T):
        window = full[:, :, t : t + A, :].reshape(S * K, A, nu)
        if ctx is not None:
            dyn_in = tile(ctx[:, t])
        elif cfg.encode_obs_time:
            ages = step_ages(ages)
            a = ages[:, None, :, None].expand(S, K, A, 1).reshape(S * K, A, 1).to(window.dtype)
            dyn_in = tile(torch.cat([window, a], dim=2))
        else:
            dyn_in = tile(window)
        step_arg = (t,) if cfg.step_dependent_dynamics else ()
        if carry is None:
            state = dynamics_fn(state, dyn_in, *step_arg)
        else:
            carry, state = dynamics_fn(carry, state, dyn_in, *step_arg)
        c = running_cost_fn(state, tile(window[:, -1, :]), *cost_args)
        if M > 1:
            cM = c.reshape(S, M, K)
            var = torch.var(cM, dim=1, unbiased=False) * cfg.rollout_var_discount**t
            cost_var = var if cost_var is None else cost_var + var
            c = torch.mean(cM, dim=1)
        costs.append(c.reshape(S, K))
        if terminal_state_cost is not None:
            states.append(state)
    cost_total = torch.sum(torch.stack(costs), dim=0)  # [S, K]

    if terminal_state_cost is not None:
        # per trajectory sample m: states [S*K, T, nx] with the scaled actions
        # [S*K, T, nu] (full[:, t + A - 1] is the step-t action); mean over M
        st = torch.stack(states, dim=1).reshape((S, M, K, T) + nx)
        acts = scaled.reshape(S * K, T, nu)
        term = torch.stack([terminal_state_cost(st[:, m].reshape((S * K, T) + nx), acts).reshape(S, K)
                            for m in range(M)])
        cost_total = cost_total + torch.mean(term, dim=0)

    # discounted cost-variance penalty across the M rollouts
    if cost_var is not None:
        cost_total = cost_total + cost_var * cfg.rollout_var_cost

    # 5. perturbation cost
    cost_total = cost_total + torch.sum(U[:, None] * action_cost, dim=(2, 3))

    # 6. softmax weighting + control update, per seed over its K rollouts
    beta = torch.min(cost_total, dim=1, keepdim=True).values
    if axis is not None:
        dist.all_reduce(beta, op=dist.ReduceOp.MIN, group=axis)
    weights = torch.exp(-(cost_total - beta) / cfg.lambda_)
    eta = torch.sum(weights, dim=1, keepdim=True)
    if axis is not None:
        dist.all_reduce(eta, group=axis)
    omega = weights / eta
    dU = torch.sum(omega[:, :, None, None] * noise, dim=1)
    if axis is not None:
        dist.all_reduce(dU, group=axis)
    U = U + dU

    # 7. leading action(s), env units
    action = (U[:, 0] if cfg.u_per_command == 1 else U[:, : cfg.u_per_command]) * cfg.u_scale
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
    terminal_state_cost: Optional[Callable] = None,
    window_encoder: Optional[Callable] = None,
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
        terminal_state_cost=terminal_state_cost, dynamics_carry_init=dynamics_carry_init,
        time_buffer=time_buffer, cost_args=cost_args, window_encoder=window_encoder,
    )


def mppi_rollout_states(
    cfg: MPPIConfig,
    dynamics_fn: Callable,
    obs: torch.Tensor,  # [nx]
    U: torch.Tensor,  # [T, nu]
    action_buffer: torch.Tensor,  # [A, nu]
    num_rollouts: int = 1,
) -> torch.Tensor:
    """The current plan rolled (no noise) through the dynamics:
    [num_rollouts, T, nx], the counterpart of MPPIDelay.get_rollouts
    (reference :358-381) in the delay-aware window format."""
    A, T = action_buffer.shape[0], U.shape[0]
    scaled = (U[None] * cfg.u_scale).expand(num_rollouts, T, cfg.nu)
    hist = action_buffer[None, 1:].expand(num_rollouts, A - 1, cfg.nu)
    windows = _stack_windows(torch.cat([hist, scaled], dim=1), T, A)  # [R, T, A, nu]
    state = obs[None].expand((num_rollouts,) + tuple(obs.shape))
    states = []
    for t in range(T):
        state = dynamics_fn(state, windows[:, t])
        states.append(state)
    return torch.stack(states, dim=1)


def run_mppi(
    env,
    cfg: MPPIConfig,
    params: MPPIParams,
    make_dynamics: Callable,
    running_cost: Callable,
    model_params,
    generator: torch.Generator,
    retrain_dynamics: Optional[Callable] = None,
    retrain_after_iter: int = 50,
    iters: int = 200,
    action_buffer_size: int = 4,
    delay: int = 0,
):
    """Online MPPI control with periodic dynamics retraining: the JAX
    module's working form of the reference's ``run_mppi`` (:384-410, dead
    code there). The real environment runs under MPPI; the visited (obs,
    action) pairs fill a ring the size of ``retrain_after_iter`` (pre-step
    obs and commanded action, cleared every cycle), and every
    ``retrain_after_iter`` steps (not at step 0) the ring goes to
    ``retrain_dynamics(dataset, model_params) -> model_params``, after which
    the planner dynamics are rebuilt by ``make_dynamics(model_params)``.
    Every draw comes from ``generator`` (reset, U0, then each step's
    noise), on the planner's device. The environment steps as the
    evaluation loop does (one Euler step per dt, the delay buffer of
    mppi_with_model.py:25-28). Returns ``(total_reward, dataset)``, dataset
    a float64 numpy array [retrain_after_iter, n_obs + nu]."""
    import numpy as np

    from ..envs.base import env_step

    spec = env.spec
    nx, nu = spec.n_obs, spec.m
    chol = params.noise_chol
    dynamics = make_dynamics(model_params)
    raw = env.reset(generator, chol.dtype, chol.device)
    U = mppi_reset(generator, cfg, params)
    buffer = torch.zeros((action_buffer_size, nu), dtype=chol.dtype, device=chol.device)
    dataset = np.zeros((retrain_after_iter, nx + nu), dtype=np.float64)
    total_reward = 0.0
    for i in range(iters):
        obs = env.observe(raw)
        action, U, _ = mppi_command(cfg, params, dynamics, running_cost, U, obs, buffer, generator=generator)
        # delay buffer: the env executes the action commanded ``delay`` ticks ago
        buffer = torch.roll(buffer, -1, dims=0)
        buffer[-1] = action
        applied = buffer[-(delay + 1)]
        raw = env_step(env, raw, applied, spec.dt)
        total_reward += float(env.diff_reward(env.observe(raw), applied))
        di = i % retrain_after_iter
        if di == 0 and i > 0 and retrain_dynamics is not None:
            model_params = retrain_dynamics(dataset, model_params)
            dynamics = make_dynamics(model_params)
            dataset[:] = 0.0
        dataset[di, :nx] = obs.cpu().numpy()
        dataset[di, nx:] = action.cpu().numpy()
    return total_reward, dataset

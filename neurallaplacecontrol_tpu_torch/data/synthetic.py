"""Synthetic training data from batched env integration (port of ``data/synthetic.py``).

Rebuild of reference overlay.generate_irregular_data_delay_time_multi
(overlay.py:664-737) + compute_state_actions (:603-661): sample raw states
in the per-env box and actions in the action box, integrate every
(state, action) pair one Euler step over a per-round sampled interval, and
emit trig-form (s0, action-buffer, sn, dt) tuples with the executed action
at buffer index -(delay+1) inside an otherwise random buffer (:718-721).

The reference's quirks stay as the JAX module keeps them: the flattening is
action-major (each round's states repeat per action), one interval is drawn
per round, the observation noise has a draw of its own, and under
``encode_obs_time`` the buffer's ages are integer step counts.

Every random draw goes through one object (``SyntheticDraws``: one
``torch.Generator``); a test may hand in any object with its methods, for
example one that replays the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..envs import Env, sample_dt
from ..utils.device import resolve_device

_TIME_MULTIPLIER = 10  # overlay.py:682
_DEFAULT_SPD = {"pendulum": 33, "cartpole": 20, "acrobot": 15}  # overlay.py:675-681


def default_samples_per_dim(env_name: str) -> int:
    for k, v in _DEFAULT_SPD.items():
        if k in env_name:
            return v
    raise ValueError(env_name)


class SyntheticDraws:
    """The randomness of one synthetic dataset: one ``torch.Generator`` on
    ``device``, seeded with ``seed``. Uniform draws are on [0, 1)."""

    def __init__(self, seed: int, dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def _uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=self.dtype, device=self.device)

    def states_actions(self, rounds: int, n_states: int, state_dim: int, n_actions: int,
                       action_dim: int, shared: bool):
        """Uniform draws for the sampled states [R, n_states, state_dim] and
        actions [R, n_actions, action_dim]; R is 1 when the rounds share one
        draw, else ``rounds``."""
        R = 1 if shared else rounds
        return self._uniform((R, n_states, state_dim)), self._uniform((R, n_actions, action_dim))

    def dt(self, ts_grid: str, dt: float, rounds: int) -> torch.Tensor:  # [rounds]
        return sample_dt(self.generator, ts_grid, dt, (rounds,), self.dtype, self.device)

    def grid_dts(self, ts_grid: str, dt: float, rounds: int) -> torch.Tensor:  # [rounds, 3]
        """The interval draws of each round's 3-point time grid."""
        return sample_dt(self.generator, ts_grid, dt, (rounds, 3), self.dtype, self.device)

    def buffer(self, n: int, size: int, action_dim: int) -> torch.Tensor:
        """Uniform draws for the random action buffers [n, size, action_dim]."""
        return self._uniform((n, size, action_dim))

    def obs_noise(self, n: int, n_obs: int) -> torch.Tensor:  # standard normal
        z = torch.empty((n, n_obs), dtype=self.dtype, device=self.device)
        return z.normal_(generator=self.generator)


def _grid_states_actions(env: Env, samples_per_dim: int, state_max, dtype, device):
    """The deterministic grid of ``rand=False``: every state on a meshgrid of
    the box and ``samples_per_dim`` actions per action dimension."""
    spec = env.spec
    grids = [torch.linspace(-float(state_max[i]), float(state_max[i]), samples_per_dim,
                            dtype=dtype, device=device) for i in range(spec.n_state)]
    s0s = torch.stack([g.reshape(-1) for g in torch.meshgrid(*grids, indexing="ij")], dim=-1)
    a = torch.linspace(-spec.action_high, spec.action_high, samples_per_dim, dtype=dtype, device=device)
    if spec.m == 1:
        return s0s, a[:, None]
    am = torch.meshgrid(*([a] * spec.m), indexing="ij")
    return s0s, torch.stack([g.reshape(-1) for g in am], dim=-1)


def _generate(env: Env, draws, samples_per_dim: int, rounds: int, rand: bool, delay: int,
              action_buffer_size: int, encode_obs_time: bool, reuse_state_actions: bool):
    spec = env.spec
    n_state, m = spec.n_state, spec.m
    dtype, device = draws.dtype, draws.device
    state_max = torch.tensor(env.state_max, dtype=dtype, device=device)
    S = samples_per_dim**n_state
    a_high = spec.action_high

    if rand:
        u_s, u_a = draws.states_actions(rounds, S, n_state, samples_per_dim, m, reuse_state_actions)
        s0s = (u_s - 0.5) * 2.0 * state_max
        actions = (u_a - 0.5) * 2.0 * a_high
        if reuse_state_actions:
            # one (state, action) draw shared by all rounds (overlay.py:695-702)
            s0s = s0s.expand((rounds,) + s0s.shape[1:])
            actions = actions.expand((rounds,) + actions.shape[1:])
    else:
        s0, a = _grid_states_actions(env, samples_per_dim, env.state_max, dtype, device)
        s0s = s0.expand((rounds,) + s0.shape)
        actions = a.expand((rounds,) + a.shape)

    # one sampled interval per round, shared across the round's pairs
    # (base_env.batch_integrate_system:246 uses a single build_time_grid call)
    dts = draws.dt(spec.ts_grid, spec.dt, rounds)

    # cross product [rounds, S, n_act]: one Euler step per pair
    n_act = actions.shape[1]
    s_b = s0s[:, :, None, :].expand(rounds, S, n_act, n_state)
    a_b = actions[:, None, :, :].expand(rounds, S, n_act, m)
    sn_b = s_b + dts[:, None, None, None] * env.rhs(s_b, a_b)
    # action-major flattening (s0s repeated per action, base_env.py:270-276)
    s0_flat = s_b.transpose(1, 2).reshape(-1, n_state)
    a0 = a_b.transpose(1, 2).reshape(-1, m)
    sn_flat = sn_b.transpose(1, 2).reshape(-1, n_state)
    s0 = env.observe(s0_flat)
    sn = env.observe(sn_flat)
    ts = torch.repeat_interleave(dts, S * n_act)[:, None]

    if spec.obs_noise != 0.0:
        sn = sn + draws.obs_noise(sn.shape[0], sn.shape[1]) * spec.obs_noise

    # embed the executed action at -(delay+1) in a random buffer (overlay.py:718-721)
    N = a0.shape[0]
    buf = (draws.buffer(N, action_buffer_size, m) - 0.5) * 2.0 * a_high
    buf[:, -(delay + 1)] = a0
    if encode_obs_time:
        # reference quirk: synthetic ages are integer step counts
        # flip(arange(A)) (overlay.py:722-731), not seconds as in collection
        ages = torch.flip(torch.arange(action_buffer_size, dtype=dtype, device=device), dims=(0,))
        buf = torch.cat([buf, ages[None, :, None].expand(N, action_buffer_size, 1)], dim=2)
    return s0, buf, sn, ts


def generate_irregular_data_delay_latent(
    env: Env,
    draws,
    delay: int,
    samples_per_dim: Optional[int] = None,
    rand: bool = False,
    latent: bool = False,
):
    """Two-frame synthetic data for latent (finite-difference) models
    (reference overlay.generate_irregular_data_delay_latent:222-397 +
    base_env.batch_integrate_system_double_time:175-229).

    Each of ``samples_per_dim`` rounds integrates TWO consecutive observation
    intervals of a sampled 3-point time grid (``draws.grid_dts``): sb = the
    frame after the first interval, sn = the frame after the second.
    Returns (s0, a0, sb, sn, ts) in trig form, with ``delay`` extra random
    actions (``draws.buffer``) appended to the action (overlay :378-384). As
    in the JAX package (``data/synthetic.py:146-147``), ``ts`` is the second
    ABSOLUTE grid point, not the first interval (overlay uses ts[1]; the two
    agree on the 'fixed' grid). With latent=True (cartpole only) sn is the
    two-frame latent oracle's step from (s0, sb) and every frame reduces to
    its position dims [x, l cos, l sin] (overlay :385-391).
    """
    spec = env.spec
    spd = samples_per_dim or default_samples_per_dim(spec.name)
    n_state, m = spec.n_state, spec.m
    dtype, device = draws.dtype, draws.device
    a_high = spec.action_high
    if latent and "cartpole" not in spec.name:
        raise ValueError("the latent reduction is cartpole-only")

    if rand:
        u_s, u_a = draws.states_actions(spd, spd**n_state, n_state, spd, m, False)
        s0s = (u_s - 0.5) * 2.0 * torch.tensor(env.state_max, dtype=dtype, device=device)
        actions = (u_a - 0.5) * 2.0 * a_high
    else:
        s0, a = _grid_states_actions(env, spd, env.state_max, dtype, device)
        s0s, actions = s0.expand((spd,) + s0.shape), a.expand((spd,) + a.shape)
    # each round's 3-point grid (build_time_grid only_one_step=False, T=3)
    pts = draws.grid_dts(spec.ts_grid, spec.dt, spd)
    if spec.ts_grid != "fixed":
        grid = torch.cumsum(pts, dim=1)
    else:
        grid = spec.dt * torch.arange(3, dtype=dtype, device=device).expand(spd, 3)
    d1 = (grid[:, 1] - grid[:, 0])[:, None, None, None]
    d2 = (grid[:, 2] - grid[:, 1])[:, None, None, None]

    S, A = s0s.shape[1], actions.shape[1]
    s_b = s0s[:, :, None, :].expand(spd, S, A, n_state)
    a_b = actions[:, None, :, :].expand(spd, S, A, m)
    sb = s_b + d1 * env.rhs(s_b, a_b)
    sn = sb + d2 * env.rhs(sb, a_b)

    def flat(x):  # action-major within each round (batch_integrate_system layout)
        return x.transpose(1, 2).reshape(-1, x.shape[-1])

    s0, sb, sn = env.observe(flat(s_b)), env.observe(flat(sb)), env.observe(flat(sn))
    a0 = flat(a_b)
    ts = torch.repeat_interleave(grid[:, 1], S * A)[:, None]

    if delay > 0:
        extra = (draws.buffer(a0.shape[0], delay, m) - 0.5) * 2.0 * a_high
        a0 = torch.cat([a0[:, None, :], extra], dim=1)

    if latent:
        from ..envs.oracle import cartpole_dynamics_dt_latent

        sn = cartpole_dynamics_dt_latent(sb, s0, a0[:, 0] if a0.dim() == 3 else a0, ts)
        s0, sb, sn = s0[:, [0, 2, 3]], sb[:, [0, 2, 3]], sn[:, [0, 2, 3]]
    return s0, a0, sb, sn, ts


def generate_irregular_data_delay_time_multi(
    env: Env,
    draws,
    delay: int,
    samples_per_dim: Optional[int] = None,
    rand: bool = True,
    action_buffer_size: int = 4,
    encode_obs_time: bool = False,
    reuse_state_actions_when_sampling_times: bool = False,
):
    """Returns (s0 [N,n_obs], a0 [N,A,m], sn [N,n_obs], ts [N,1]) in the
    dtype and on the device of ``draws`` (a ``SyntheticDraws``)."""
    spd = samples_per_dim or default_samples_per_dim(env.spec.name)
    rounds = int(spd * _TIME_MULTIPLIER)
    return _generate(env, draws, spd, rounds, rand, delay, action_buffer_size,
                     encode_obs_time, reuse_state_actions_when_sampling_times)


def generate_irregular_data_delay(env: Env, draws, delay: int,
                                  samples_per_dim: Optional[int] = None, rand: bool = False):
    """Legacy single-step variant (overlay.generate_irregular_data_delay
    :400-557): a (delay+1)-long buffer with the executed action at
    -(delay+1), i.e. the multi generator with action_buffer_size = delay + 1."""
    return generate_irregular_data_delay_time_multi(
        env, draws, delay, samples_per_dim=samples_per_dim, rand=rand,
        action_buffer_size=delay + 1,
    )


def generate_irregular_data(env: Env, draws, samples_per_dim: Optional[int] = None,
                            rand: bool = False):
    """Legacy non-delayed variant (overlay.generate_irregular_data:781-927):
    single executed action, flat [N, m] action layout."""
    s0, a0, sn, ts = generate_irregular_data_delay(env, draws, 0, samples_per_dim=samples_per_dim,
                                                   rand=rand)
    return s0, a0[:, 0], sn, ts

"""Forward simulation of learned vector fields with the policy in the loop
(port of ``oderl/dynamics.py``).

Rebuild of reference envs/oderl/ctrl/dynamics.py: the NODE family (enode /
benode / ibnode) integrates ds/dt = f([s, a]) with a = g(s, t) and the
reward integrand dV/dt = r(s, a) e^{-t/tau} for L function draws at once;
PETS propagates P particles per initial state with a fresh particle-to-
member assignment per step (dynamics.py:182-214); DeepPILCO moment-matches
the state distribution across draws after every step (dynamics.py:217-253).

The draw dimension L and particle dimension P are leading batch axes
([L, N, n] / [L, P*N, n]); the horizon is a Python loop; each env-dt
interval takes ``substeps`` fixed RK4 or Euler sub-steps (the reference
uses dopri5 with step_size dt/10, ctrl.py:226-232).

Every random draw comes from one ``OderlDraws`` (a ``torch.Generator``
behind four methods); a caller, a test replaying the JAX package's draws
among them, may hand in any object with those methods.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


class OderlDraws:
    """The randomness of the ODE-RL stack, drawn from ``generator`` on its
    device. Each method is one kind of draw the simulators and trainers
    make; the JAX package takes them from ``fold_in``/``split`` keys."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def f_noise(self, net, params, L: int, rows: int = 1):
        """The dynamics net's function draws (``net.draw_noise``)."""
        return net.draw_noise(params, self.generator, L, rows)

    def pets(self, T: int, L: int, PN: int, n: int, dtype):
        """PETS' per-step output noise [T, L, PN, n] and particle-to-member
        permutations [T, L]."""
        g = self.generator
        eps = torch.randn((T, L, PN, n), generator=g, dtype=dtype, device=g.device)
        perms = torch.stack([torch.randperm(L, generator=g, device=g.device) for _ in range(T)])
        return eps, perms

    def moments(self, T: int, L: int, N: int, n: int, dtype):
        """DeepPILCO's per-step moment-matching normals [T, L, N, n]."""
        g = self.generator
        return torch.randn((T, L, N, n), generator=g, dtype=dtype, device=g.device)

    def randint(self, high: int, n: int):
        """``n`` indices in [0, high)."""
        g = self.generator
        return torch.randint(0, high, (n,), generator=g, device=g.device)


def as_draws(draws):
    """A ``torch.Generator`` wrapped as ``OderlDraws``; anything else as it is."""
    return OderlDraws(draws) if isinstance(draws, torch.Generator) else draws


def _reward(env, s, a):
    # the stack learns dynamics in OBSERVATION space (reference ctrl.py
    # qin = env.n + env.m, env.n the trig obs dim), so s is an observation;
    # the reward functions shape-dispatch on it
    return env.reward_state(s) + env.reward_action(a)


def _time_grid(env, H, ts, like: torch.Tensor) -> torch.Tensor:
    if ts is None:
        T = int(H / env.spec.dt)
        return env.spec.dt * torch.arange(T + 1, dtype=like.dtype, device=like.device)
    return torch.as_tensor(ts, dtype=like.dtype, device=like.device)


def _sv_rhs(net, params, noise, env, g, tau, compute_rew):
    """d[s, V]/dt for stacked draws: s [L,N,n], V [L,N]; t a scalar or [N]."""

    def rhs(t, s, V):
        a = g(s, t)  # [L,N,m]
        ds = net.apply(params, torch.cat([s, a], dim=-1), noise)
        if not compute_rew:
            return ds, torch.zeros_like(V)
        dV = _reward(env, s, a)
        if tau is not None:
            dV = dV * torch.exp(-t / tau)
        return ds, dV

    return rhs


def _integrate_interval(rhs, t0, dt, s, V, substeps, method):
    """Advance [s, V] over one observation interval with fixed sub-steps;
    t0 and dt are scalars, or [N] for per-row grids."""
    h = dt / substeps
    hs = h[..., None] if h.dim() else h  # against s [L,N,n]
    for i in range(substeps):
        t = t0 + i * h
        if method == "rk4":
            k1s, k1v = rhs(t, s, V)
            k2s, k2v = rhs(t + h / 2, s + hs / 2 * k1s, V + h / 2 * k1v)
            k3s, k3v = rhs(t + h / 2, s + hs / 2 * k2s, V + h / 2 * k2v)
            k4s, k4v = rhs(t + h, s + hs * k3s, V + h * k3v)
            s = s + hs / 6 * (k1s + 2 * k2s + 2 * k3s + k4s)
            V = V + h / 6 * (k1v + 2 * k2v + 2 * k3v + k4v)
        else:
            ds, dV = rhs(t, s, V)
            s, V = s + hs * ds, V + h * dV
    return s, V


def simulate_enode(
    net,
    params,
    env,
    g: Callable,
    s0: torch.Tensor,  # [N, n]
    draws,
    H: Optional[float] = None,
    ts: Optional[torch.Tensor] = None,  # [T+1] shared grid, or [N, T+1] one per row (overrides H)
    L: int = 1,
    tau: Optional[float] = None,
    compute_rew: bool = True,
    substeps: int = 10,
    method: str = "rk4",
):
    """Ensemble/BNN neural-ODE rollout (dynamics.py NODE:129-180).

    Returns (st [L,N,T,n], rt [L,N,T], ts [T] or [N,T]); st[:, :, 0] is s0.
    L is forced to net.n_ens for ensemble families (ctrl.py get_L:123-127).
    With per-row grids ``ts`` [N, T+1], every row is a simulation of its own
    (the JAX package's vmap over rows): its own time grid, and its own
    function draw (``draws.f_noise(..., rows=N)``); g(s, t) then gets t [N].
    """
    L = net.n_ens if net.n_ens > 1 else L
    ts = _time_grid(env, H, ts, s0)
    per_row = ts.dim() == 2
    noise = as_draws(draws).f_noise(net, params, L, s0.shape[0] if per_row else 1)
    rhs = _sv_rhs(net, params, noise, env, g, tau, compute_rew)

    s = s0[None].expand((L,) + s0.shape)
    V = s0.new_zeros((L, s0.shape[0]))
    sts, Vts = [s], [V]
    n_int = ts.shape[-1] - 1
    for i in range(n_int):
        s, V = _integrate_interval(rhs, ts[..., i], ts[..., i + 1] - ts[..., i], s, V, substeps, method)
        if i < n_int - 1:
            sts.append(s)
            Vts.append(V)
    return torch.stack(sts, dim=2), torch.stack(Vts, dim=2), ts[..., :-1]


def simulate_pets(
    net,  # an EPNN ApproxNet
    params,
    env,
    g: Callable,
    s0: torch.Tensor,  # [N, n]
    draws,
    H: Optional[float] = None,
    ts: Optional[torch.Tensor] = None,
    P: int = 20,
    tau: Optional[float] = None,
    compute_rew: bool = True,
):
    """PETS trajectory sampling (dynamics.py PETS:182-214): P particles per
    initial state, explicit Euler on the observation grid, and a fresh
    random particle->member assignment every step (the reference shuffles
    the ensemble's weights, ``_f.shuffle()`` at :205; permuting the particle
    axis before each draw is the same thing). ``draws.pets`` gives every
    step's output noise and permutation.

    Returns (st [L*P, N, T, n], rt [L*P, N, T], ts [T]).
    """
    L = net.n_ens
    N, n = s0.shape
    ts = _time_grid(env, H, ts, s0)
    T = ts.shape[0] - 1
    eps, perms = as_draws(draws).pets(T, L, P * N, n, s0.dtype)

    s = s0[None, None].expand(L, P, N, n).reshape(L, P * N, n)
    V = s0.new_zeros((L, P * N))
    sts, Vts = [], []
    for i in range(T):
        t, dt = ts[i], ts[i + 1] - ts[i]
        a = g(s, t)
        r = _reward(env, s, a)
        if tau is not None:
            r = r * torch.exp(-t / tau)
        V_next = V + dt * r if compute_rew else V
        s_next = s + dt * net.apply(params, torch.cat([s, a], dim=-1), eps[i])
        sts.append(s)
        Vts.append(V)
        s, V = s_next[perms[i]], V_next[perms[i]]
    st = torch.stack(sts).reshape(T, L, P, N, n).movedim(0, 3).reshape(L * P, N, T, n)
    Vt = torch.stack(Vts).reshape(T, L, P, N).movedim(0, 3).reshape(L * P, N, T)
    return st, Vt, ts[:-1]


def simulate_deep_pilco(
    net,  # a dropout ApproxNet
    params,
    env,
    g: Callable,
    s0: torch.Tensor,
    draws,
    H: Optional[float] = None,
    ts: Optional[torch.Tensor] = None,
    L: int = 10,
    tau: Optional[float] = None,
    compute_rew: bool = True,
):
    """DeepPILCO rollout (dynamics.py DeepPILCO:217-253): Euler steps under
    L dropout draws with Gaussian moment matching of the state distribution
    after every step: the mean and the population (ddof 0, ``jnp.std``'s)
    standard deviation over the draws, and ``draws.moments``' normals.
    Returns (st [L,N,T,n], rt [L,N,T], ts [T])."""
    N, n = s0.shape
    ts = _time_grid(env, H, ts, s0)
    T = ts.shape[0] - 1
    d = as_draws(draws)
    noise = d.f_noise(net, params, L)
    mm = d.moments(T, L, N, n, s0.dtype)

    s = s0[None].expand(L, N, n)
    V = s0.new_zeros((L, N))
    sts, Vts = [], []
    for i in range(T):
        t, dt = ts[i], ts[i + 1] - ts[i]
        a = g(s, t)
        r = _reward(env, s, a)
        if tau is not None:
            r = r * torch.exp(-t / tau)
        V_next = V + dt * r if compute_rew else V
        s_next = s + dt * net.apply(params, torch.cat([s, a], dim=-1), noise)
        # moment matching across draws (dynamics.py:246-248)
        mu = torch.mean(s_next, dim=0)
        sig = torch.std(s_next, dim=0, correction=0)
        sts.append(s)
        Vts.append(V)
        s, V = mu[None] + mm[i] * sig[None], V_next
    return torch.stack(sts, dim=2), torch.stack(Vts, dim=2), ts[:-1]

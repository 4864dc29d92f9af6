"""Trajectory datasets + RBF kernel action interpolants for ODE-RL (port of
``oderl/dataset.py``).

Rebuild of reference envs/oderl/ctrl/dataset.py and the GP/exploration
helpers in ctrl/utils.py:510-617 + utils/utils.py:34-77,148-170
(KernelInterpolation). A dataset is an immutable tuple of stacked tensors;
GP-smooth exploration actions and kernel interpolants are batched linear
algebra.

The factorizations run in the dtype of the time grid they are given (f32
grids factor in f32, f64 grids in f64), and nothing falls back to another
dtype. ``draw_from_gp`` keeps ``jnp.linalg.cholesky``'s semantics: a matrix
the factorization rejects gives NaN, where ``torch.linalg.cholesky`` would
raise. At f32 the matrices of this stack (dt = 0.05, ell = 0.5, 1e-5
jitter) have condition numbers of 4e5 to 6e5 for T = 20 to 400 and factor
in both packages on a CPU. ``kernel_interpolate`` solves by LU, as
``jnp.linalg.solve`` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.device import resolve_device


class Dataset(NamedTuple):
    """Trajectory experience (reference ctrl/dataset.py:10-60):
    s [N,T,n] states, a [N,T,m] actions, r [N,T,1] rewards, ts [N,T]."""

    s: torch.Tensor
    a: torch.Tensor
    r: torch.Tensor
    ts: torch.Tensor

    @property
    def N(self):
        return self.s.shape[0]

    @property
    def T(self):
        return self.s.shape[1]

    def add_experience(self, other: "Dataset") -> "Dataset":
        return Dataset(*(torch.cat([x, y]) for x, y in zip(self, other)))


def rbf_kernel(x1, x2, ell=1.0, sf=1.0, eps=1e-5, jitter=False):
    """sf^2 exp(-0.5 |x1-x2|^2/ell^2), plus eps I on self-kernels
    (utils/utils.py:72-77). ``jitter`` is set by the caller for the K(X, X)
    case: keying it off matching point counts, as the reference does,
    corrupts cross-covariances whenever Q equals T."""
    d = (x1[..., :, None, :] - x2[..., None, :, :]) / ell
    Km = sf**2 * torch.exp(-0.5 * torch.sum(d * d, dim=-1))
    if jitter:
        Km = Km + torch.eye(x1.shape[-2], dtype=Km.dtype, device=Km.device) * eps
    return Km


def interpolation_weights(ts, ys, ell=0.5, sf=1.0, eps=1e-5):
    """K(X, X)^-1 ys for knots ts [..., T] and values ys [..., T, m]: the
    solve of ``kernel_interpolate``, made once per trajectory."""
    X = ts[..., None]
    return torch.linalg.solve(rbf_kernel(X, X, ell, sf, eps, jitter=True), ys)


def kernel_interpolate(ts, ys, query_t, ell=0.5, sf=1.0, eps=1e-5):
    """Kernel-ridge interpolation of a trajectory signal
    (utils/utils.py KernelInterpolation:148-170): given knots (ts [T], ys
    [T,m]) return values at query_t [Q] -> [Q,m]."""
    alpha = interpolation_weights(ts, ys, ell, sf, eps)
    return rbf_kernel(query_t[:, None], ts[:, None], ell, sf) @ alpha


def make_kernel_interpolate_policy(ts, at, ell=0.5, sf=1.0) -> Callable:
    """g(s, t) interpolating recorded actions (dataset.KernelInterpolatePolicy
    :145-161): K^-1 y once per trajectory (ts [N,T], at [N,T,m]); g returns
    the N trajectories' actions [N, m] at a scalar time t."""
    N = at.shape[0]
    X = ts[..., None]  # [N,T,1]
    alpha = interpolation_weights(ts, at, ell, sf)

    def g(s, t):
        q = torch.as_tensor(t, dtype=ts.dtype, device=ts.device).reshape(1, 1) * ts.new_ones((N, 1, 1))
        return (rbf_kernel(q, X, ell, sf) @ alpha)[:, 0]

    return g


def draw_from_gp(ts, n_out=1, ell=0.5, sf=1.0, eps=1e-5, generator=None, normals=None):
    """One GP-prior draw over the time grid ts [T] (ctrl/utils.py:520-528):
    cholesky(K + eps I) @ normals -> [T, n_out], in ts's dtype. The standard
    normals [T, n_out] come from ``generator``, or are given ([..., T,
    n_out] gives one draw per leading index). A matrix the
    Cholesky factorization rejects gives NaN, as in the JAX package."""
    cov = rbf_kernel(ts[:, None], ts[:, None], ell, sf, eps, jitter=True)
    L, info = torch.linalg.cholesky_ex(cov)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    if normals is None:
        normals = torch.randn((ts.shape[0], n_out), generator=generator, dtype=ts.dtype, device=ts.device)
    return L @ normals


def make_exploration_policy(env, T, g_pol: Optional[Callable] = None, sf=0.1, ell=0.5, generator=None,
                            normals=None, dtype=torch.float32, device="cuda") -> Callable:
    """Smooth random exploration policy (ctrl/utils.py build_policy:557-566):
    tanh(policy + GP-smooth noise interpolant) * action_high; the GP draw's
    normals [T, m] come from ``generator`` or are given."""
    spec = env.spec
    dev = resolve_device(device)
    ts = spec.dt * torch.arange(T, dtype=dtype, device=dev)
    noise = draw_from_gp(ts, spec.m, ell, sf, generator=generator, normals=normals)
    alpha = interpolation_weights(ts, noise, ell, sf)

    def g(s, t):
        q = torch.as_tensor(t, dtype=dtype, device=dev).reshape(1, 1)
        a_exp = (rbf_kernel(q, ts[:, None], ell, sf) @ alpha)[0]
        a_pol = g_pol(s, t) if g_pol is not None else 0.0
        return torch.tanh(a_pol + a_exp) * spec.action_high

    return g


def collect_data(env, H: float, N: int = 1, generator=None, sf=0.5, ell=0.5, D: Optional[Dataset] = None,
                 g_pol: Optional[Callable] = None, s0=None, normals=None, dtype=torch.float32,
                 device="cuda") -> Dataset:
    """Roll N trajectories of H seconds under smooth exploration actions
    (ctrl/utils.py collect_data:569-586), all N in one batch on the device:
    explicit Euler steps of the env's raw dynamics over the uniform dt grid.

    The draws come from ``generator``, or are given: ``s0`` [N, n_state] the
    raw initial states (``env.reset``'s distribution) and ``normals`` [N, T,
    m] the GP draws' standard normals. The exploration actions are fixed per
    step; states feed back only through ``g_pol``.
    """
    spec = env.spec
    dev = resolve_device(device)
    T = int(H / spec.dt)
    ts = spec.dt * torch.arange(T, dtype=dtype, device=dev)
    if s0 is None:
        s0 = torch.stack([env.reset(generator, dtype, dev) for _ in range(N)])
    if normals is None:
        normals = torch.randn((N, T, spec.m), generator=generator, dtype=dtype, device=dev)
    s = torch.as_tensor(s0, dtype=dtype, device=dev)
    noise = draw_from_gp(ts, spec.m, ell, sf, normals=torch.as_tensor(normals, dtype=dtype, device=dev))  # [N,T,m]
    st, at, rt = [], [], []
    for i in range(T):
        obs = env.observe(s)
        a_pol = g_pol(obs, ts[i]) if g_pol is not None else 0.0
        a = torch.tanh(a_pol + noise[:, i]) * spec.action_high
        st.append(obs)
        at.append(a)
        rt.append(env.reward_state(obs) + env.reward_action(a))
        s = s + spec.dt * env.rhs(s, a)
    new = Dataset(s=torch.stack(st, 1), a=torch.stack(at, 1), r=torch.stack(rt, 1)[..., None],
                  ts=ts.expand(N, T).clone())
    return new if D is None else D.add_experience(new)

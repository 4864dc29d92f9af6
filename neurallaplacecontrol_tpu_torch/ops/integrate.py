"""Fixed- and adaptive-step ODE integrators (port of ``ops/integrate.py``).

The reference integrates env physics with torchdiffeq's ``euler`` over a
2-point grid (one Euler step per transition); the latent-ODE baseline needs
an adaptive Dormand-Prince 5(4) solver (reference latent_ode_lib/
diffeq_solver.py:43-50 uses dopri5).

The JAX module solves one trajectory per call and the latent ODE maps it
over rows with ``jax.vmap``. Here the adaptive solver takes the rows as a
leading batch axis: every row is its own trajectory, with its own time
grid, step size, accept decision and error norm (the mean runs over that
row's elements only), which is what the vmap computes. The step loop is
the JAX module's masked fixed-count scan: ``max_steps`` iterations per
interval whatever the rows need, a row that has reached its interval's end
stepping by zero, and nothing that waits for the device.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import torch


def euler_step(rhs: Callable, y: torch.Tensor, dt, *args) -> torch.Tensor:
    """One explicit Euler step: ``y + dt * rhs(y, *args)``."""
    return y + dt * rhs(y, *args)


def rk4_step(rhs: Callable, y: torch.Tensor, dt, *args) -> torch.Tensor:
    """One classical RK4 step with autonomous rhs."""
    k1 = rhs(y, *args)
    k2 = rhs(y + 0.5 * dt * k1, *args)
    k3 = rhs(y + 0.5 * dt * k2, *args)
    k4 = rhs(y + dt * k3, *args)
    return y + dt / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def odeint_fixed(rhs: Callable, y0: torch.Tensor, t0, t1, *args, method: str = "euler",
                 num_steps: int = 1) -> torch.Tensor:
    """Integrate from t0 to t1 in ``num_steps`` equal substeps of an
    autonomous rhs that may take extra constant ``args`` (the controls)."""
    dt = (t1 - t0) / num_steps
    step = euler_step if method == "euler" else rk4_step
    y = y0
    for _ in range(num_steps):
        y = step(rhs, y, dt, *args)
    return y


# Butcher tableau (Dormand & Prince 1980)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row [B] tensor shaped to broadcast against ``like`` [B, ...]."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


def _dp_step(rhs, y, t, h, tableau, *args):
    """One Dormand-Prince 5(4) step of every row: (y5, error estimate). ``t``
    and ``h`` are per row [B]. Each stage's combination is one contraction
    over the stacked earlier stages."""
    a, b, c = tableau  # [7, 7] lower-triangular; [2, 7]: b5 and b5 - b4; [7, 1]
    h_y = _row(h, y)
    t_stages = torch.addcmul(t, c, h)  # [7, B]
    ks = [rhs(y, t_stages[0], *args)]
    for i in range(1, 7):
        comb = torch.tensordot(a[i, :i], torch.stack(ks), dims=1)
        ks.append(rhs(torch.addcmul(y, h_y, comb), t_stages[i], *args))
    y5_d, err_d = torch.tensordot(b, torch.stack(ks), dims=1)
    return torch.addcmul(y, h_y, y5_d), h_y * err_d


@lru_cache(maxsize=None)
def _tableau(dtype, device):
    """(a [7, 7], [b5; b5 - b4] [2, 7], c [7, 1]) on ``device``, made once per
    dtype and device."""
    a = torch.zeros((7, 7), dtype=torch.float64)
    for i, row in enumerate(_DP_A):
        a[i, : len(row)] = torch.tensor(row, dtype=torch.float64)
    b5 = torch.tensor(_DP_B5, dtype=torch.float64)
    b = torch.stack([b5, b5 - torch.tensor(_DP_B4, dtype=torch.float64)])
    c = torch.tensor(_DP_C, dtype=torch.float64)[:, None]
    return tuple(x.to(dtype=dtype, device=device) for x in (a, b, c))


def odeint_dopri5(rhs: Callable, y0: torch.Tensor, ts: torch.Tensor, *args, rtol: float = 1e-3,
                  atol: float = 1e-4, max_steps: int = 64) -> torch.Tensor:
    """Adaptive dopri5 of every row of ``y0`` [B, ...] over an increasing
    time grid ``ts``: [T] shared by the rows, or [B, T] one per row.

    Returns the solution at every grid point, [T, B, ...]. ``rhs(y, t,
    *args)`` takes y [B, ...] and the rows' times t [B]. The step count per
    interval is fixed at ``max_steps``. Tolerances default to the reference
    encoder solver's (latent_ode_lib/create_latent_ode_model.py:98-106).
    """
    ys, _ = _odeint_dopri5_impl(rhs, y0, ts, args, rtol, atol, max_steps)
    return ys


def odeint_dopri5_with_stats(rhs, y0, ts, *args, rtol=1e-3, atol=1e-4, max_steps=64):
    """``odeint_dopri5`` and each row's accepted steps per interval, int32
    [T-1, B]. nfe per interval = 7 x accepted (the reference's ODEFunc
    counter, latent_ode_lib/ode_func.py:14-51); the cost is always 7 x
    ``max_steps`` rhs evaluations."""
    return _odeint_dopri5_impl(rhs, y0, ts, args, rtol, atol, max_steps)


def _odeint_dopri5_impl(rhs, y0, ts, args, rtol, atol, max_steps):
    B = y0.shape[0]
    ts = ts.to(y0.dtype)
    if ts.dim() == 1:
        ts = ts[None].expand(B, ts.shape[0])
    tableau = _tableau(y0.dtype, y0.device)
    reduce_dims = tuple(range(1, y0.dim()))
    ys, n_accs = [y0], []
    y = y0
    for i in range(ts.shape[1] - 1):
        t0, t1 = ts[:, i], ts[:, i + 1]
        span = t1 - t0
        t, h = t0, span / 8.0
        t_end, h_min = t1 - 1e-12, span * 1e-4
        n_acc = torch.zeros(B, dtype=torch.int32, device=y0.device)
        for _ in range(max_steps):
            done = t >= t_end
            h_eff = torch.minimum(h, t1 - t)
            y_new, err = _dp_step(rhs, y, t, h_eff, tableau, *args)
            # The step-size control is not differentiated (the JAX module
            # stops gradients on err, y, y_new and h_next): through the error
            # norm autograd would meet sqrt(0) on the finished rows' no-op
            # steps.
            scale = atol + rtol * torch.maximum(y.detach().abs(), y_new.detach().abs())
            err_ratio = torch.sqrt(torch.mean((err.detach() / scale) ** 2, dim=reduce_dims) + 1e-30)
            err_ratio = torch.clamp_min(err_ratio, 1e-10)
            accept = (err_ratio <= 1.0) & ~done
            factor = torch.clamp(0.9 * err_ratio ** (-1.0 / 5.0), 0.2, 5.0)
            h = torch.where(done, h, torch.minimum(torch.maximum(h_eff * factor, h_min), span)).detach()
            t = torch.where(accept, t + h_eff, t)
            y = torch.where(_row(accept, y), y_new, y)
            n_acc = n_acc + accept.to(torch.int32)
        ys.append(y)
        n_accs.append(n_acc)
    return torch.stack(ys), torch.stack(n_accs) if n_accs else y0.new_zeros((0, B), dtype=torch.int32)

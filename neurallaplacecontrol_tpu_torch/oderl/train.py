"""ODE-RL training loops: dynamics fitting + actor-critic policy learning
(port of ``oderl/train.py``).

Rebuild of reference envs/oderl/ctrl/utils.py:154-509 (train_loop /
train_policy / train_dynamics / gradient_match / train_pets /
train_deep_pilco). Each update is one autograd step on the parameter tree
and one step of ``training.train.make_adam`` (optax.adam's arithmetic, held
to optax in the port's tests), as the JAX package jits one update.

Every draw comes from ``draws`` (a ``torch.Generator`` or an
``OderlDraws``-like object, ``oderl.dynamics``): per update, the
function draws of the dynamics net, the segments' trajectory and start
indices, and the imagined rollouts' initial-state indices.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from ..models.common import tree_leaves, tree_map, tree_unflatten
from ..training.train import make_adam
from .ctrl import CTRL
from .dataset import Dataset, interpolation_weights, rbf_kernel
from .dynamics import as_draws

logger = logging.getLogger(__name__)


def _value_and_grad(fn, params):
    """(fn(params), its gradient tree, fn's aux); fn returns (loss, aux).
    Leaves fn does not read get zero gradients."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss, aux = fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads), aux


def _apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).detach(), params, updates)


def _finite_diff_targets(D: Dataset):
    """(s, a) -> ds/dt regression pairs from stored trajectories
    (ctrl/utils.py:453-459)."""
    ds = (D.s[:, 1:] - D.s[:, :-1]).reshape(-1, D.s.shape[-1])
    dt = (D.ts[:, 1:] - D.ts[:, :-1]).reshape(-1, 1)
    s = D.s[:, :-1].reshape(-1, D.s.shape[-1])
    a = D.a[:, :-1].reshape(-1, D.a.shape[-1])
    return s, a, ds / dt


def gradient_match(ctrl: CTRL, params, D: Dataset, draws, n_iter: int = 500, L: int = 10, lr: float = 1e-3,
                   kl_w: float = 1.0):
    """Initialize the drift by regressing finite-difference ds/dt
    (ctrl/utils.py gradient_match:663-697): the summed squared error of L
    function draws plus kl_w times the net's KL. Returns (params, losses)."""
    draws = as_draws(draws)
    s, a, targets = _finite_diff_targets(D)
    L = ctrl.get_L(L)
    x = torch.cat([s, a], dim=-1)[None].expand(L, s.shape[0], s.shape[1] + a.shape[1])
    opt = make_adam(lr)
    state = opt.init(params)

    losses = []
    for _ in range(n_iter):
        noise = draws.f_noise(ctrl.f_net, params["f"], L)

        def loss_fn(p):
            pred = ctrl.f_net.apply(p["f"], x, noise)
            return torch.sum((pred - targets[None]) ** 2) + kl_w * ctrl.f_net.kl(p["f"]), None

        loss, grads, _ = _value_and_grad(loss_fn, params)
        updates, state = opt.update(grads, state)
        params = _apply_updates(params, updates)
        losses.append(loss)
    return params, [float(v) for v in losses]


# train_deep_pilco (ctrl/utils.py:448-476) IS ds/dt regression with KL —
# gradient_match's objective under the dropout net's draws.
def train_deep_pilco(ctrl: CTRL, params, D: Dataset, draws, n_iter: int = 500, L: int = 100, lr: float = 1e-3):
    return gradient_match(ctrl, params, D, draws, n_iter=n_iter, L=L, lr=lr)


def train_pets(ctrl: CTRL, params, D: Dataset, draws=None, n_iter: int = 500, lr: float = 1e-3, C: float = 0.01):
    """Gaussian NLL over the probabilistic ensemble + logsig-bound penalty
    (ctrl/utils.py train_pets:478-506); it draws nothing. Returns (params,
    losses)."""
    s, a, targets = _finite_diff_targets(D)
    L = ctrl.n_ens
    get_probs = ctrl.f_net.extras["get_probs"]
    x = torch.cat([s, a], dim=-1)[None].expand(L, s.shape[0], s.shape[1] + a.shape[1])
    opt = make_adam(lr)
    state = opt.init(params)

    def loss_fn(p):
        mean, sig = get_probs(p["f"], x)
        ll = -0.5 * ((targets[None] - mean) / sig) ** 2 - torch.log(sig) - 0.5 * math.log(2 * math.pi)
        nll = -torch.sum(ll) / L
        return nll + C * torch.sum(p["f"]["max_logsig"] - p["f"]["min_logsig"]), None

    losses = []
    for _ in range(n_iter):
        loss, grads, _ = _value_and_grad(loss_fn, params)
        updates, state = opt.update(grads, state)
        params = _apply_updates(params, updates)
        losses.append(loss)
    return params, [float(v) for v in losses]


def _sample_segments(D: Dataset, traj: torch.Tensor, start: torch.Tensor, W: int):
    """The (trajectory, start) windows of length W+1."""
    idx = start[:, None] + torch.arange(W + 1, device=start.device)[None]
    return D.s[traj[:, None], idx], D.a[traj[:, None], idx], D.ts[traj[:, None], idx]


def _segment_policy(ts_rel, alpha, m):
    """g(s, t) of every row's kernel interpolant of its recorded actions: t
    [B] (the rows' own times), alpha [B, W+1, m] its solved weights."""

    def g(s, t):
        q = torch.as_tensor(t, dtype=ts_rel.dtype, device=ts_rel.device).expand(ts_rel.shape[0])
        a = (rbf_kernel(q[:, None, None], ts_rel[..., None], 0.5, 1.0) @ alpha)[:, 0]  # [B, m]
        return a.expand(s.shape[:-1] + (m,))

    return g


def train_dynamics(ctrl: CTRL, params, D: Dataset, draws, n_iter: int = 250, H: Optional[float] = None, L: int = 1,
                   lr: float = 1e-3, n_seg: int = 32, kl_w: float = 1.0, substeps: int = 5, log_every: int = 50):
    """Trajectory-segment likelihood fitting for the ODE families
    (ctrl/utils.py train_dynamics:317-413 + dynamics_loss:303-314): simulate
    each segment from its first state under the kernel-interpolated recorded
    actions, score a Gaussian likelihood with the learned noise scale sn.

    Each segment is simulated on its own time grid with its own function
    draw. The ODE families (enode, benode, ibnode) simulate all segments in
    one batch (``simulate_enode`` with per-row grids); pets and deep_pilco,
    whose draws couple the batch, one segment at a time. Each segment's
    interpolant is solved once per update, where the JAX package solves it
    inside every right-hand side: the same linear system, so the same
    numbers to rounding.

    Returns (params, losses-in-mse).
    """
    draws = as_draws(draws)
    spec = ctrl.env.spec
    H = H if H is not None else 5 * spec.dt  # train_ode (:432)
    W = max(1, int(round(H / spec.dt)))
    if W + 1 > D.T:
        raise ValueError(f"segment window W+1={W + 1} exceeds trajectory length T={D.T}")
    L = ctrl.get_L(L)
    n = spec.n_obs  # obs-space dynamics
    opt = make_adam(lr)
    state = opt.init(params)

    def simulate(p, s_seg, ts_rel, alpha):
        if ctrl.is_cont:
            g = _segment_policy(ts_rel, alpha, spec.m)
            st, _, _ = ctrl.forward_simulate(p, draws, ts_rel, s_seg[:, 0], g=g, L=L, compute_rew=False,
                                             substeps=substeps)
            return st.transpose(0, 1)  # [B, L', W, n]
        rows = []
        for b in range(s_seg.shape[0]):
            g = _segment_policy(ts_rel[b:b + 1], alpha[b:b + 1], spec.m)
            st, _, _ = ctrl.forward_simulate(p, draws, ts_rel[b], s_seg[b:b + 1, 0], g=g, L=L,
                                             compute_rew=False, substeps=substeps)
            rows.append(st[:, 0])
        return torch.stack(rows)

    mses = []
    for i in range(n_iter):
        traj = draws.randint(D.N, n_seg)
        start = draws.randint(D.T - W, n_seg)  # the window [start, start+W] may reach the tail
        s_seg, a_seg, ts_seg = _sample_segments(D, traj, start, W)
        ts_rel = ts_seg - ts_seg[:, :1]
        alpha = interpolation_weights(ts_rel, a_seg)

        def loss_fn(p):
            st_hat = simulate(p, s_seg, ts_rel, alpha)
            sn = torch.exp(p["logsn"][:n])
            sq = ((s_seg[:, None, :W] - st_hat) ** 2) / sn**2 / 2.0
            lhood = -sq - torch.mean(p["logsn"][:n]) - 0.5 * math.log(2 * math.pi)
            loss = -torch.sum(lhood) / st_hat.shape[1] + kl_w * ctrl.f_net.kl(p["f"])
            return loss, torch.mean(sq).detach()

        _, grads, mse = _value_and_grad(loss_fn, params)
        updates, state = opt.update(grads, state)
        params = _apply_updates(params, updates)
        mses.append(mse)
        if log_every and i % log_every == 0:
            logger.info("[train_dynamics %s] iter %d mse %.4f", ctrl.name, i, float(mse))
    return params, [float(v) for v in mses]


def train_policy(ctrl: CTRL, params, D: Dataset, draws, n_iter: int = 250, H: float = 2.0, tau: float = 5.0,
                 N: int = 100, L: int = 10, V_const: float = 1.0, lr: float = 1e-3, value_inner_iters: int = 10,
                 target_update_every: int = 100, substeps: int = 5, log_every: int = 50):
    """Actor-critic through imagined rollouts (ctrl/utils.py
    train_policy:216-301): maximize n-step returns rt + e^{-t/tau} V(st)
    under L dynamics draws; fit V to the bootstrapped targets
    (``value_inner_iters`` TD steps an update) against a frozen target copy
    refreshed every ``target_update_every`` updates. The policy and the
    value net each have an Adam of their own.

    Returns (params, mean imagined reward per update).
    """
    draws = as_draws(draws)
    L = ctrl.get_L(L)
    s_pool = D.s.reshape(-1, D.s.shape[-1])
    opt_g, opt_v = make_adam(lr), make_adam(lr)
    g_state, v_state = opt_g.init(params["g"]), opt_v.init(params["V"])

    rewards = []
    V_target = params["V"]
    for i in range(n_iter):
        if i % target_update_every == 0:
            V_target = params["V"]
        s0 = s_pool[draws.randint(s_pool.shape[0], N)]
        p_other = {k: v for k, v in params.items() if k != "g"}

        def policy_loss(pg):
            st, rt, ts = ctrl.forward_simulate({**p_other, "g": pg}, draws, H, s0, L=L, tau=tau, compute_rew=True,
                                               substeps=substeps)
            gammas = torch.exp(-ts / tau)
            V_st = ctrl.V_net.apply(V_target, st)[..., 0]  # [L,N,T]
            n_step = rt[:, :, 1:] + V_const * V_st[:, :, 1:] * gammas[1:]
            mean_reward = torch.mean(rt[:, :, -1]) / H
            return -torch.mean(n_step), (st.detach(), rt.detach(), ts, mean_reward.detach())

        loss, g_grads, (st, rt, ts, mean_rew) = _value_and_grad(policy_loss, params["g"])
        updates, g_state = opt_g.update(g_grads, g_state)
        params = {**params, "g": _apply_updates(params["g"], updates)}

        # bootstrapped value targets (train_policy :277-285)
        with torch.no_grad():
            gammas = torch.exp(-ts / tau)
            last_vals = ctrl.V_net.apply(V_target, st)[..., 0]
            Vtargets = torch.mean(torch.mean(rt[:, :, 1:] + gammas[1:] * last_vals[:, :, 1:], dim=0), dim=-1)  # [N]

        def td_loss(vp):
            return torch.mean((ctrl.V_net.apply(vp, s0)[..., 0] - Vtargets) ** 2), None

        v_params = params["V"]
        for _ in range(value_inner_iters):
            td_err, grads, _ = _value_and_grad(td_loss, v_params)
            updates, v_state = opt_v.update(grads, v_state)
            v_params = _apply_updates(v_params, updates)
        params = {**params, "V": v_params}
        rewards.append(mean_rew)
        if log_every and i % log_every == 0:
            logger.info("[train_policy %s] iter %d opt %.3f reward %.3f td %.4f", ctrl.name, i, float(loss),
                        float(mean_rew), float(td_err))
    return params, [float(v) for v in rewards]

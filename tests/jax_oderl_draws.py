"""Replay the JAX ODE-RL stack's random draws into the port's.

The JAX package (``neurallaplacecontrol_tpu/oderl``) draws from keys:
``simulate_enode`` its function draw from its key (``net.draw_noise``);
``simulate_pets`` one output-noise key per step (``split(key, T)``) and a
particle-to-member permutation per step from the chain ``fold_in(key, 1)``;
``simulate_deep_pilco`` its dropout masks from its key and the moment-
matching normals per step from the chain ``fold_in(key, 2)``; the trainers
``fold_in(key, i)`` per update, split into the segments' and the draws' keys
(``train_dynamics``, then one key per row) or three ways
(``train_policy``). The functions here make the same draws, in the order the
port's methods of ``oderl.dynamics.OderlDraws`` are called, and
``ReplayDraws`` hands them over one call at a time.
"""

import jax
import numpy as np
import torch


def to_torch(tree, dtype=torch.float64):
    """A JAX draw (tree of arrays, or None) as torch tensors on the CPU;
    float32 leaves (the dropout masks) stay float32, integers int64."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, dtype) for v in tree]
    a = np.asarray(tree)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a, dtype=torch.long)
    return torch.as_tensor(a, dtype=torch.float32 if a.dtype == np.float32 else dtype)


class ReplayDraws:
    """``OderlDraws``' methods over a list of (kind, value), one per call."""

    def __init__(self, items):
        self.items = list(items)

    def _next(self, kind):
        got, value = self.items.pop(0)
        assert got == kind, f"the port asked for {kind}, the JAX run drew {got} next"
        return value

    def f_noise(self, net, params, L, rows=1):
        return self._next("f_noise")

    def pets(self, T, L, PN, n, dtype):
        return self._next("pets")

    def moments(self, T, L, N, n, dtype):
        return self._next("moments")

    def randint(self, high, n):
        return self._next("randint")

    def done(self):
        return not self.items


def f_noise(jnet, jparams_f, key, L, out_shape=None):
    """The JAX net's function draw as ``apply`` reads it; the EPNN's output
    noise is drawn inside ``apply`` from its key, of the output's shape."""
    if jnet.name == "epnn":
        return jax.random.normal(key, out_shape)
    return jnet.draw_noise(jparams_f, key, L)


def rows_noise(jnet, jparams_f, keys, L):
    """Per-row function draws (one key per row) stacked as the port's
    ``draw_noise(..., rows=B)``: [L, B, ...] where each row's is [L, 1, ...]."""
    per_row = [jnet.draw_noise(jparams_f, k, L) for k in keys]
    if per_row[0] is None:
        return None
    return [np.concatenate([np.asarray(r[j]) for r in per_row], axis=1) for j in range(len(per_row[0]))]


def sim_draws(jctrl, jparams_f, key, L, N, T, P=20):
    """The draws of ``CTRL.forward_simulate(params, key, ...)`` from N initial
    states over T intervals, in the port's call order."""
    net, n = jctrl.f_net, jctrl.env.spec.n_obs
    if jctrl.dynamics == "pets":
        L = net.n_ens
        draw_keys = jax.random.split(key, T)
        eps = np.stack([np.asarray(jax.random.normal(k, (L, P * N, n))) for k in draw_keys])
        k, perms = jax.random.fold_in(key, 1), []
        for _ in range(T):
            k, k_shuf = jax.random.split(k)
            perms.append(np.asarray(jax.random.permutation(k_shuf, L)))
        return [("pets", (to_torch(eps), to_torch(np.stack(perms))))]
    if jctrl.dynamics == "deep_pilco":
        k, mm = jax.random.fold_in(key, 2), []
        for _ in range(T):
            k, k_mm = jax.random.split(k)
            mm.append(np.asarray(jax.random.normal(k_mm, (L, N, n))))
        return [("f_noise", to_torch(net.draw_noise(jparams_f, key, L))), ("moments", to_torch(np.stack(mm)))]
    L = net.n_ens if net.n_ens > 1 else L
    return [("f_noise", to_torch(net.draw_noise(jparams_f, key, L)))]


def gradient_match_draws(jctrl, jparams_f, key, n_iter, L, M):
    """``gradient_match``'s draws: ``fold_in(key, i)`` per update, over M pairs."""
    L = jctrl.get_L(L)
    n = jctrl.env.spec.n_obs
    return [("f_noise", to_torch(f_noise(jctrl.f_net, jparams_f, jax.random.fold_in(key, i), L, (L, M, n))))
            for i in range(n_iter)]


def train_dynamics_draws(jctrl, jparams_f, key, n_iter, D_N, D_T, W, n_seg, L):
    """``train_dynamics``' draws: per update the segments' trajectory and
    start indices, then each row's simulation draws (one key per row), all
    rows at once for the ODE families."""
    L = jctrl.get_L(L)
    items = []
    for i in range(n_iter):
        k_seg, k_draw = jax.random.split(jax.random.fold_in(key, i))
        k1, k2 = jax.random.split(k_seg)
        items.append(("randint", to_torch(jax.random.randint(k1, (n_seg,), 0, D_N))))
        items.append(("randint", to_torch(jax.random.randint(k2, (n_seg,), 0, D_T - W))))
        keys = jax.random.split(k_draw, n_seg)
        if jctrl.is_cont:
            items.append(("f_noise", to_torch(rows_noise(jctrl.f_net, jparams_f, keys, L))))
        else:
            for k in keys:
                items += sim_draws(jctrl, jparams_f, k, L, 1, W)
    return items


def train_policy_draws(jctrl, jparams_f, key, n_iter, pool, N, L, T):
    """``train_policy``'s draws: per update the N initial-state indices into
    the pool, then the imagined rollout's draws."""
    items = []
    for i in range(n_iter):
        k_iv, k_sim, _ = jax.random.split(jax.random.fold_in(key, i), 3)
        items.append(("randint", to_torch(jax.random.randint(k_iv, (N,), 0, pool))))
        items += sim_draws(jctrl, jparams_f, k_sim, L, N, T)
    return items

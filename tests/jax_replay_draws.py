"""Replay the JAX episode's random draws into the port's episode.

The JAX episode (neurallaplacecontrol_tpu/training/rollout.py) splits each
seed's key 3 ways (:187) into reset, U0 and scan keys, then the scan key 6
ways per step (:204) into the next key and the noise, random-action, dt,
observation-noise and exploration keys. ``JaxDraws`` makes the same splits
and the same draws (the planner noise through ``planners.mppi_delay
._sample_noise``, U0 through ``mppi_reset``) and hands them to the port's
episode through the methods of ``neurallaplacecontrol_tpu_torch.training
.rollout.SeedDraws``, one value per seed stacked on a leading axis.
"""

import jax
import numpy as np
import torch

from neurallaplacecontrol_tpu.envs import sample_dt
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import initial_state


class JaxDraws:
    def __init__(self, keys, jenv, jcfg, jparams, n_steps, dtype=torch.float64):
        """``keys``: one PRNG key per seed; ``jcfg``/``jparams``: the JAX
        planner's config and params, whose draws are replayed."""
        self.jenv, self.jcfg, self.jparams, self.dtype = jenv, jcfg, jparams, dtype
        self.k_reset, self.k_u0, self.k_step = [], [], []
        for key in keys:
            k_reset, k_u0, k_scan = jax.random.split(key, 3)
            steps = []
            for _ in range(n_steps):
                k_scan, *ks = jax.random.split(k_scan, 6)
                steps.append(ks)  # k_noise, k_rand, k_dt, k_obs, k_explore
            self.k_reset.append(k_reset)
            self.k_u0.append(k_u0)
            self.k_step.append(steps)

    def __len__(self):
        return len(self.k_reset)

    def _stack(self, arrays):
        return torch.tensor(np.stack([np.asarray(a) for a in arrays]), dtype=self.dtype)

    def _per_step(self, it, which, draw):
        return self._stack(draw(steps[it][which]) for steps in self.k_step)

    def reset_state(self, env):
        return self._stack(initial_state(self.jenv, k) for k in self.k_reset)

    def plan0(self, cfg, params):
        return self._stack(jmppi.mppi_reset(k, self.jcfg, self.jparams) for k in self.k_u0)

    def planner_noise(self, it, cfg, params):
        return self._per_step(it, 0, lambda k: jmppi._sample_noise(k, self.jcfg, self.jparams))

    def random_action(self, it, nu, low, high):
        return self._per_step(it, 1, lambda k: jax.random.uniform(k, (nu,), minval=low, maxval=high))

    def dt(self, it, ts_grid, dt):
        return self._per_step(it, 2, lambda k: sample_dt(k, ts_grid, dt))

    def obs_noise(self, it, n):
        return self._per_step(it, 3, lambda k: jax.random.normal(k, (n,)))

    def explore(self, it, nu):
        return self._per_step(it, 4, lambda k: jax.random.uniform(k, (nu,)))


def seed_keys(seeds):
    """The keys the JAX evaluator makes from integer seeds (training/eval.py:203)."""
    return [jax.random.PRNGKey(int(s)) for s in seeds]


def to_numpy(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def z0_draws(key, rows, latents, n_samples=1, dtype=np.float64):
    """The JAX latent ODE's draws of z0's noise from ``key``
    (models/latent_ode.py predict_diff): one [rows, latents] standard normal
    per sample, from ``jax.random.split(key, n_samples)``, in the model's
    dtype (f32 and f64 draws differ); [S, rows, latents]."""
    return np.stack([np.asarray(jax.random.normal(k, (rows, latents), dtype=dtype))
                     for k in jax.random.split(key, n_samples)])


def fixed_z0_draw(rows, latents, dtype=np.float64):
    """The draw of the JAX latent ODE's ``apply`` and carried dynamics, which
    take ``PRNGKey(0)`` on every call: [rows, latents]."""
    return z0_draws(jax.random.PRNGKey(0), rows, latents, dtype=dtype)[0]

"""The JAX side of the planner cases of tests/torch_shard_worker.py
(``COMMAND_CASES``): the same cartpole oracle planner, flags and dynamics,
built on the JAX package for tests/test_torch_sharding.py and
tests/test_torch_planner.py."""

import jax
import jax.numpy as jnp

import torch_shard_worker as W
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import build_oracle_dynamics as jax_oracle
from neurallaplacecontrol_tpu.training.rollout import build_running_cost as jax_cost


def jax_command_planner(case):
    """The JAX side of ``torch_shard_worker.command_planner``."""
    flags, kind, key, K, T = W.COMMAND_CASES[case]
    env = jax_make_env("oderl-cartpole")
    cfg = jmppi.MPPIConfig(num_samples=K, horizon=T, nu=1, u_scale=3.0, u_min=-3.0, u_max=3.0, dt=0.05, **flags)
    params = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))
    base = jax_oracle(env, K, 0.05, 1)
    extra, dyn = {}, base
    if kind == "strip_age":
        def dyn(state, window):
            return base(state, window[..., :1])
    elif kind == "step":
        def dyn(state, window, t):
            return base(state, window) + 1e-4 * t
    elif kind == "terminal":
        extra["terminal_state_cost"] = lambda states, actions: jnp.sum(states[:, -1, :] ** 2, axis=-1)
    elif kind == "carried":
        extra["dynamics_carry_init"] = lambda state0: jnp.zeros((state0.shape[0],), state0.dtype)

        def dyn(carry, state, window):
            carry = carry + jnp.sum(window[:, -1, :], axis=-1)
            return carry, base(state, window) + 1e-5 * carry[:, None]
    return env, cfg, params, dyn, jax_cost(env), extra, jax.random.PRNGKey(key)

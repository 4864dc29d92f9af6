"""Port environments (neurallaplacecontrol_tpu_torch.envs) against the JAX
package's envs at f64: physics, observation maps, rewards, the Euler step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.envs import env_step as jax_env_step
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.envs import trig_to_angle as jax_trig_to_angle
from neurallaplacecontrol_tpu.training.rollout import build_running_cost as jax_cost
from neurallaplacecontrol_tpu_torch.envs import env_step as torch_env_step
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.envs import trig_to_angle as torch_trig_to_angle
from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost as torch_cost

torch.set_num_threads(1)

CASES = [
    ("oderl-pendulum", False),
    ("oderl-cartpole", False),
    ("oderl-cartpole", True),
    ("oderl-acrobot", False),
]


def close(got, exp):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-12, atol=1e-12)


def draws(spec, seed=0, B=32):
    rng = np.random.default_rng(seed)
    raw = rng.uniform(-3.0, 3.0, (B, spec.n_state))
    action = rng.uniform(-1.5 * spec.action_high, 1.5 * spec.action_high, (B, spec.m))
    return raw, action


@pytest.mark.parametrize("env_name,friction", CASES)
def test_physics_and_rewards_match_jax(env_name, friction):
    jenv = jax_make_env(env_name, friction=friction)
    tenv = torch_make_env(env_name, friction=friction)
    assert tenv.spec == type(tenv.spec)(**jenv.spec.__dict__)
    raw, action = draws(jenv.spec)
    jraw, traw = jnp.asarray(raw), torch.tensor(raw)
    ja, ta = jnp.asarray(action), torch.tensor(action)
    jobs, tobs = jenv.observe(jraw), tenv.observe(traw)
    close(tobs, jobs)
    close(tenv.obs_to_state(tobs), jenv.obs_to_state(jobs))
    for j, t in ((jraw, traw), (jobs * 1.01, tobs * 1.01)):  # raw and (unnormalized) trig forms
        close(tenv.rhs(t, ta), jenv.rhs(j, ja))
        close(tenv.reward_state(t), jenv.reward_state(j))
    close(tenv.reward_action(ta), jenv.reward_action(ja))
    close(torch_env_step(tenv, traw, ta, 0.05), jax_env_step(jenv, jraw, ja, 0.05))
    close(torch_cost(tenv)(tobs, ta), jax_cost(jenv)(jobs, ja))


def test_cartpole_state_constraint_cost_matches_jax():
    jenv, tenv = jax_make_env("oderl-cartpole"), torch_make_env("oderl-cartpole")
    raw, action = draws(jenv.spec, seed=1)
    jobs, tobs = jenv.observe(jnp.asarray(raw)), tenv.observe(torch.tensor(raw))
    close(torch_cost(tenv, state_constraint=True)(tobs, torch.tensor(action)),
          jax_cost(jenv, state_constraint=True)(jobs, jnp.asarray(action)))


def test_trig_to_angle_matches_jax_and_stops_gradient_of_the_norm():
    rng = np.random.default_rng(2)
    c, s = rng.standard_normal(16), rng.standard_normal(16)
    close(torch_trig_to_angle(torch.tensor(c), torch.tensor(s)),
          jax_trig_to_angle(jnp.asarray(c), jnp.asarray(s)))
    ct = torch.tensor(c, requires_grad=True)
    torch_trig_to_angle(ct, torch.tensor(s)).sum().backward()
    assert bool(torch.isfinite(ct.grad).all())


@pytest.mark.parametrize("env_name", ["oderl-pendulum", "oderl-cartpole", "oderl-acrobot"])
def test_reset_is_seeded_and_in_range(env_name):
    env = torch_make_env(env_name)
    a = env.reset(torch.Generator().manual_seed(4), dtype=torch.float64)
    b = env.reset(torch.Generator().manual_seed(4), dtype=torch.float64)
    assert torch.equal(a, b) and a.shape == (env.spec.n_state,)
    centre = {"oderl-pendulum": [np.pi, 0.0], "oderl-cartpole": [0, 0, np.pi, 0],
              "oderl-acrobot": [0, 0, 0, 0]}[env_name]
    assert float((a - torch.tensor(centre, dtype=torch.float64)).abs().max()) <= 0.1


def test_unknown_env_raises():
    with pytest.raises(ValueError):
        torch_make_env("mountaincar")

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


def test_env_names_match_jax():
    from neurallaplacecontrol_tpu.envs import ENV_NAMES as JAX_NAMES
    from neurallaplacecontrol_tpu_torch.envs import ENV_NAMES

    assert ENV_NAMES == JAX_NAMES


@pytest.mark.parametrize("env_name,friction", CASES)
def test_df_du_matches_jax(env_name, friction):
    """The action Jacobian of the rhs (forward-mode AD in both packages) at
    three states, f64, rtol 1e-12."""
    from neurallaplacecontrol_tpu.envs.base import df_du as jax_df_du
    from neurallaplacecontrol_tpu_torch.envs import df_du

    jenv = jax_make_env(env_name, friction=friction)
    tenv = torch_make_env(env_name, friction=friction)
    raw, action = draws(jenv.spec, seed=5, B=3)
    for s, a in zip(raw, action):
        got = df_du(tenv, torch.tensor(s), torch.tensor(a))
        assert got.shape == (jenv.spec.n_state, jenv.spec.m)
        close(got, jax_df_du(jenv, jnp.asarray(s), jnp.asarray(a)))


@pytest.mark.parametrize("kw", [{}, {"goal_x": 2.0, "state_constraint": True}, {"exp_reward": True}],
                         ids=["plain", "goal_constraint", "exp_reward"])
def test_end_effector_reward_reduced_matches_jax(kw):
    from neurallaplacecontrol_tpu.envs.cartpole import end_effector_reward_reduced as jax_reward
    from neurallaplacecontrol_tpu_torch.envs.cartpole import end_effector_reward_reduced

    s = np.random.default_rng(2).uniform(-1.0, 1.0, (16, 3))
    close(end_effector_reward_reduced(torch.tensor(s), **kw), jax_reward(jnp.asarray(s), **kw))


@pytest.mark.parametrize("env_name", ["oderl-pendulum", "oderl-cartpole", "oderl-acrobot"])
@pytest.mark.parametrize("trig", [False, True], ids=["raw", "trig"])
def test_single_action_oracles_match_jax(env_name, trig):
    """``*_dynamics_dt`` (delay 0, one action) on raw and trig states against
    JAX's, f64, at per-row query times."""
    from neurallaplacecontrol_tpu.envs import oracle as joracle
    from neurallaplacecontrol_tpu_torch.envs import oracle as toracle

    name = env_name.removeprefix("oderl-") + "_dynamics_dt"
    jenv = jax_make_env(env_name)
    raw, action = draws(jenv.spec, seed=9, B=8)
    state = np.asarray(jenv.observe(jnp.asarray(raw))) if trig else raw
    ts = np.random.default_rng(1).uniform(0.01, 0.1, (8, 1))
    got = getattr(toracle, name)(torch.tensor(state), torch.tensor(action), torch.tensor(ts))
    close(got, getattr(joracle, name)(jnp.asarray(state), jnp.asarray(action), jnp.asarray(ts)))


def test_cast_params_matches_jax():
    from neurallaplacecontrol_tpu.models.common import cast_params as jax_cast
    from neurallaplacecontrol_tpu_torch.models.common import cast_params, tree_leaves

    tree = {"a": [{"w": torch.arange(6.0).reshape(2, 3)}], "b": torch.tensor([0.1, 0.2], dtype=torch.float64)}
    got = cast_params(tree, torch.float32)
    exp = jax_cast({"a": [{"w": jnp.arange(6.0).reshape(2, 3)}], "b": jnp.asarray([0.1, 0.2])}, jnp.float32)
    assert all(x.dtype == torch.float32 for x in tree_leaves(got))
    close(got["a"][0]["w"], exp["a"][0]["w"])
    close(got["b"], exp["b"])


@pytest.mark.parametrize("env_name", ["oderl-pendulum", "oderl-cartpole", "oderl-acrobot"])
def test_render_frame_is_pixel_equal_to_jax(env_name):
    """The port's frame of a raw state, with and without the force arrow,
    against the JAX package's, pixel for pixel."""
    from neurallaplacecontrol_tpu.envs.render import render_frame as jax_render
    from neurallaplacecontrol_tpu_torch.envs.render import render_frame

    raw, action = draws(jax_make_env(env_name).spec, seed=4, B=2)
    for s, a in ((raw[0], None), (raw[1], action[1])):
        got = render_frame(env_name, torch.tensor(s), last_act=a)
        exp = jax_render(env_name, jnp.asarray(s), last_act=a)
        assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[-1] == 3
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("form", ["trig", "raw", "reduced"])
def test_two_frame_latent_oracles_match_jax(form):
    """``cartpole_dynamics_dt_latent`` on 5-wide trig and 4-wide raw frames,
    and ``_latent_reduced`` on 3-wide position frames, against JAX's at f64:
    velocities by finite differences of two frames, semi-implicit Euler."""
    from neurallaplacecontrol_tpu.envs import oracle as joracle
    from neurallaplacecontrol_tpu_torch.envs import oracle as toracle

    jenv = jax_make_env("oderl-cartpole")
    raw, action = draws(jenv.spec, seed=4, B=16)
    prev_raw = raw - 0.05 * np.random.default_rng(5).uniform(-1.0, 1.0, raw.shape)
    ts = np.random.default_rng(6).uniform(0.02, 0.1, (16, 1))
    if form == "raw":
        state, prev = raw, prev_raw
    else:
        state, prev = (np.asarray(jenv.observe(jnp.asarray(x))) for x in (raw, prev_raw))
        if form == "reduced":
            state, prev = state[:, [0, 2, 3]], prev[:, [0, 2, 3]]
    name = "cartpole_dynamics_dt_latent" + ("_reduced" if form == "reduced" else "")
    for tq in (ts, ts[:, 0]):
        got = getattr(toracle, name)(torch.tensor(state), torch.tensor(prev), torch.tensor(action), torch.tensor(tq))
        exp = getattr(joracle, name)(jnp.asarray(state), jnp.asarray(prev), jnp.asarray(action), jnp.asarray(tq))
        assert got.shape == exp.shape
        close(got, exp)

"""The port's closed-loop episode (training.rollout) against the JAX
package's ``make_episode_fn`` at f64 on the CPU, with the JAX draws replayed
(tests/jax_replay_draws.py): the NL planner through the plain forward at
delays 0-3 (acrobot's 2-d actions among them), the oracle at delays 0-3, the random policy, the irregular
``exp`` grid with the age channel, exploration noise and observation noise.

Tolerance: rtol 1e-10 (and atol 1e-10 on values that pass through zero),
where both packages do the same f64 math on the same draws.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay_draws import JaxDraws, fixed_z0_draw, seed_keys

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.latent_ode import make_carried_dynamics as jax_carried
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training import rollout as jrollout
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_carried_dynamics, make_latent_ode_model
from neurallaplacecontrol_tpu_torch.planners import mppi_delay as tmppi
from neurallaplacecontrol_tpu_torch.training import rollout as trollout
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, T, N_STEPS, DT = 16, 5, 6, 0.05
SEEDS = (0, 7)
RTOL = ATOL = 1e-10


def build(env_name, delay, model, ts_grid="fixed", encode=False, checkpoint_delay=None):
    """(jax env, cfg, params, dynamics), (torch ...) for one policy at f64."""
    jenv = jax_make_env(env_name, dt=DT, ts_grid=ts_grid)
    tenv = torch_make_env(env_name, dt=DT, ts_grid=ts_grid)
    spec = jenv.spec
    cfg_kw = dict(num_samples=K, horizon=T, nu=spec.m, u_scale=spec.action_high,
                  u_min=-spec.action_high, u_max=spec.action_high, dt=DT, encode_obs_time=encode)
    jparams = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    tparams = tmppi.make_mppi_params(tmppi.default_noise_sigma(spec.m, 1.0, dtype=torch.float64))
    if model == "oracle":
        jdyn = jrollout.build_oracle_dynamics(jenv, K, DT, delay)
        tdyn = trollout.build_oracle_dynamics(tenv, DT, delay)
    elif model == "nl":
        ckpt = model_checkpoint_name("nl", env_name, delay if checkpoint_delay is None else checkpoint_delay,
                                     "exp", 0, True)
        tweights = load_pytree(REPO / "artifacts" / "checkpoints" / ckpt, device="cpu", dtype=torch.float64)
        jweights = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tweights)
        jm = jax_make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high,
                            JConfig(encode_obs_time=encode), dtype=jnp.float64)
        tm = torch_make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high,
                              TConfig(encode_obs_time=encode), dtype=torch.float64, device="cpu")
        jdyn = jrollout.build_learned_dynamics(jenv, jm.apply, jweights, K, DT)
        tdyn = trollout.build_learned_dynamics(tm.apply, tweights, DT)
    else:
        jdyn = tdyn = None
    return ((jenv, jmppi.MPPIConfig(**cfg_kw), jparams, jdyn),
            (tenv, tmppi.MPPIConfig(**cfg_kw), tparams, tdyn))


def run_both(env_name, delay, model, seeds=SEEDS, ts_grid="fixed", encode=False,
             checkpoint_delay=None, **settings_kw):
    (jenv, jcfg, jparams, jdyn), (tenv, tcfg, tparams, tdyn) = build(
        env_name, delay, model, ts_grid, encode, checkpoint_delay)
    settings_kw.setdefault("random_policy", model == "random")
    jset = jrollout.EpisodeSettings(delay=delay, n_steps=N_STEPS, encode_obs_time=encode, **settings_kw)
    tset = trollout.EpisodeSettings(delay=delay, n_steps=N_STEPS, encode_obs_time=encode, **settings_kw)
    keys = seed_keys(seeds)
    jtot, jrec = jrollout.make_batched_episode_fn(jenv, jdyn, jcfg, jparams, jset)(jnp.stack(keys))
    draws = JaxDraws(keys, jenv, jcfg, jparams, N_STEPS)
    ttot, trec = trollout.make_episode_fn(tenv, tdyn, tcfg, tparams, tset)(draws)
    return (np.asarray(jtot), jrec), (ttot.numpy(), trec)


def assert_records_match(jrec, trec):
    for field in jrollout.EpisodeRecords._fields:
        got, exp = getattr(trec, field).numpy(), np.asarray(getattr(jrec, field))
        assert got.shape == exp.shape, (field, got.shape, exp.shape)
        np.testing.assert_allclose(got, exp, rtol=RTOL, atol=ATOL, err_msg=field)


@pytest.mark.parametrize(
    "env_name,delay,model,kw",
    [
        ("oderl-cartpole", 1, "nl", {}),
        ("oderl-pendulum", 0, "oracle", {}),
        ("oderl-cartpole", 1, "oracle", {}),
        ("oderl-acrobot", 2, "oracle", {}),
        ("oderl-cartpole", 1, "random", {}),
        # the age-channel checkpoint on the irregular grid
        ("oderl-pendulum", 0, "nl", {"ts_grid": "exp", "encode": True}),
        # the collector's setting: exploration noise on the exp grid
        ("oderl-pendulum", 1, "oracle", {"ts_grid": "exp", "explore_noise": 1.0}),
        ("oderl-cartpole", 1, "oracle", {"observation_noise": 0.05}),
        # the goal flips from -2 to +2 after step 3 of 6
        ("oderl-cartpole", 1, "nl", {"change_goal": True}),
        ("oderl-cartpole", 2, "oracle", {"change_goal": True}),
        # the paper's table off delay 1: no delay, a delay of 2, and acrobot's
        # 2-d actions at the longest delay
        ("oderl-cartpole", 0, "nl", {}),
        ("oderl-pendulum", 2, "nl", {}),
        ("oderl-acrobot", 3, "nl", {}),
        ("oderl-cartpole", 3, "oracle", {}),
    ],
    ids=["nl", "oracle_d0_pendulum", "oracle_d1_cartpole", "oracle_d2_acrobot", "random",
         "exp_grid_encode_obs_time", "explore_noise", "observation_noise", "change_goal_nl",
         "change_goal_oracle", "nl_d0_cartpole", "nl_d2_pendulum", "nl_d3_acrobot", "oracle_d3_cartpole"],
)
def test_episode_matches_jax_f64(env_name, delay, model, kw):
    (jtot, jrec), (ttot, trec) = run_both(env_name, delay, model, **kw)
    assert ttot.shape == (len(SEEDS),)
    np.testing.assert_allclose(ttot, jtot, rtol=RTOL)
    assert_records_match(jrec, trec)
    assert np.all(np.isfinite(ttot))


def test_episode_records_realized_ages():
    """The recorded age channel tracks the REALIZED step durations
    (tests/test_encode_obs_time.py:57): a0[k, -1] age = 0,
    a0[k, -2] age = ts[k], a0[k, -3] age = ts[k-1] + ts[k]."""
    _, (_, rec) = run_both("oderl-pendulum", 1, "random", seeds=(0,), ts_grid="exp", encode=True)
    a0, ts = rec.a0[0].numpy(), rec.ts[0].numpy()
    assert a0.shape == (N_STEPS, 4, 2)  # nu + age channel
    np.testing.assert_allclose(a0[:, -1, -1], 0.0, atol=1e-12)
    np.testing.assert_allclose(a0[:, -2, -1], ts, rtol=1e-12)
    np.testing.assert_allclose(a0[2:, -3, -1], ts[1:-1] + ts[2:], rtol=1e-12)
    assert ts.std() > 0  # the exp grid really is irregular


def test_batched_episode_equals_single_episodes():
    """S=3 seeds in lockstep give each seed's own episode: the planner's
    softmax normalizer reduces per seed, not over all S*K rollouts."""
    (_, _, _, _), (tenv, tcfg, tparams, tdyn) = build("oderl-cartpole", 1, "nl")
    settings = trollout.EpisodeSettings(delay=1, n_steps=N_STEPS)
    episodes = trollout.make_batched_episode_fn(tenv, tdyn, tcfg, tparams, settings)
    seeds = [3, 11, 42]
    tot, rec = episodes(seeds)
    for i, s in enumerate(seeds):
        tot1, rec1 = episodes([s])
        np.testing.assert_allclose(tot[i : i + 1].numpy(), tot1.numpy(), rtol=RTOL)
        for field in trollout.EpisodeRecords._fields:
            np.testing.assert_allclose(getattr(rec, field)[i : i + 1].numpy(),
                                       getattr(rec1, field).numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=field)
    assert len({float(x) for x in tot}) == 3  # three different episodes


def test_batched_planner_reduces_per_seed():
    """One seed-batched tick equals its seeds' S=1 ticks even when the seeds'
    costs differ by orders of magnitude (a global min would zero the
    weights of every seed but the best one)."""
    (_, _, _, _), (tenv, tcfg, tparams, tdyn) = build("oderl-cartpole", 1, "nl")
    cost = trollout.build_running_cost(tenv)
    rng = np.random.default_rng(0)
    S = 3
    U = torch.tensor(rng.standard_normal((S, T, 1)) * 0.5)
    obs = torch.tensor(rng.standard_normal((S, 5)) * np.array([[1.0], [10.0], [0.1]]))
    buffer = torch.tensor(rng.uniform(-3, 3, (S, 4, 1)))
    noise = torch.tensor(rng.standard_normal((S, K, T, 1)))
    a, U_new, aux = tmppi.mppi_command_core(tcfg, tparams, tdyn, cost, U, obs, buffer, noise)
    assert a.shape == (S, 1) and U_new.shape == (S, T, 1) and aux["omega"].shape == (S, K)
    np.testing.assert_allclose(aux["omega"].sum(dim=1).numpy(), 1.0, rtol=1e-12)
    for s in range(S):
        a1, U1, aux1 = tmppi.mppi_command_core(tcfg, tparams, tdyn, cost, U[s], obs[s], buffer[s], noise[s])
        np.testing.assert_allclose(a[s].numpy(), a1.numpy(), rtol=RTOL)
        np.testing.assert_allclose(U_new[s].numpy(), U1.numpy(), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(aux["omega"][s].numpy(), aux1["omega"].numpy(), rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize(
    "kwargs,settings_kw",
    [({}, {"change_goal": True})],
    ids=["change_goal"],
)
def test_unported_episode_features_raise(kwargs, settings_kw):
    """change_goal is ported; what still raises is a goal on an env whose
    reward has no goal (pendulum), as the JAX package's assert refuses it."""
    (_, _, _, _), (tenv, tcfg, tparams, tdyn) = build("oderl-pendulum", 1, "oracle")
    with pytest.raises(ValueError, match="change_goal needs cartpole"):
        trollout.make_episode_fn(tenv, tdyn, tcfg, tparams,
                                 trollout.EpisodeSettings(delay=1, **settings_kw), **kwargs)


def test_change_goal_moves_the_goal_mid_episode():
    """The planner's goal is -2 through step n/2 and +2 after it, the step
    the JAX episode flips at (``it > n_steps / 2``)."""
    assert [trollout.goal_at(it, 6) for it in range(6)] == [-2.0, -2.0, -2.0, -2.0, 2.0, 2.0]
    assert trollout.goal_at(100, 200) == -2.0 and trollout.goal_at(101, 200) == 2.0


@pytest.mark.parametrize(
    "family,carried,env_name,delay",
    [("rnn", False, "oderl-pendulum", 1), ("delta_t_rnn", False, "oderl-pendulum", 1),
     ("node", False, "oderl-pendulum", 1), ("latent_ode", True, "oderl-pendulum", 1),
     ("latent_ode", False, "oderl-pendulum", 1), ("delta_t_rnn", False, "oderl-acrobot", 0),
     ("node", False, "oderl-cartpole", 3), ("latent_ode", True, "oderl-acrobot", 2),
     ("rnn", False, "oderl-pendulum", 0), ("delta_t_rnn", False, "oderl-cartpole", 2)],
    ids=["rnn", "delta_t_rnn", "node", "latent_ode_carried", "latent_ode_tiled", "delta_t_rnn_acrobot_d0",
         "node_cartpole_d3", "latent_ode_carried_acrobot_d2", "rnn_pendulum_d0", "delta_t_rnn_cartpole_d2"])
def test_family_episode_matches_jax_f64(family, carried, env_name, delay):
    """A short seed-batched episode of a baseline family on its tracked
    checkpoint of the cell, on JAX's draws (the latent ODE's fixed z0 draw
    included): every family on pendulum d1, the latent ODE with carried
    history and with the tiled history of its bare apply; then cells of the
    paper's table off pendulum d1 (acrobot's 2-d actions, delays 0, 2, 3).
    Records and returns within rtol 1e-10."""
    (jenv, jcfg, jparams, _), (tenv, tcfg, tparams, _) = build(env_name, delay, "oracle")
    spec = jenv.spec
    ckpt = model_checkpoint_name(family, env_name, delay, "exp", 0, True)
    tw = load_pytree(REPO / "artifacts" / "checkpoints" / ckpt, device="cpu", dtype=torch.float64)
    jw = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tw)
    jm = jax_make_model(family, env_name, spec.n_obs, spec.m, spec.action_high, JConfig(), dtype=jnp.float64)
    if family == "latent_ode":
        tm = make_latent_ode_model(spec.n_obs, spec.m, norm_stats_for(env_name, spec.action_high, spec.m),
                                   dtype=torch.float64, device="cpu",
                                   z0_noise=torch.tensor(fixed_z0_draw(K, spec.n_obs + 2)))
    else:
        tm = torch_make_model(family, env_name, spec.n_obs, spec.m, spec.action_high, TConfig(),
                              dtype=torch.float64, device="cpu")
    if carried:
        jinit, jdyn = jax_carried(jm, jw, DT, spec.n_obs, spec.m)
        tinit, tdyn = make_carried_dynamics(tm, tw, DT, spec.n_obs, spec.m)
    else:
        jinit = tinit = None
        jdyn = jrollout.build_learned_dynamics(jenv, jm.apply, jw, K, DT)
        tdyn = trollout.build_learned_dynamics(tm.apply, tw, DT)
    n_steps = 3 if family == "latent_ode" else N_STEPS
    jset = jrollout.EpisodeSettings(delay=delay, n_steps=n_steps)
    tset = trollout.EpisodeSettings(delay=delay, n_steps=n_steps)
    keys = seed_keys(SEEDS)
    jtot, jrec = jrollout.make_batched_episode_fn(jenv, jdyn, jcfg, jparams, jset,
                                                  dynamics_carry_init=jinit)(jnp.stack(keys))
    ttot, trec = trollout.make_episode_fn(tenv, tdyn, tcfg, tparams, tset, dynamics_carry_init=tinit)(
        JaxDraws(keys, jenv, jcfg, jparams, n_steps))
    np.testing.assert_allclose(ttot.numpy(), np.asarray(jtot), rtol=RTOL)
    assert_records_match(jrec, trec)

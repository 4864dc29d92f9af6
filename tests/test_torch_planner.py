"""Port MPPI planner core (neurallaplacecontrol_tpu_torch.planners) against
the JAX package's planners.mppi_delay at f64, with trained NL dynamics and
the same pre-sampled noise."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.latent_ode import make_carried_dynamics as jax_carried
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import build_learned_dynamics as jax_dynamics
from neurallaplacecontrol_tpu.training.rollout import build_running_cost as jax_cost
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_carried_dynamics, make_latent_ode_model
from neurallaplacecontrol_tpu_torch.planners import mppi_delay as tmppi
from neurallaplacecontrol_tpu_torch.training.rollout import build_learned_dynamics as torch_dynamics
from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost as torch_cost
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name
from jax_planner_cases import jax_command_planner
from jax_replay_draws import fixed_z0_draw

import torch_shard_worker as W

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
K, T, A, DT = 64, 8, 4, 0.05


def planners(env_name, delay, flags):
    """(jax cfg, params, dynamics, cost), (torch ...) for one trained NL checkpoint."""
    encode = flags.get("encode_obs_time", False)
    tparams = load_pytree(
        REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env_name, delay, "exp", 0, True),
        device="cpu", dtype=torch.float64,
    )
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jenv, tenv = jax_make_env(env_name, dt=DT), torch_make_env(env_name, dt=DT)
    spec = jenv.spec
    cfg_kw = dict(num_samples=K, horizon=T, nu=spec.m, u_scale=spec.action_high,
                  u_min=-spec.action_high, u_max=spec.action_high, dt=DT, **flags)
    jmodel = jax_make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high,
                            JConfig(encode_obs_time=encode), dtype=jnp.float64)
    tmodel = torch_make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high,
                              TConfig(encode_obs_time=encode), dtype=torch.float64, device="cpu")
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    tsig = tmppi.make_mppi_params(tmppi.default_noise_sigma(spec.m, 1.0, dtype=torch.float64))
    return (
        (jmppi.MPPIConfig(**cfg_kw), jsig, jax_dynamics(jenv, jmodel.apply, jparams, K, DT), jax_cost(jenv)),
        (tmppi.MPPIConfig(**cfg_kw), tsig, torch_dynamics(tmodel.apply, tparams, DT), torch_cost(tenv)),
        spec,
    )


@pytest.mark.parametrize(
    "env_name,delay,flags",
    [
        ("oderl-cartpole", 1, {}),
        ("oderl-pendulum", 1, {}),
        ("oderl-acrobot", 1, {}),
        ("oderl-pendulum", 0, {"encode_obs_time": True}),  # trained with the age channel
        ("oderl-cartpole", 2, {}),
    ],
    ids=["default", "pendulum", "acrobot", "encode_obs_time", "cartpole_delay2"],
)
def test_mppi_command_core_matches_jax_f64(env_name, delay, flags):
    (jcfg, jsig, jdyn, jcost), (tcfg, tsig, tdyn, tcost), spec = planners(env_name, delay, flags)
    rng = np.random.default_rng(7)
    U = rng.standard_normal((T, spec.m)) * 0.5
    obs = rng.standard_normal(spec.n_obs)
    buffer = rng.uniform(-spec.action_high, spec.action_high, (A, spec.m))
    noise = rng.standard_normal((K, T, spec.m)) @ np.asarray(jsig.noise_chol).T
    ages = np.asarray([0.17, 0.11, 0.04, 0.0]) if flags.get("encode_obs_time") else None

    ja, jU, jaux = jmppi.mppi_command_core(
        jcfg, jsig, jdyn, jcost, jnp.asarray(U), jnp.asarray(obs), jnp.asarray(buffer),
        jnp.asarray(noise), time_buffer=None if ages is None else jnp.asarray(ages),
    )
    ta, tU, taux = tmppi.mppi_command_core(
        tcfg, tsig, tdyn, tcost, torch.tensor(U), torch.tensor(obs), torch.tensor(buffer),
        torch.tensor(noise), time_buffer=None if ages is None else torch.tensor(ages),
    )
    np.testing.assert_allclose(taux["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-9)
    np.testing.assert_allclose(taux["omega"].numpy(), np.asarray(jaux["omega"]), rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("nu", [1, 2])
def test_noise_params_match_jax(nu):
    j = jmppi.make_mppi_params(jmppi.default_noise_sigma(nu, 1.3, dtype=jnp.float64))
    t = tmppi.make_mppi_params(tmppi.default_noise_sigma(nu, 1.3, dtype=torch.float64))
    for field in j._fields:
        np.testing.assert_allclose(getattr(t, field).numpy(), np.asarray(getattr(j, field)), rtol=1e-14)


def test_stack_windows_matches_jax():
    full = np.random.default_rng(0).standard_normal((5, A - 1 + T, 2))
    np.testing.assert_array_equal(
        tmppi._stack_windows(torch.tensor(full), T, A).numpy(),
        np.asarray(jmppi._stack_windows(jnp.asarray(full), T, A)),
    )


def test_reset_and_noise_draw_from_generator():
    cfg = tmppi.MPPIConfig(num_samples=K, horizon=T, nu=2)
    sig = tmppi.make_mppi_params(tmppi.default_noise_sigma(2, 1.0, dtype=torch.float64))
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    np.testing.assert_array_equal(tmppi.mppi_reset(g1, cfg, sig).numpy(), tmppi.mppi_reset(g2, cfg, sig).numpy())
    noise = tmppi._sample_noise(g1, cfg, sig)
    assert noise.shape == (K, T, 2)
    # the draw has the configured covariance Sigma = 0.5 I + 0.5 11^T
    big = tmppi._sample_noise(g1, tmppi.MPPIConfig(num_samples=4096, horizon=T, nu=2), sig)
    cov = np.cov(big.reshape(-1, 2).numpy().T)
    np.testing.assert_allclose(cov, [[1.0, 0.5], [0.5, 1.0]], atol=0.06)


@pytest.mark.parametrize("seeds", [0, 2], ids=["one_plan", "two_seeds"])
def test_mppi_command_core_carried_latent_ode_matches_jax_f64(seeds):
    """The carried planner with the latent ODE's history dynamics on the
    tracked pendulum-d1 checkpoint, against JAX's at f64 on the same noise
    and JAX's fixed z0 draw: one plan, and two seeds against JAX's vmap over
    them (each seed's K rows see the same draw). Within 1e-9."""
    env_name = "oderl-pendulum"
    tparams = load_pytree(
        REPO / "artifacts" / "checkpoints" / model_checkpoint_name("latent_ode", env_name, 1, "exp", 0, True),
        device="cpu", dtype=torch.float64,
    )
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jenv, tenv = jax_make_env(env_name, dt=DT), torch_make_env(env_name, dt=DT)
    spec = jenv.spec
    cfg_kw = dict(num_samples=K, horizon=T, nu=spec.m, u_scale=spec.action_high,
                  u_min=-spec.action_high, u_max=spec.action_high, dt=DT)
    jmodel = jax_make_model("latent_ode", env_name, spec.n_obs, spec.m, spec.action_high, JConfig(),
                            dtype=jnp.float64)
    tmodel = make_latent_ode_model(spec.n_obs, spec.m, norm_stats_for(env_name, spec.action_high, spec.m),
                                   dtype=torch.float64, device="cpu",
                                   z0_noise=torch.tensor(fixed_z0_draw(K, spec.n_obs + 2)))
    jinit, jdyn = jax_carried(jmodel, jparams, DT, spec.n_obs, spec.m)
    tinit, tdyn = make_carried_dynamics(tmodel, tparams, DT, spec.n_obs, spec.m)
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    tsig = tmppi.make_mppi_params(tmppi.default_noise_sigma(spec.m, 1.0, dtype=torch.float64))
    S = max(seeds, 1)
    rng = np.random.default_rng(9)
    U = rng.standard_normal((S, T, spec.m)) * 0.5
    obs = rng.standard_normal((S, spec.n_obs))
    buffer = rng.uniform(-spec.action_high, spec.action_high, (S, A, spec.m))
    noise = rng.standard_normal((S, K, T, spec.m)) @ np.asarray(jsig.noise_chol).T

    def jplan(U_, obs_, buf_, noise_):
        return jmppi.mppi_command_core(jmppi.MPPIConfig(**cfg_kw), jsig, jdyn, jax_cost(jenv), U_, obs_, buf_,
                                       noise_, dynamics_carry_init=jinit)

    args = [U, obs, buffer, noise] if seeds else [U[0], obs[0], buffer[0], noise[0]]
    ja, jU, jaux = jax.jit(jax.vmap(jplan) if seeds else jplan)(*(jnp.asarray(x) for x in args))
    ta, tU, taux = tmppi.mppi_command_core(tmppi.MPPIConfig(**cfg_kw), tsig, tdyn, torch_cost(tenv),
                                           *(torch.tensor(x) for x in args), dynamics_carry_init=tinit)
    np.testing.assert_allclose(taux["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-9)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("case", list(W.COMMAND_CASES))
def test_mppi_command_flags_match_jax_f64(case):
    """Every planner flag in one process, against JAX's ``mppi_command`` on
    the same noise draw (tests/test_mppi.py:130-245 and the cases of
    tests/test_sharding.py:180-279, unsharded): the null action, the
    abs-noise cost, the age channel, M=3 with the variance cost,
    step-dependent dynamics, three commanded actions, the terminal cost and
    carried dynamics."""
    jenv, jcfg, jsig, jdyn, jcost, jextra, key = jax_command_planner(case)
    tenv, tcfg, tsig, tdyn, tcost, textra = W.command_planner(case)
    U = np.random.default_rng(4).standard_normal((tcfg.horizon, 1)) * 0.5
    obs = np.asarray(jenv.observe(jnp.asarray(W.COMMAND_STATE, jnp.float64)))
    buf = np.asarray(W.COMMAND_BUFFER)
    ja, jU, jaux = jmppi.mppi_command(jcfg, jsig, jdyn, jcost, jnp.asarray(U), jnp.asarray(obs), jnp.asarray(buf),
                                      key, **jextra)
    noise = torch.tensor(np.asarray(jmppi._sample_noise(key, jcfg, jsig)))
    ta, tU, taux = tmppi.mppi_command(tcfg, tsig, tdyn, tcost, torch.tensor(U), torch.tensor(obs), torch.tensor(buf),
                                      noise=noise, **textra)
    assert ta.shape == ja.shape
    np.testing.assert_allclose(taux["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-10)
    np.testing.assert_allclose(taux["omega"].numpy(), np.asarray(jaux["omega"]), rtol=1e-9, atol=1e-300)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("flags", [{"sample_null_action": True}, {"noise_abs_cost": True},
                                   {"rollout_samples": 3, "rollout_var_cost": 0.5}, {"u_per_command": 3}],
                         ids=["null_action", "abs_noise", "m_samples", "u_per_command"])
def test_seed_batched_flags_match_jax_vmap(flags):
    """The flags with the port's seed axis against JAX's vmap over the same
    planner, on the tracked cartpole NL checkpoint: the null action is each
    seed's last rollout, the M samples are each seed's own."""
    (jcfg, jsig, jdyn, jcost), (tcfg, tsig, tdyn, tcost), spec = planners("oderl-cartpole", 1, flags)
    rng = np.random.default_rng(11)
    S = 3
    U = rng.standard_normal((S, T, spec.m)) * 0.5
    obs = rng.standard_normal((S, spec.n_obs))
    buffer = rng.uniform(-spec.action_high, spec.action_high, (S, A, spec.m))
    noise = rng.standard_normal((S, K, T, spec.m)) @ np.asarray(jsig.noise_chol).T
    ja, jU, jaux = jax.vmap(lambda *a: jmppi.mppi_command_core(jcfg, jsig, jdyn, jcost, *a))(
        *(jnp.asarray(x) for x in (U, obs, buffer, noise)))
    ta, tU, taux = tmppi.mppi_command_core(tcfg, tsig, tdyn, tcost, *(torch.tensor(x) for x in (U, obs, buffer, noise)))
    np.testing.assert_allclose(taux["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-9)
    np.testing.assert_allclose(tU.numpy(), np.asarray(jU), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)


def scalar_planner(**flags):
    """The analytic planners of tests/test_mppi.py:185-245: K=2, a noise
    covariance of 1e-18 and the state itself as the cost."""
    kw = dict(num_samples=2, nu=1, u_scale=1.0, u_min=-9.0, u_max=9.0, **flags)
    return (jmppi.MPPIConfig(**kw), jmppi.make_mppi_params(jnp.asarray([[1e-18]], dtype=jnp.float64)),
            tmppi.MPPIConfig(**kw), tmppi.make_mppi_params(torch.tensor([[1e-18]], dtype=torch.float64)))


def run_scalar(jcfg, jsig, tcfg, tsig, jdyn, tdyn, **extra):
    key = jax.random.PRNGKey(0)
    zeros = dict(U=np.zeros((jcfg.horizon, 1)), obs=np.zeros(1), buf=np.zeros((4, 1)))
    ja, _, jaux = jmppi.mppi_command(jcfg, jsig, jdyn, lambda s, a: s[:, 0],
                                     *(jnp.asarray(x) for x in zeros.values()), key,
                                     **{k: v[0] for k, v in extra.items()})
    noise = torch.tensor(np.asarray(jmppi._sample_noise(key, jcfg, jsig)))
    ta, _, taux = tmppi.mppi_command(tcfg, tsig, tdyn, lambda s, a: s[:, 0],
                                     *(torch.tensor(x) for x in zeros.values()), noise=noise,
                                     **{k: v[1] for k, v in extra.items()})
    return (ja, jaux), (ta, taux)


def test_rollout_var_cost_penalizes_spread():
    """M=3 slices offset by their index m: the mean cost 6 plus the
    discounted variance 3.5 (tests/test_mppi.py:146-175), as JAX computes it."""
    jcfg, jsig, tcfg, tsig = scalar_planner(horizon=3, rollout_samples=3, rollout_var_cost=1.0,
                                            rollout_var_discount=0.5)

    def jdyn(state, window):
        return state + (jnp.arange(state.shape[0]) // 2)[:, None].astype(state.dtype)

    def tdyn(state, window):
        return state + (torch.arange(state.shape[0]) // 2)[:, None].to(state.dtype)

    (_, jaux), (_, taux) = run_scalar(jcfg, jsig, tcfg, tsig, jdyn, tdyn)
    np.testing.assert_allclose(taux["cost_total"].numpy(), 9.5, atol=1e-9)
    np.testing.assert_allclose(taux["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-12)


@pytest.mark.parametrize("carried", [False, True], ids=["plain", "carried"])
def test_step_dependent_dynamics_and_u_per_command(carried):
    """The horizon index reaches the dynamics, carried or not, and
    u_per_command returns that many leading actions (tests/test_mppi.py:178-226)."""
    jcfg, jsig, tcfg, tsig = scalar_planner(horizon=3 if carried else 4, step_dependent_dynamics=True,
                                            u_per_command=1 if carried else 2)
    if carried:
        extra = {"dynamics_carry_init": (jnp.zeros_like, torch.zeros_like)}

        def jdyn(carry, state, window, t):
            return carry + 1.0, state + t.astype(state.dtype)

        def tdyn(carry, state, window, t):
            return carry + 1.0, state + t
    else:
        extra = {}

        def jdyn(state, window, t):
            return state + t.astype(state.dtype)

        def tdyn(state, window, t):
            return state + t
    (ja, jaux), (ta, taux) = run_scalar(jcfg, jsig, tcfg, tsig, jdyn, tdyn, **extra)
    np.testing.assert_allclose(taux["cost_total"].numpy(), 4.0 if carried else 10.0, atol=1e-9)
    assert ta.shape == ((1,) if carried else (2, 1)) == ja.shape


def test_rollout_samples_deterministic_equivalence():
    """M>1 with deterministic dynamics plans as M=1 (tests/test_mppi.py:130-143)."""
    import dataclasses

    (_, _, _, _), (tcfg, tsig, tdyn, tcost), spec = planners("oderl-pendulum", 1, {})
    g = torch.Generator().manual_seed(2)
    U = tmppi.mppi_reset(g, tcfg, tsig)
    obs, buf = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64), torch.zeros((A, 1), dtype=torch.float64)
    noise = tmppi._sample_noise(g, tcfg, tsig)
    a1, _, aux1 = tmppi.mppi_command(tcfg, tsig, tdyn, tcost, U, obs, buf, noise=noise)
    cfgM = dataclasses.replace(tcfg, rollout_samples=3, rollout_var_cost=10.0)
    aM, _, auxM = tmppi.mppi_command(cfgM, tsig, tdyn, tcost, U, obs, buf, noise=noise)
    np.testing.assert_allclose(aM.numpy(), a1.numpy(), atol=1e-12)
    np.testing.assert_allclose(auxM["cost_total"].numpy(), aux1["cost_total"].numpy(), atol=1e-9)


def test_rollout_states_match_jax():
    """``mppi_rollout_states`` rolls the plan through the dynamics: the
    analytic states of tests/test_mppi.py:229-245, as JAX rolls them."""
    kw = dict(num_samples=4, horizon=3, nu=1, u_scale=2.0, u_min=-9.0, u_max=9.0)
    U = np.asarray([[0.5], [1.0], [-0.5]])
    j = jmppi.mppi_rollout_states(jmppi.MPPIConfig(**kw), lambda s, w: s + w[:, -1, :], jnp.zeros(1),
                                  jnp.asarray(U), jnp.zeros((4, 1)), num_rollouts=2)
    t = tmppi.mppi_rollout_states(tmppi.MPPIConfig(**kw), lambda s, w: s + w[:, -1, :],
                                  torch.zeros(1, dtype=torch.float64), torch.tensor(U),
                                  torch.zeros((4, 1), dtype=torch.float64), num_rollouts=2)
    assert t.shape == (2, 3, 1)
    np.testing.assert_allclose(t[0, :, 0].numpy(), [1.0, 3.0, 2.0], atol=1e-12)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-12)


def test_run_mppi_online_retraining():
    """``run_mppi`` steps the real env, rings (obs, action) and calls the
    retrain callback on the reference's cadence, every retrain_after_iter
    steps but not at step 0 (tests/test_mppi.py:275-334)."""
    from neurallaplacecontrol_tpu_torch.models import make_model

    env = torch_make_env("oderl-pendulum", dt=0.05)
    spec = env.spec
    model = make_model("rnn", "oderl-pendulum", spec.n_obs, spec.m, spec.action_high, TConfig(), device="cpu")
    params0 = model.init(torch.Generator().manual_seed(0))
    cfg = tmppi.MPPIConfig(num_samples=16, horizon=4, nu=spec.m, u_scale=spec.action_high,
                           u_min=-spec.action_high, u_max=spec.action_high)
    mp = tmppi.make_mppi_params(tmppi.default_noise_sigma(spec.m, 1.0))
    calls, built = [], []

    def retrain(dataset, params):
        calls.append(np.array(dataset, copy=True))
        return params

    def make_dynamics(p):
        built.append(p)
        return torch_dynamics(model.apply, p, spec.dt)

    total, dataset = tmppi.run_mppi(env, cfg, mp, make_dynamics, torch_cost(env), params0,
                                    torch.Generator().manual_seed(3), retrain_dynamics=retrain,
                                    retrain_after_iter=10, iters=25, delay=1)
    assert np.isfinite(total) and dataset.shape == (10, spec.n_obs + spec.m)
    assert len(calls) == 2 and len(built) == 3
    for d in calls:
        assert np.isfinite(d).all() and (np.abs(d[:, -spec.m:]) <= spec.action_high + 1e-6).all()

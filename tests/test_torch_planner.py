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
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import build_learned_dynamics as jax_dynamics
from neurallaplacecontrol_tpu.training.rollout import build_running_cost as jax_cost
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.planners import mppi_delay as tmppi
from neurallaplacecontrol_tpu_torch.training.rollout import build_learned_dynamics as torch_dynamics
from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost as torch_cost
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

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


@pytest.mark.parametrize(
    "kwargs,cfg_kw",
    [
        ({"terminal_state_cost": lambda s, a: s.sum()}, {}),
        ({"dynamics_carry_init": lambda s: s}, {}),
        ({"axis": "k"}, {}),
        ({"window_encoder": lambda w: w}, {}),
        ({}, {"rollout_samples": 2}),
        ({}, {"step_dependent_dynamics": True}),
    ],
    ids=["terminal_cost", "carried", "sharded", "window_encoder", "m_samples", "step_dependent"],
)
def test_unported_planner_features_raise(kwargs, cfg_kw):
    cfg = tmppi.MPPIConfig(num_samples=4, horizon=2, nu=1, **cfg_kw)
    sig = tmppi.make_mppi_params(tmppi.default_noise_sigma(1, 1.0))
    with pytest.raises(NotImplementedError):
        tmppi.mppi_command_core(
            cfg, sig, lambda s, w: s, lambda s, a: s.sum(-1), torch.zeros(2, 1), torch.zeros(3),
            torch.zeros(4, 1), torch.zeros(4, 2, 1), **kwargs,
        )

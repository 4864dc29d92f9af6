"""The planner's window encoder (``Config.nl_planner_precompute``) in the port
against the JAX package (tests/test_precompute_planner.py).

MPPI draws every candidate action before the rollout, and the NL window
encoding sees only the actions, so all K x T windows encode in one call
before the horizon loop. The port's encoder and decoder split must be
``apply``'s math, its planner with the encoder the JAX planner's with the
encoder, and ``evaluate_policy`` under the flag the run without it.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay_draws import JaxDraws, seed_keys

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import build_learned_dynamics_encoded as jax_encoded
from neurallaplacecontrol_tpu.training.rollout import build_running_cost as jax_cost
from neurallaplacecontrol_tpu_torch.config import Config
from neurallaplacecontrol_tpu_torch.envs import make_env
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.planners import mppi_delay as tmppi
from neurallaplacecontrol_tpu_torch.training import evaluate_policy
from neurallaplacecontrol_tpu_torch.training.rollout import (
    build_learned_dynamics,
    build_learned_dynamics_encoded,
    build_running_cost,
)
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV = "oderl-cartpole"


def checkpoint(encode_obs_time=False):
    """(env, its tracked NL weights as a numpy tree): cartpole d1, or with the
    age channel the pendulum-d0 checkpoint trained with it."""
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import unflatten_params

    env, delay = ("oderl-pendulum", 0) if encode_obs_time else (ENV, 1)
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env, delay, "exp", 0, True)
    with np.load(path) as z:
        return env, unflatten_params({k: z[k] for k in z.files})


def models(dtype, encode_obs_time=False, dt=0.05):
    """(JAX model, JAX params), (port model, port params), env at ``dtype``,
    the models built for control interval ``dt``."""
    env, tree = checkpoint(encode_obs_time)
    spec = make_env(env).spec
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    dims = (spec.n_obs, spec.m, spec.action_high)
    jm = jax_make_model("nl", env, *dims, JConfig(encode_obs_time=encode_obs_time, dt=dt), dtype=jdt)
    tm = make_model("nl", env, *dims, Config(encode_obs_time=encode_obs_time, dt=dt), dtype=dtype, device="cpu")
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jdt), tree)
    return (jm, jp), (tm, from_jax_params(tree, device="cpu", dtype=dtype)), env


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-6), (torch.float64, 1e-12, 1e-13)],
                         ids=["f32", "f64"])
def test_encoded_apply_matches_apply(dtype, rtol, atol):
    """apply(o, w, ts) == apply_encoded(o, encode(w), ts) on the trained
    checkpoint, the latents follow the windows' dtype, and they are JAX's
    (tests/test_precompute_planner.py:63-116)."""
    (jm, jp), (tm, tp), _ = models(dtype)
    rng = np.random.default_rng(7)
    K, T, A = 13, 6, 4
    windows = rng.uniform(-3, 3, (K, T, A, 1))
    obs = rng.standard_normal((K, 5))
    ts = np.full((K, 1), 0.05)
    t = lambda x: torch.tensor(x, dtype=dtype)  # noqa: E731
    latents = tm.make_planner_window_encoder(tp)(t(windows))
    assert latents.shape == (K, T, 2) and latents.dtype == dtype
    jlat = jm.make_planner_window_encoder(jp)(jnp.asarray(windows, jp["encoder"]["out"]["w"].dtype))
    np.testing.assert_allclose(latents.numpy(), np.asarray(jlat), rtol=10 * rtol, atol=10 * atol)
    for step in (0, 3, T - 1):
        direct = tm.apply(tp, t(obs), t(windows[:, step]), t(ts))
        hoisted = tm.apply_encoded(tp, t(obs), latents[:, step], t(ts))
        np.testing.assert_allclose(hoisted.numpy(), direct.numpy(), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "flags",
    [{}, {"sample_null_action": True}, {"noise_abs_cost": True}, {"rollout_samples": 3, "rollout_var_cost": 0.5},
     {"encode_obs_time": True}],
    ids=["plain", "null_action", "abs_noise", "m_samples", "obs_time"],
)
def test_window_encoder_planner_matches_plain_and_jax(flags):
    """The planning step with the encoder out of the horizon loop equals the
    plain per-step path for every flag (tests/test_precompute_planner.py:
    119-186), and JAX's planner with its encoder at f64 on the same noise.
    The age channel runs on the pendulum-d0 checkpoint trained with it,
    where the JAX test scales an init: untrained weights give outputs whose
    f64 rounding the rollout amplifies past a tight tolerance."""
    encode = flags.get("encode_obs_time", False)
    (jm, jp), (tm, tp), name = models(torch.float64, encode)
    env, jenv = make_env(name), jax_make_env(name)
    K, T, high = 32, 7, env.spec.action_high
    kw = dict(num_samples=K, horizon=T, nu=1, u_scale=high, u_min=-high, u_max=high, dt=0.05, **flags)
    tcfg, jcfg = tmppi.MPPIConfig(**kw), jmppi.MPPIConfig(**kw)
    tsig = tmppi.make_mppi_params(tmppi.default_noise_sigma(1, 1.0, dtype=torch.float64))
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))
    key = jax.random.PRNGKey(11)
    U = np.asarray(jmppi.mppi_reset(key, jcfg, jsig))
    obs = np.asarray(jenv.observe(jenv.reset(jax.random.fold_in(key, 1))), dtype=np.float64)
    buf = 0.3 * np.ones((4, 1))
    tb = np.flip(np.arange(4.0)) * 0.05 if encode else None
    noise = np.asarray(jmppi._sample_noise(key, jcfg, jsig))
    t = lambda x: None if x is None else torch.tensor(np.ascontiguousarray(x))  # noqa: E731
    enc, dyn_enc = build_learned_dynamics_encoded(tm, tp, 0.05)
    dyn_plain = build_learned_dynamics(tm.apply, tp, 0.05)
    cost = build_running_cost(env)
    a0, U0, aux0 = tmppi.mppi_command(tcfg, tsig, dyn_plain, cost, t(U), t(obs), t(buf), noise=t(noise),
                                      time_buffer=t(tb))
    a1, U1, aux1 = tmppi.mppi_command(tcfg, tsig, dyn_enc, cost, t(U), t(obs), t(buf), noise=t(noise),
                                      time_buffer=t(tb), window_encoder=enc)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(U1.numpy(), U0.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(aux1["cost_total"].numpy(), aux0["cost_total"].numpy(), rtol=1e-9)
    jenc, jdyn = jax_encoded(jm, jp, 0.05)
    ja, jU, jaux = jmppi.mppi_command(jcfg, jsig, jdyn, jax_cost(jenv), jnp.asarray(U), jnp.asarray(obs),
                                      jnp.asarray(buf), key, time_buffer=None if tb is None else jnp.asarray(tb),
                                      window_encoder=jenc)
    np.testing.assert_allclose(aux1["cost_total"].numpy(), np.asarray(jaux["cost_total"]), rtol=1e-9)
    np.testing.assert_allclose(U1.numpy(), np.asarray(jU), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(a1.numpy(), np.asarray(ja), rtol=1e-9, atol=1e-12)


def test_evaluate_policy_precompute_flag():
    """``evaluate_policy`` under ``nl_planner_precompute`` returns what it
    returns without, on JAX's replayed draws at f64, which is JAX's
    evaluation at f64 (tests/test_precompute_planner.py:228-247)."""
    from neurallaplacecontrol_tpu.training.eval import evaluate_policy as jax_evaluate

    seeds, K, T, dt = [0, 1], 16, 5, 0.5
    (jm, jp), (tm, tp), _ = models(torch.float64, dt=dt)
    jcfg = jmppi.MPPIConfig(num_samples=K, horizon=T, nu=1)
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))

    def draws():
        return JaxDraws(seed_keys(seeds), jax_make_env(ENV, dt=dt), jcfg, jsig, int(10 / dt))

    kw = dict(model_apply=tm.apply, params=tp, roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    off = evaluate_policy("nl", ENV, 1, seeds, Config(dt=dt), draws=draws(), **kw)
    on = evaluate_policy("nl", ENV, 1, seeds, Config(dt=dt, nl_planner_precompute=True), draws=draws(), **kw)
    np.testing.assert_allclose(on["total_rewards"], off["total_rewards"], rtol=1e-9)
    jkw = dict(model_apply=jm.apply, params=jp, roll_outs=K, time_steps=T)
    j_off = jax_evaluate("nl", ENV, 1, seeds, config=JConfig(dt=dt), **jkw)
    j_on = jax_evaluate("nl", ENV, 1, seeds, config=JConfig(dt=dt, nl_planner_precompute=True), **jkw)
    np.testing.assert_allclose(on["total_rewards"], j_off["total_rewards"], rtol=1e-9)
    # JAX's precompute path rebuilds its model at make_model's default f32
    # (training/eval.py:160-162), so under x64 it parts from its own f64 run
    # by f32 rounding: 6.2e-7 here (ROADMAP queue 3)
    np.testing.assert_allclose(on["total_rewards"], j_on["total_rewards"], rtol=1e-5)

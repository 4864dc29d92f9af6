"""Port serving controller (neurallaplacecontrol_tpu_torch.serving) against
the JAX package's serving.make_controller: ticks fed JAX's own noise draw."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu import serving as jserving
from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import env_step as jax_env_step
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu_torch import serving as tserving
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_latent_ode_model
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name
from jax_replay_draws import fixed_z0_draw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV, DELAY, K, T = "oderl-cartpole", 1, 64, 8


def trained(dtype):
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)
    return load_pytree(path, device="cpu", dtype=dtype)


def torch_controller(cfg=TConfig(), dtype=torch.float64):
    spec_n, spec_m, high = 5, 1, 3.0
    model = torch_make_model("nl", ENV, spec_n, spec_m, high, cfg, dtype=dtype, device="cpu")
    return tserving.make_controller("nl", ENV, DELAY, cfg, model_apply=model.apply,
                                    params=trained(dtype), roll_outs=K, time_steps=T,
                                    dtype=dtype, device="cpu")


def test_controller_ticks_match_jax_on_jax_noise():
    """Five closed-loop ticks at f64: JAX's key split (serving.py:179-180)
    and _sample_noise give the noise both controllers plan with; actions,
    U, the action buffer and the ages match."""
    tparams = trained(torch.float64)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jenv = jax_make_env(ENV)
    spec = jenv.spec
    jmodel = jax_make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, JConfig(), dtype=jnp.float64)
    jctrl = jserving.make_controller("nl", ENV, DELAY, JConfig(), model_apply=jmodel.apply,
                                     params=jparams, roll_outs=K, time_steps=T)
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    tctrl = torch_controller()

    jstate = jctrl.reset(jax.random.PRNGKey(0))
    tstate = tctrl.reset(0)._replace(U=torch.tensor(np.asarray(jstate.U)))
    raw = jnp.asarray([0.1, -0.2, jnp.pi - 0.3, 0.05])
    executed = jnp.zeros(spec.m)
    for _ in range(5):
        obs = jenv.observe(raw)
        _, k_noise = jax.random.split(jstate.key)
        noise = jmppi._sample_noise(k_noise, jctrl.mppi_cfg, jsig)
        jaction, jstate = jctrl.step(jstate, obs)
        taction, tstate = tctrl.step(tstate, torch.tensor(np.asarray(obs)),
                                     noise=torch.tensor(np.asarray(noise)))
        np.testing.assert_allclose(taction.numpy(), np.asarray(jaction), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.U.numpy(), np.asarray(jstate.U), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.action_buffer.numpy(), np.asarray(jstate.action_buffer),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.ages.numpy(), np.asarray(jstate.ages), rtol=1e-12)
        # the plant applies the action one tick late
        raw = jax_env_step(jenv, raw, executed, spec.dt)
        executed = jaction


def test_fused_controller_tracks_unfused_on_cpu():
    """With fused_nl_planner the planner runs the forward kernel's plain
    version on the CPU (f32): same noise, same actions to f32 accuracy."""
    cfg = TConfig()
    ctrl = torch_controller(cfg, torch.float32)
    fused = torch_controller(cfg.replace(fused_nl_planner=True), torch.float32)
    s1, s2 = ctrl.reset(3), fused.reset(3)
    obs = torch.tensor([0.1, -0.2, -0.99, 0.1, 0.3])
    for _ in range(3):
        a1, s1 = ctrl.step(s1, obs)
        a2, s2 = fused.step(s2, obs)
        assert abs(float(a1[0]) - float(a2[0])) < 1e-3
        np.testing.assert_allclose(s2.U.numpy(), s1.U.numpy(), atol=1e-3)


def test_fused_controller_tracks_unfused_at_a_wide_ragged_width():
    """At nl_hidden_units=160 (GRU 80, past the resident kernel's 64), on the
    port's seeded init: the fused planner's first plan gives the unfused
    controller's actions to 1e-3 (f32, the same noise)."""
    cfg = TConfig(nl_hidden_units=160)
    model = torch_make_model("nl", ENV, 5, 1, 3.0, cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ctrls = [tserving.make_controller("nl", ENV, DELAY, c, model_apply=model.apply, params=params, roll_outs=K,
                                      time_steps=T, dtype=torch.float32, device="cpu")
             for c in (cfg, cfg.replace(fused_nl_planner=True))]
    obs = torch.tensor([0.1, -0.2, -0.99, 0.1, 0.3])
    (a1, s1), (a2, s2) = (c.step(c.reset(3), obs) for c in ctrls)
    assert abs(float(a1[0]) - float(a2[0])) < 1e-3
    np.testing.assert_allclose(s2.U.numpy(), s1.U.numpy(), atol=1e-3)


def test_reset_is_seeded():
    ctrl = torch_controller()
    a = ctrl.reset(11)
    b = ctrl.reset(11)
    np.testing.assert_array_equal(a.U.numpy(), b.U.numpy())
    assert a.U.shape == (T, 1) and a.action_buffer.shape == (4, 1)
    np.testing.assert_allclose(a.ages.numpy(), [0.15, 0.1, 0.05, 0.0])
    obs = torch.zeros(5)
    act_a, _ = ctrl.step(ctrl.reset(2), obs)
    act_b, _ = ctrl.step(ctrl.reset(2), obs)
    assert torch.equal(act_a, act_b)


def test_make_controller_rejects_what_is_not_ported():
    """``latent_ode_ref`` (refused before its port) serves: a controller on
    its model ticks finite, in-range actions; the random policy, a learned
    family without weights and a non-f32 fused planner stay refused."""
    model = torch_make_model("latent_ode_ref", ENV, 5, 1, 3.0, TConfig(), device="cpu")
    ctrl = tserving.make_controller("latent_ode_ref", ENV, DELAY, model_apply=model.apply,
                                    params=model.init(torch.Generator().manual_seed(0)), roll_outs=K,
                                    time_steps=T, device="cpu")
    action, _ = ctrl.step(ctrl.reset(0), torch.zeros(5))
    assert bool(torch.isfinite(action).all()) and float(action.abs().max()) <= 3.0
    with pytest.raises(ValueError):
        tserving.make_controller("latent_ode_ref", ENV, DELAY, device="cpu")
    with pytest.raises(ValueError):
        tserving.make_controller("random", ENV, DELAY, device="cpu")
    with pytest.raises(ValueError):
        tserving.make_controller("nl", ENV, DELAY, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        torch_controller(TConfig(fused_nl_planner=True), torch.float64)


@pytest.mark.parametrize("model_name", ["oracle", "rnn", "delta_t_rnn", "node", "latent_ode"])
def test_controllers_match_jax_on_jax_noise(model_name):
    """The oracle's and each baseline family's controller (tracked pendulum-d1
    checkpoints; the latent ODE handed in whole, so with carried history, and
    JAX's fixed z0 draw) against JAX's on JAX's noise: three closed-loop
    ticks at f64, actions and U within rtol 1e-9."""
    env_name = "oderl-pendulum"
    jenv = jax_make_env(env_name)
    spec = jenv.spec
    jparams = tparams = jmodel = tmodel = None
    japply = tapply = None
    if model_name != "oracle":
        path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name(model_name, env_name, DELAY, "exp", 0, True)
        tparams = load_pytree(path, device="cpu", dtype=torch.float64)
        jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
        jmodel = jax_make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, JConfig(),
                                dtype=jnp.float64)
        if model_name == "latent_ode":
            tmodel = make_latent_ode_model(spec.n_obs, spec.m, norm_stats_for(env_name, spec.action_high, spec.m),
                                           dtype=torch.float64, device="cpu",
                                           z0_noise=torch.tensor(fixed_z0_draw(K, spec.n_obs + 2)))
            japply, tapply = jmodel, tmodel
        else:
            tmodel = torch_make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, TConfig(),
                                      dtype=torch.float64, device="cpu")
            japply, tapply = jmodel.apply, tmodel.apply
    jctrl = jserving.make_controller(model_name, env_name, DELAY, JConfig(), model_apply=japply,
                                     params=jparams, roll_outs=K, time_steps=T)
    tctrl = tserving.make_controller(model_name, env_name, DELAY, TConfig(), model_apply=tapply,
                                     params=tparams, roll_outs=K, time_steps=T, dtype=torch.float64,
                                     device="cpu")
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    jstate = jctrl.reset(jax.random.PRNGKey(1))
    tstate = tctrl.reset(0)._replace(U=torch.tensor(np.asarray(jstate.U)))
    raw = jnp.asarray([jnp.pi - 0.4, 0.7])
    executed = jnp.zeros(spec.m)
    for _ in range(3):
        obs = jenv.observe(raw)
        _, k_noise = jax.random.split(jstate.key)
        noise = jmppi._sample_noise(k_noise, jctrl.mppi_cfg, jsig)
        jaction, jstate = jctrl.step(jstate, obs)
        taction, tstate = tctrl.step(tstate, torch.tensor(np.asarray(obs)), noise=torch.tensor(np.asarray(noise)))
        np.testing.assert_allclose(taction.numpy(), np.asarray(jaction), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.U.numpy(), np.asarray(jstate.U), rtol=1e-9, atol=1e-12)
        raw = jax_env_step(jenv, raw, executed, spec.dt)
        executed = jaction

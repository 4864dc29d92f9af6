"""The port's ``latent_ode_ref`` (the reference-layout latent ODE into which
reference ``.pt`` checkpoints transplant) against the JAX package's at f64:
the encoder's substep plan, the forward and its gradient on the tracked
reference checkpoint and on JAX's init, the serving controller on JAX's
noise, and the exported step against the controller's."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu import interop as jinterop
from neurallaplacecontrol_tpu import serving as jserving
from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import env_step as jax_env_step
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.latent_ode_ref import _encoder_substep_plan as jax_plan
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu_torch import interop as tinterop
from neurallaplacecontrol_tpu_torch import serving as tserving
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.models.latent_ode_ref import _FIRST_GAP, _encoder_substep_plan
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
REF_PT = REPO / "artifacts" / "baseline_parity" / "ref_latent_ode_cartpole_d1_r4.pt"
F64_TOL = 1e-10  # relative, |got - exp| / (1 + |exp|)


def rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (1.0 + np.abs(exp))).max())


def models(env, cfg_kw=None, source="pt"):
    """(JAX model, JAX params, port model, port params) at f64: the tracked
    reference checkpoint through each package's interop (cartpole), or JAX's
    init from PRNGKey(0) carried across."""
    n, m, high = {"oderl-cartpole": (5, 1, 3.0), "oderl-pendulum": (3, 1, 2.0)}[env]
    cfg_kw = cfg_kw or {}
    jm = jax_make_model("latent_ode_ref", env, n, m, high, JConfig(**cfg_kw), dtype=jnp.float64)
    tm = torch_make_model("latent_ode_ref", env, n, m, high, TConfig(**cfg_kw), dtype=torch.float64,
                          device="cpu")
    if source == "pt":
        jp = jinterop.latent_ode_params_from_state_dict(jinterop.load_torch_state_dict(str(REF_PT)))
        tp = tinterop.latent_ode_params_from_state_dict(tinterop.load_torch_state_dict(str(REF_PT)),
                                                        device="cpu")
    else:
        jp = jm.init(jax.random.PRNGKey(0))
        tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def inputs(n, m, high, B=33, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, n)) * 2.0
    abuf = rng.uniform(-high, high, (B, 4, m))
    ts = rng.exponential(0.05, (B, 1))
    return obs, abuf, ts


@pytest.mark.parametrize("A", [1, 2, 4, 6])
@pytest.mark.parametrize("dt", [0.05, 0.1])
def test_substep_plan_matches_jax(A, dt):
    """The host-side Euler plan (Python floats) equals JAX's entry for entry;
    a one-observation grid takes one step of -0.01."""
    times = np.arange(-(A - 1), 1, dtype=np.float64) * dt
    assert _encoder_substep_plan(times) == jax_plan(times)
    if A == 1:
        assert _encoder_substep_plan(times) == [(0, [-_FIRST_GAP])]


@pytest.mark.parametrize("env,cfg_kw,source", [
    ("oderl-cartpole", None, "pt"), ("oderl-pendulum", None, "init"),
    ("oderl-pendulum", {"normalize": False}, "init"), ("oderl-pendulum", {"action_buffer_size": 2}, "init")],
    ids=["reference_pt", "jax_init", "unnormalized", "buffer2"])
def test_forward_matches_jax_f64(env, cfg_kw, source):
    """``apply``, ``encode_z0`` and ``predict_diff`` at f64 within 1e-10
    relative (F64_TOL); ``ts`` plays no role in either package."""
    jm, jp, tm, tp = models(env, cfg_kw, source)
    n, m = tm.state_dim, tm.action_dim
    A = (cfg_kw or {}).get("action_buffer_size", 4)
    obs, abuf, ts = inputs(n, m, 3.0)
    abuf = abuf[:, :A]
    got = tm.apply(tp, *(torch.tensor(x) for x in (obs, abuf, ts))).numpy()
    exp = np.asarray(jm.apply(jp, obs, abuf, ts))
    assert got.shape == (33, n) and rel(got, exp) < F64_TOL
    np.testing.assert_array_equal(tm.apply(tp, *(torch.tensor(x) for x in (obs, abuf, ts * 10.0))).numpy(), got)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, A, n + m))
    for g, e in zip(tm.encode_z0(tp, torch.tensor(x)), jm.encode_z0(jp, x)):
        assert rel(g.numpy(), e) < F64_TOL
    hist = rng.standard_normal((9, A, n))
    acts = rng.uniform(-3.0, 3.0, (9, A, m))
    assert rel(tm.predict_diff(tp, torch.tensor(hist), torch.tensor(acts)).numpy(),
               jm.predict_diff(jp, hist, acts)) < F64_TOL


def test_gradient_matches_jax_f64():
    """The MSE loss's gradient on the reference checkpoint, every leaf within
    1e-9 relative of jax.grad's; the gen-ODE net, never evaluated, gets zero
    gradients in both."""
    jm, jp, tm, tp = models("oderl-cartpole")
    obs, abuf, ts = inputs(5, 1, 3.0, B=16, seed=2)
    target = np.random.default_rng(3).standard_normal((16, 5)) * 0.1

    def jloss(p):
        return jnp.mean((jm.apply(p, obs, abuf, ts) - target) ** 2)

    jg = jax.grad(jloss)(jp)
    leaves = [x.clone().requires_grad_(True) for x in tree_leaves(tp)]
    loss = torch.mean((tm.apply(tree_unflatten(tp, leaves), *(torch.tensor(x) for x in (obs, abuf, ts)))
                       - torch.tensor(target)) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
    g_tree = tree_unflatten(tp, list(grads))
    for g, e in zip(tree_leaves(g_tree), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, {k: jg[k] for k in sorted(jg)}))):
        np.testing.assert_allclose(g.numpy(), e, rtol=1e-9, atol=1e-14)
    assert all(float(x.abs().max()) == 0.0 for x in tree_leaves(g_tree["gen_ode"]))


def test_controller_matches_jax_on_jax_noise():
    """The reference checkpoint's controller against JAX's on JAX's noise:
    three closed-loop ticks at f64, actions and U within rtol 1e-9."""
    K, T, delay = 32, 6, 1
    jm, jp, tm, tp = models("oderl-cartpole")
    jenv = jax_make_env("oderl-cartpole")
    spec = jenv.spec
    jctrl = jserving.make_controller("latent_ode_ref", "oderl-cartpole", delay, JConfig(), model_apply=jm.apply,
                                     params=jp, roll_outs=K, time_steps=T)
    tctrl = tserving.make_controller("latent_ode_ref", "oderl-cartpole", delay, TConfig(), model_apply=tm.apply,
                                     params=tp, roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(spec.m, 1.0, dtype=jnp.float64))
    jstate = jctrl.reset(jax.random.PRNGKey(2))
    tstate = tctrl.reset(0)._replace(U=torch.tensor(np.asarray(jstate.U)))
    raw = jnp.asarray([0.1, 0.0, jnp.pi - 0.3, 0.4])
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


def test_exported_step_equals_controller_step(tmp_path):
    """``export_controller`` traces the reference-layout planner (its Euler
    plan unrolled as constants) and the loaded step equals
    ``Controller.step`` bit for bit on one noise."""
    K, T = 16, 3
    tm = torch_make_model("latent_ode_ref", "oderl-cartpole", 5, 1, 3.0, TConfig(), device="cpu")
    tp = tinterop.latent_ode_params_from_state_dict(tinterop.load_torch_state_dict(str(REF_PT)), device="cpu",
                                                    dtype=torch.float32)
    ctrl = tserving.make_controller("latent_ode_ref", "oderl-cartpole", 1, TConfig(), model_apply=tm.apply,
                                    params=tp, roll_outs=K, time_steps=T, device="cpu")
    path = tmp_path / "lor.pt2"
    tserving.export_controller(ctrl, str(path))
    step = tserving.load_controller_step(str(path))
    state = ctrl.reset(3)
    obs = torch.tensor([0.1, 0.2, -0.9, 0.3, 0.5])
    noise = torch.randn((K, T, 1), generator=torch.Generator().manual_seed(4))
    action, nxt = ctrl.step(state, obs, noise=noise)
    got_action, got_state = step(state, obs, noise=noise)
    assert torch.equal(got_action, action) and torch.equal(got_state.U, nxt.U)

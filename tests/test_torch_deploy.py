"""Deployment of the port's controller (neurallaplacecontrol_tpu_torch.serving):
the exported step against ``Controller.step`` and against the JAX package's
controller, the artifact loaded without model code, and the compile cache.

The exported step and ``Controller.step`` run the same operations on the same
tensors, so they are held equal bit for bit; against JAX at f64 the tolerance
is ``test_torch_serving.py``'s (rtol 1e-9, atol 1e-12).
"""

import io
import json
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay_draws import fixed_z0_draw

from neurallaplacecontrol_tpu import serving as jserving
from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu_torch import serving
from neurallaplacecontrol_tpu_torch.config import Config
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_latent_ode_model
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, tracked_checkpoint_path

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def weights(family, env_name, dtype):
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import model_checkpoint_name

    return load_pytree(tracked_checkpoint_path(model_checkpoint_name(family, env_name, 1, "exp", 0, True)),
                       device="cpu", dtype=dtype)


def controller(case):
    """(controller, n_obs) of a deployment case, on the CPU at small sizes."""
    if case == "oracle":
        return serving.make_controller("oracle", "oderl-pendulum", 1, Config(), roll_outs=8, time_steps=3,
                                       dtype=torch.float64, device="cpu"), 3
    if case == "latent_ode_carried":
        env = "oderl-pendulum"
        model = make_latent_ode_model(3, 1, norm_stats_for(env, 2.0, 1), device="cpu", dtype=torch.float64,
                                      z0_noise=torch.tensor(fixed_z0_draw(4, 5)))
        return serving.make_controller("latent_ode", env, 1, Config(), model_apply=model,
                                       params=weights("latent_ode", env, torch.float64), roll_outs=4,
                                       time_steps=2, dtype=torch.float64, device="cpu"), 3
    cfg = {"nl_plain": Config(), "nl_fused": Config(fused_nl_planner=True),
           "nl_window_encoder": Config(nl_planner_precompute=True)}[case]
    dtype = torch.float32 if case == "nl_fused" else torch.float64
    model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, cfg, dtype=dtype, device="cpu")
    return serving.make_controller("nl", "oderl-cartpole", 1, cfg, model_apply=model.apply,
                                   params=weights("nl", "oderl-cartpole", dtype), roll_outs=8, time_steps=3,
                                   dtype=dtype, device="cpu"), 5


def ticks(step, state, n_obs, dtype, K, T, n=3, seed=1):
    """``n`` ticks of ``step`` on seeded observations and noise; the actions and states."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        obs = torch.randn(n_obs, generator=g, dtype=dtype)
        noise = torch.randn((K, T, 1), generator=g, dtype=dtype)
        action, state = step(state, obs, noise=noise)
        out.append((action, state))
    return out


@pytest.mark.parametrize("case", ["oracle", "nl_plain", "nl_fused", "latent_ode_carried", "nl_window_encoder"])
def test_exported_step_equals_controller_step(case, tmp_path):
    """Three ticks of the loaded artifact equal ``Controller.step``'s bit for
    bit (action, U, action buffer, ages); the controller ticks on as before
    after its export."""
    ctrl, n_obs = controller(case)
    path = tmp_path / "controller.pt2"
    blob = serving.export_controller(ctrl, path=str(path))
    assert path.read_bytes() == blob
    step = serving.load_controller_step(path)
    cfg = ctrl.mppi_cfg
    state = ctrl.reset(0)
    exp = ticks(ctrl.step, state, n_obs, ctrl.dtype, cfg.num_samples, cfg.horizon)
    got = ticks(step, state, n_obs, ctrl.dtype, cfg.num_samples, cfg.horizon)
    for (a1, s1), (a2, s2) in zip(exp, got):
        assert torch.equal(a1, a2)
        for x, y in zip(s1, s2):
            assert torch.equal(x, y)
    assert step.meta["model_name"] == ctrl.model_name and step.meta["num_samples"] == cfg.num_samples


def test_exported_program_holds_weights_as_buffers_and_the_kernel_as_a_node():
    """The fused NL artifact: the repacked weights and the model's are buffers
    of the program, no weight is a lifted constant, and the horizon's T
    forwards are T calls of ``nlc::nl_forward``."""
    ctrl, _ = controller("nl_fused")
    program = torch.export.load(io.BytesIO(serving.export_controller(ctrl)))
    sizes = sorted(v.numel() for v in program.state_dict.values())
    dyn = ctrl.dynamics
    fused_apply = dict(zip(dyn.__code__.co_freevars, (c.cell_contents for c in dyn.__closure__)))["model_apply"]
    assert sizes[-1] == fused_apply.hopper.numel()
    assert all(v.numel() <= 1 for v in program.constants.values())
    calls = [n for n in program.graph.nodes if n.op == "call_function" and "nlc.nl_forward" in str(n.target)]
    assert len(calls) == ctrl.mppi_cfg.horizon


def test_loaded_step_draws_its_own_noise():
    """Without ``noise`` the loaded step draws from its own generator, seeded
    by ``seed``: the same seed gives the same ticks, another seed others."""
    ctrl, _ = controller("oracle")
    blob = serving.export_controller(ctrl)
    obs = torch.tensor([0.1, -0.99, 0.3], dtype=torch.float64)
    a = [serving.load_controller_step(blob, seed=s)(ctrl.reset(0), obs)[0] for s in (3, 3, 4)]
    assert torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])


def test_exported_step_matches_jax_on_jax_noise():
    """The exported NL step (f64, tracked cartpole-d1 checkpoint) against the
    JAX package's ``serving.make_controller`` step over three closed-loop
    ticks, both planning on JAX's noise draw."""
    K, T, env_name = 16, 4, "oderl-cartpole"
    tparams = weights("nl", env_name, torch.float64)
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)
    jenv = jax_make_env(env_name)
    jmodel = jax_make_model("nl", env_name, 5, 1, 3.0, JConfig(), dtype=jnp.float64)
    jctrl = jserving.make_controller("nl", env_name, 1, JConfig(), model_apply=jmodel.apply, params=jparams,
                                     roll_outs=K, time_steps=T)
    jsig = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))
    tmodel = make_model("nl", env_name, 5, 1, 3.0, Config(), dtype=torch.float64, device="cpu")
    tctrl = serving.make_controller("nl", env_name, 1, Config(), model_apply=tmodel.apply, params=tparams,
                                    roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    step = serving.load_controller_step(serving.export_controller(tctrl))
    jstate = jctrl.reset(jax.random.PRNGKey(0))
    tstate = tctrl.reset(0)._replace(U=torch.tensor(np.asarray(jstate.U)))
    raw = jnp.asarray([0.1, -0.2, jnp.pi - 0.3, 0.05])
    for _ in range(3):
        obs = jenv.observe(raw)
        _, k_noise = jax.random.split(jstate.key)
        noise = jmppi._sample_noise(k_noise, jctrl.mppi_cfg, jsig)
        jaction, jstate = jctrl.step(jstate, obs)
        taction, tstate = step(tstate, torch.tensor(np.asarray(obs)), noise=torch.tensor(np.asarray(noise)))
        np.testing.assert_allclose(taction.numpy(), np.asarray(jaction), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.U.numpy(), np.asarray(jstate.U), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.action_buffer.numpy(), np.asarray(jstate.action_buffer),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tstate.ages.numpy(), np.asarray(jstate.ages), rtol=1e-12)
        raw = raw + 0.05 * jenv.rhs(raw, jstate.action_buffer[-2])


def test_artifact_loads_without_model_code(tmp_path):
    """A process that imports the serving module alone loads the fused NL
    artifact and ticks it to the exporting process's action, with no module
    of the port's models, training or envs imported."""
    ctrl, _ = controller("nl_fused")
    path = tmp_path / "c.pt2"
    serving.export_controller(ctrl, path=str(path))
    obs = torch.tensor([0.1, -0.2, -0.99, 0.1, 0.3])
    noise = torch.randn((8, 3, 1), generator=torch.Generator().manual_seed(5))
    torch.save({"obs": obs, "noise": noise}, tmp_path / "in.pt")
    code = textwrap.dedent(f"""
        import sys, torch
        from neurallaplacecontrol_tpu_torch.serving import ControllerState, load_controller_step
        x = torch.load({str(tmp_path / "in.pt")!r})
        step = load_controller_step({str(path)!r})
        m = step.meta
        state = ControllerState(torch.zeros(m["horizon"], 1), torch.zeros(m["action_buffer_size"], 1),
                                torch.flip(torch.arange(m["action_buffer_size"], dtype=torch.float32), (0,)) * m["dt"])
        action, _ = step(state, x["obs"], noise=x["noise"])
        bad = [n for n in sys.modules if n.split(".")[:2] in (
            ["neurallaplacecontrol_tpu_torch", p] for p in ("models", "training", "envs"))]
        assert not bad, bad
        print(repr(float(action[0])))
        """)
    state0 = ctrl.reset(0)
    exp, _ = ctrl.step(state0._replace(U=torch.zeros_like(state0.U)), obs, noise=noise)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert float(out.stdout.strip().splitlines()[-1]) == float(exp[0])


def test_load_refuses_a_cuda_artifact_without_cuda(monkeypatch):
    """An artifact made for CUDA raises where there is no CUDA; it is not moved to the CPU."""
    ctrl, _ = controller("oracle")
    blob = serving.export_controller(ctrl)
    src, dst = zipfile.ZipFile(io.BytesIO(blob)), io.BytesIO()
    with zipfile.ZipFile(dst, "w") as out:
        for item in src.infolist():
            data = src.read(item.filename)
            if item.filename.endswith("controller.json"):
                data = json.dumps(dict(json.loads(data), device="cuda:0")).encode()
            out.writestr(item, data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_controller_step(dst.getvalue())


def test_export_refuses_a_step_it_cannot_trace():
    """A step with a data-dependent branch raises NotImplementedError naming
    the family; nothing else is exported in its place."""
    ctrl, _ = controller("oracle")
    dynamics = ctrl.dynamics

    def branching(state, window):
        return dynamics(state, window) if float(state.sum()) > 0 else state

    ctrl.dynamics = branching
    with pytest.raises(NotImplementedError, match="'oracle' controller's step cannot be exported"):
        serving.export_controller(ctrl)


def test_persistent_compile_cache_builds_there_once(tmp_path):
    """Two processes on one fresh cache directory: the first builds the
    replay-buffer and tick-log libraries there with g++, the second finds
    them and runs no compiler; the kernel build directory moves too."""
    cache = tmp_path / "cache"
    code = textwrap.dedent(f"""
        from neurallaplacecontrol_tpu_torch import runtime, serving
        from neurallaplacecontrol_tpu_torch.ops import nl_cuda
        from neurallaplacecontrol_tpu_torch.runtime import _native, ticklog
        d = serving.persistent_compile_cache({str(cache)!r})
        runtime.get_lib()
        ticklog.get_lib()
        print(d, _native.compiles, nl_cuda.BUILD_DIR)
        """)
    runs = [subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
            for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-3000:]
    (d1, n1, k1), (d2, n2, k2) = (r.stdout.split() for r in runs)
    assert d1 == d2 == str(cache) and k1 == str(cache / "nl_kernels")
    assert (int(n1), int(n2)) == (2, 0)
    assert sorted(p.name for p in cache.glob("runtime/*/*/*.so")) == ["libreplaybuf.so", "libticklog.so"]

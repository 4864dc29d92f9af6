"""The port's ``training.eval.evaluate_policy`` and ``results.process``
against the JAX package's on the CPU at f64.

``evaluate_policy`` runs at ``Config(dt=0.5)``, so an episode is 20 steps,
with K=16 rollouts over a T=5 horizon and the JAX draws replayed
(tests/jax_replay_draws.py). Every field of the result dict but the timings
must equal JAX's: returns at rtol 1e-10, the rest exactly.
"""

import json
import sys
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
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.results import process as jprocess
from neurallaplacecontrol_tpu.training.eval import evaluate_policy as jax_evaluate
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_latent_ode_model
from neurallaplacecontrol_tpu_torch.results import process as tprocess
from neurallaplacecontrol_tpu_torch.training import eval as teval
from neurallaplacecontrol_tpu_torch.training import rollout as trollout
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV, DELAY, K, T, DT = "oderl-cartpole", 1, 16, 5, 0.5
N_STEPS = int(10.0 / DT)
SEEDS = [0, 5, 9]
TIMINGS = ("episode_elapsed_time", "episode_elapsed_time_per_it", "mppi_rollouts_per_sec")


def nl_models():
    ckpt = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)
    tweights = load_pytree(ckpt, device="cpu", dtype=torch.float64)
    jweights = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tweights)
    jm = jax_make_model("nl", ENV, 5, 1, 3.0, JConfig(dt=DT), dtype=jnp.float64)
    tm = torch_make_model("nl", ENV, 5, 1, 3.0, TConfig(dt=DT), dtype=torch.float64, device="cpu")
    return (jm.apply, jweights), (tm.apply, tweights)


def replay(seeds):
    jenv = jax_make_env(ENV, dt=DT)
    jcfg = jmppi.MPPIConfig(num_samples=K, horizon=T, nu=1)
    jparams = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))
    return JaxDraws(seed_keys(seeds), jenv, jcfg, jparams, N_STEPS)


def run_both(model_name, **kw):
    (japply, jweights), (tapply, tweights) = nl_models()
    j = jax_evaluate(model_name, ENV, DELAY, SEEDS, config=JConfig(dt=DT), model_apply=japply,
                     params=jweights, roll_outs=K, time_steps=T, **kw)
    t = teval.evaluate_policy(model_name, ENV, DELAY, SEEDS, config=TConfig(dt=DT), model_apply=tapply,
                              params=tweights, roll_outs=K, time_steps=T, dtype=torch.float64,
                              device="cpu", draws=replay(SEEDS), **kw)
    return j, t


@pytest.mark.parametrize("model_name,kw", [("nl", {}), ("oracle", {}), ("random", {}),
                                           ("nl", {"change_goal": True}), ("oracle", {"change_goal": True})],
                         ids=["nl", "oracle", "random", "nl_change_goal", "oracle_change_goal"])
def test_evaluate_policy_matches_jax_f64(model_name, kw):
    j, t = run_both(model_name, **kw)
    assert set(t) == set(j)
    for field in j:
        if field in TIMINGS:
            assert t[field] > 0
        elif field in ("total_rewards", "total_reward", "total_reward_std"):
            np.testing.assert_allclose(t[field], j[field], rtol=1e-10, err_msg=field)
        else:
            assert t[field] == j[field], field


def test_evaluate_policy_rescales_to_200_steps():
    """total_rewards are the raw episode returns times 200/n_steps (eval.py:300)."""
    (_, _), (tapply, tweights) = nl_models()
    t = teval.evaluate_policy("oracle", ENV, DELAY, SEEDS, config=TConfig(dt=DT), roll_outs=K,
                              time_steps=T, dtype=torch.float64, device="cpu", draws=replay(SEEDS))
    env, cfg, params, dyn, _, _ = teval.build_planner("oracle", ENV, DELAY, TConfig(dt=DT), roll_outs=K,
                                                time_steps=T, dtype=torch.float64, device="cpu")
    raw, _ = trollout.make_episode_fn(env, dyn, cfg, params,
                                      trollout.EpisodeSettings(delay=DELAY, n_steps=N_STEPS))(replay(SEEDS))
    np.testing.assert_allclose(t["total_rewards"], raw.numpy() * 200.0 / N_STEPS, rtol=1e-12)
    np.testing.assert_allclose(t["total_reward"], np.mean(t["total_rewards"]), rtol=1e-12)
    np.testing.assert_allclose(t["total_reward_std"], np.std(t["total_rewards"]), rtol=1e-12)


def test_evaluate_policy_seeds_are_reproducible():
    """Without replayed draws each seed draws from its own generator: the
    same seed gives the same return, whatever seeds run beside it."""
    kw = dict(config=TConfig(dt=DT), roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    a = teval.evaluate_policy("oracle", ENV, DELAY, [4, 8], **kw)
    b = teval.evaluate_policy("oracle", ENV, DELAY, [8], **kw)
    np.testing.assert_allclose(a["total_rewards"][1], b["total_rewards"][0], rtol=1e-10)
    assert a["total_rewards"][0] != a["total_rewards"][1]


@pytest.mark.parametrize("kwargs", [{"save_video": True}, {"change_goal": True}], ids=["video", "change_goal"])
def test_evaluate_policy_unported_flags_raise(kwargs, monkeypatch):
    """Both flags are ported; they raise where they cannot be met: video
    without matplotlib (the GPU machine has none), before any episode runs,
    and change_goal on an env whose reward has no goal."""
    env_name, exc = ENV, ValueError
    if "save_video" in kwargs:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        exc = ImportError
    else:
        env_name = "oderl-pendulum"
    with pytest.raises(exc, match="matplotlib" if exc is ImportError else "change_goal needs cartpole"):
        teval.evaluate_policy("oracle", env_name, DELAY, [0], config=TConfig(dt=DT), roll_outs=K,
                              time_steps=T, device="cpu", **kwargs)


def test_evaluate_policy_writes_the_first_seeds_video(tmp_path):
    """``save_video`` writes the first seed's episode as a gif of one frame
    a step, each the JAX renderer's frame of that step's state and executed
    action, and leaves the returns as they are."""
    import imageio

    from neurallaplacecontrol_tpu.envs.render import render_frame as jax_render

    kw = dict(roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    cfg = TConfig(dt=DT, log_folder=str(tmp_path / "logs"))
    plain = teval.evaluate_policy("oracle", ENV, DELAY, SEEDS[:2], config=cfg, draws=replay(SEEDS[:2]), **kw)
    filmed = teval.evaluate_policy("oracle", ENV, DELAY, SEEDS[:2], config=cfg.replace(save_video=True),
                                   draws=replay(SEEDS[:2]), **kw)
    assert filmed["total_rewards"] == plain["total_rewards"] and plain["video_path"] is None
    assert filmed["video_path"] == f"{cfg.log_folder}/oracle_{ENV}_d{DELAY}.gif"
    frames = imageio.mimread(filmed["video_path"])
    assert len(frames) == N_STEPS
    env, mcfg, params, dyn, _, _ = teval.build_planner("oracle", ENV, DELAY, cfg, roll_outs=K, time_steps=T,
                                                     dtype=torch.float64, device="cpu")
    _, rec = trollout.make_episode_fn(env, dyn, mcfg, params,
                                      trollout.EpisodeSettings(delay=DELAY, n_steps=N_STEPS))(replay(SEEDS[:2]))
    raw = env.obs_to_state(rec.s0[0, 0]).numpy()
    exp = jax_render(ENV, raw, last_act=rec.a0[0, 0, -(DELAY + 1)].numpy())
    np.testing.assert_array_equal(np.asarray(frames[0])[..., :3], exp)


def test_evaluate_policy_writes_profile_trace(tmp_path):
    """``profile_trace_dir`` writes one Chrome trace of the timed episode
    (``utils.timing.profile_trace``) and leaves the returns as they are."""
    kw = dict(config=TConfig(dt=DT), roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu")
    plain = teval.evaluate_policy("oracle", ENV, DELAY, SEEDS[:2], **kw)
    traced = teval.evaluate_policy("oracle", ENV, DELAY, SEEDS[:2], profile_trace_dir=str(tmp_path / "t"), **kw)
    assert traced["total_rewards"] == plain["total_rewards"]
    files = list((tmp_path / "t").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


@pytest.mark.parametrize("model_name,cfg", [("latent_ode_ref", TConfig())])
def test_evaluate_policy_unported_models_raise(model_name, cfg):
    """``latent_ode_ref`` (refused before its port) evaluates through the
    generic learned path: the tracked reference checkpoint, imported by each
    package's interop, against JAX's ``evaluate_policy`` at f64 on JAX's
    draws, returns within rtol 1e-10 and every other field but the timings
    equal."""
    from neurallaplacecontrol_tpu import interop as jinterop
    from neurallaplacecontrol_tpu_torch import interop as tinterop

    pt = str(REPO / "artifacts" / "baseline_parity" / "ref_latent_ode_cartpole_d1_r4.pt")
    jm = jax_make_model(model_name, ENV, 5, 1, 3.0, JConfig(dt=DT), dtype=jnp.float64)
    tm = torch_make_model(model_name, ENV, 5, 1, 3.0, cfg.replace(dt=DT), dtype=torch.float64, device="cpu")
    jweights = jinterop.latent_ode_params_from_state_dict(jinterop.load_torch_state_dict(pt))
    tweights = tinterop.latent_ode_params_from_state_dict(tinterop.load_torch_state_dict(pt), device="cpu")
    seeds = SEEDS[:2]
    j = jax_evaluate(model_name, ENV, DELAY, seeds, config=JConfig(dt=DT), model_apply=jm.apply,
                     params=jweights, roll_outs=K, time_steps=T)
    t = teval.evaluate_policy(model_name, ENV, DELAY, seeds, config=cfg.replace(dt=DT), model_apply=tm.apply,
                              params=tweights, roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu",
                              draws=replay(seeds))
    assert set(t) == set(j)
    np.testing.assert_allclose(t["total_rewards"], j["total_rewards"], rtol=1e-10)
    for key in set(j) - set(TIMINGS) - {"total_rewards", "total_reward", "total_reward_std"}:
        assert t[key] == j[key], key


@pytest.mark.parametrize(
    "family,carried,env_name,delay,dt",
    [(f, c, "oderl-pendulum", DELAY, DT) for f, c in (("rnn", False), ("delta_t_rnn", False), ("node", False),
                                                      ("latent_ode", True), ("latent_ode", False))]
    + [("node", False, "oderl-acrobot", 3, 0.2)],
    ids=["rnn", "delta_t_rnn", "node", "latent_ode_carried", "latent_ode_apply", "node_acrobot_d3"])
def test_evaluate_policy_families_match_jax_f64(family, carried, env_name, delay, dt):
    """``evaluate_policy`` of each baseline family on its tracked checkpoint
    of the cell against JAX's at f64 on JAX's draws (the latent ODE's fixed z0
    draw included): every family on pendulum d1, and node on acrobot at delay
    3 (2-d actions) at dt 0.2: a 0.5 s step throws acrobot's plant into
    overflow (returns ~-1e172), where both packages' f64 rounding parts.
    The latent ODE's contract: the model itself plans with carried history,
    its bare apply with tiled history. Returns within rtol 1e-10, every
    other field but the timings equal."""
    jenv = jax_make_env(env_name, dt=dt)
    n, m, high = jenv.spec.n_obs, jenv.spec.m, jenv.spec.action_high
    ckpt = REPO / "artifacts" / "checkpoints" / model_checkpoint_name(family, env_name, delay, "exp", 0, True)
    tweights = load_pytree(ckpt, device="cpu", dtype=torch.float64)
    jweights = jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tweights)
    jm = jax_make_model(family, env_name, n, m, high, JConfig(dt=dt), dtype=jnp.float64)
    if family == "latent_ode":
        tm = make_latent_ode_model(n, m, norm_stats_for(env_name, high, m), dt=dt, dtype=torch.float64,
                                   device="cpu", z0_noise=torch.tensor(fixed_z0_draw(K, n + 2)))
    else:
        tm = torch_make_model(family, env_name, n, m, high, TConfig(dt=dt), dtype=torch.float64, device="cpu")
    japply, tapply = (jm, tm) if carried else (jm.apply, tm.apply)
    seeds = SEEDS[:2]
    j = jax_evaluate(family, env_name, delay, seeds, config=JConfig(dt=dt), model_apply=japply,
                     params=jweights, roll_outs=K, time_steps=T)
    jcfg = jmppi.MPPIConfig(num_samples=K, horizon=T, nu=m)
    jparams = jmppi.make_mppi_params(jmppi.default_noise_sigma(m, 1.0, dtype=jnp.float64))
    t = teval.evaluate_policy(family, env_name, delay, seeds, config=TConfig(dt=dt), model_apply=tapply,
                              params=tweights, roll_outs=K, time_steps=T, dtype=torch.float64, device="cpu",
                              draws=JaxDraws(seed_keys(seeds), jenv, jcfg, jparams, int(10.0 / dt)))
    assert set(t) == set(j)
    np.testing.assert_allclose(t["total_rewards"], j["total_rewards"], rtol=1e-10)
    for key in set(j) - set(TIMINGS) - {"total_rewards", "total_reward", "total_reward_std"}:
        assert t[key] == j[key], key


def result_records():
    """Records of three models on two cells; delay 2 has no reference constants."""
    rng = np.random.default_rng(4)
    recs = []
    for delay in (1, 2):
        for model, center in (("random", -9000.0), ("oracle", -150.0), ("nl", -300.0)):
            seeds = list(range(20))
            rewards = list(center + rng.standard_normal(20) * abs(center) * 0.1)
            recs.append({"env_name": ENV, "model_name": model, "delay": delay, "seeds": seeds,
                         "total_rewards": rewards, "total_reward": float(np.mean(rewards))})
    return recs


@pytest.mark.parametrize("agg", ["std", "ci95"])
@pytest.mark.parametrize("clip", [True, False])
def test_normalized_scores_match_jax(agg, clip):
    recs = result_records()
    got = tprocess.normalized_scores(recs, clip=clip, agg=agg)
    exp = jprocess.normalized_scores(recs, clip=clip, agg=agg)
    assert got.keys() == exp.keys() and len(got) == 6
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=1e-12)


def test_normalized_scores_fall_back_on_reference_baselines():
    """A run without its own oracle/random uses the reference constants for
    delays 0/1 and skips other delays."""
    recs = [r for r in result_records() if r["model_name"] == "nl"]
    got = tprocess.normalized_scores(recs)
    assert got == jprocess.normalized_scores(recs)
    assert list(got) == [(1, ENV, "nl")]
    r_rand, r_orac = tprocess.REFERENCE_BASELINES[1][ENV]
    scores = [max(0.0, 100.0 * (v - r_rand) / (r_orac - r_rand)) for v in recs[0]["total_rewards"]]
    np.testing.assert_allclose(got[(1, ENV, "nl")][0], np.mean(scores), rtol=1e-12)
    assert tprocess.REFERENCE_BASELINES == jprocess.REFERENCE_BASELINES
    assert tprocess.expand_records(recs) == jprocess.expand_records(recs)


@pytest.mark.parametrize("n", [1, 2, 20])
def test_mean_confidence_interval_matches_jax(n):
    data = np.random.default_rng(n).standard_normal(n) * 3.0 + 1.0
    for conf in (0.9, 0.95):
        np.testing.assert_allclose(tprocess.mean_confidence_interval(data, conf),
                                   jprocess.mean_confidence_interval(data, conf), rtol=1e-12)

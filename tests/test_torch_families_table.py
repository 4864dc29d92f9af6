"""The baseline families on every tracked checkpoint of the paper's table
against the JAX package at f64: rnn on pendulum d0 and d1, delta_t_rnn,
node and the latent ODE on pendulum, cartpole and acrobot at delays 0-3.

Each checkpoint's forward and gradient on seeded queries of its env's
shapes (the latent ODE on JAX's z0 draw), the port's forward on the queries
of ``artifacts/port/jax_baselines_table.npz`` (the reference phase
``baselines`` of ``chip_smoke.py`` holds the card to), and a families grid
through ``run_exp_multi_torch.main`` against the JAX package's
``run_exp_multi.main`` on the tracked checkpoints. Tolerances are stated in
each test.
"""

import functools
import json
import re
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
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models.common import cast_params, tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_latent_ode_model
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import run_exp_multi  # noqa: E402
import run_exp_multi_torch  # noqa: E402

torch.set_num_threads(1)

CHECKPOINTS = REPO / "artifacts" / "checkpoints"
NAME = re.compile(r"^(rnn|delta_t_rnn|node|latent_ode)_(oderl-\w+)_delay-(\d)_ts-grid-exp_0_"
                  r"train-with-expert-trajectories-True\.npz$")
CELLS = sorted((m[1], m[2], int(m[3])) for m in map(NAME.match, (p.name for p in CHECKPOINTS.iterdir())) if m)
IDS = [f"{f}-{e.removeprefix('oderl-')}-d{d}" for f, e, d in CELLS]
SHAPES = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
F64_TOL = 1e-9  # relative, |got - exp| / (1 + |exp|), as tests/test_torch_baselines.py
TABLE_TOL = 1e-10


def rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (1.0 + np.abs(exp))).max())


def test_the_tracked_family_checkpoints_are_the_table():
    """38 tracked family checkpoints: rnn on pendulum d0 and d1, the other
    three families on every (env, delay) of the paper's table."""
    assert len(CELLS) == 38
    assert [c for c in CELLS if c[0] == "rnn"] == [("rnn", "oderl-pendulum", 0), ("rnn", "oderl-pendulum", 1)]
    for family in ("delta_t_rnn", "node", "latent_ode"):
        assert sorted((e, d) for f, e, d in CELLS if f == family) == sorted((e, d) for e in SHAPES for d in range(4))


def inputs(env, B, seed):
    n, m, high = SHAPES[env]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n)), rng.uniform(-high, high, (B, 4, m)),
            rng.exponential(0.05, (B, 1)))  # the exp grid's horizons


@functools.lru_cache(maxsize=None)
def jax_family(family, env):
    """The JAX model of (family, env) at f64, its jitted apply and the
    jitted gradient of sum(sin(apply)): one compile serves every delay."""
    n, m, high = SHAPES[env]
    model = jax_make_model(family, env, n, m, high, JConfig(), dtype=jnp.float64)
    grad = jax.grad(lambda p, *q: jnp.sum(jnp.sin(model.apply(p, *q))))
    return jax.jit(model.apply), jax.jit(grad)


def port_family(family, env, rows):
    """The port's model at f64; the latent ODE on JAX's z0 draw at ``rows``."""
    n, m, high = SHAPES[env]
    if family == "latent_ode":
        return make_latent_ode_model(n, m, norm_stats_for(env, high, m), dtype=torch.float64, device="cpu",
                                     z0_noise=torch.tensor(fixed_z0_draw(rows, n + 2)))
    return torch_make_model(family, env, n, m, high, TConfig(), dtype=torch.float64, device="cpu")


def weights(family, env, delay):
    """(JAX params, port params) of the tracked checkpoint at f64."""
    tparams = load_pytree(CHECKPOINTS / model_checkpoint_name(family, env, delay, "exp", 0, True), device="cpu",
                          dtype=torch.float64)
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams), tparams


@pytest.mark.parametrize("family,env,delay", CELLS, ids=IDS)
def test_checkpoint_forward_matches_jax_f64(family, env, delay):
    """The checkpoint's apply at f64 on 48 rows of its env's shapes with
    exp-grid horizons: within 1e-9 of JAX's."""
    jparams, tparams = weights(family, env, delay)
    q = inputs(env, 48, seed=delay)
    exp = np.asarray(jax_family(family, env)[0](jparams, *(jnp.asarray(x) for x in q)))
    got = port_family(family, env, 48).apply(tparams, *(torch.tensor(x) for x in q))
    assert got.shape == (48, SHAPES[env][0]) and got.dtype == torch.float64
    assert rel(got, exp) < F64_TOL


@pytest.mark.parametrize("family,env,delay", CELLS, ids=IDS)
def test_checkpoint_gradient_matches_jax_f64(family, env, delay):
    """d sum(sin(apply)) / d params on the checkpoint at 16 rows: within
    1e-8 of JAX's, relative to each leaf's largest entry."""
    jparams, tparams = weights(family, env, delay)
    q = inputs(env, 16, seed=10 + delay)
    jg = jax_family(family, env)[1](jparams, *(jnp.asarray(x) for x in q))
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tparams)]
    out = port_family(family, env, 16).apply(tree_unflatten(tparams, leaves), *(torch.tensor(x) for x in q))
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), leaves)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(grads)
    for g, e in zip(grads, jleaves):
        assert g.shape == e.shape
        assert float(np.abs(g.numpy() - e).max()) <= 1e-8 * (1.0 + float(np.abs(e).max()))


@functools.lru_cache(maxsize=None)
def table_reference():
    with np.load(REPO / "artifacts" / "port" / "jax_baselines_table.npz") as z:
        rec = {k: z[k] for k in z.files}
    rec["meta"] = json.loads(str(rec["meta"]))
    return rec


@pytest.mark.parametrize("family,env,delay", CELLS, ids=IDS)
def test_port_forward_reproduces_jax_baselines_table(family, env, delay):
    """The port's f64 forward on the card check's 256 queries of the env
    (the latent ODE on the file's z0 draw) reproduces JAX's f64 outputs in
    ``jax_baselines_table.npz`` within 1e-10; the file ran this checkout's
    checkpoint (sha256)."""
    import hashlib

    ref = table_reference()
    path = CHECKPOINTS / model_checkpoint_name(family, env, delay, "exp", 0, True)
    pinned = ref["meta"]["checkpoints"][f"{env}/{delay}/{family}"]
    assert pinned == {"path": str(path.relative_to(REPO)), "sha256": hashlib.sha256(path.read_bytes()).hexdigest()}
    n, m, high = SHAPES[env]
    if family == "latent_ode":
        model = make_latent_ode_model(n, m, norm_stats_for(env, high, m), dtype=torch.float64, device="cpu",
                                      z0_noise=torch.tensor(ref[f"latent_ode/{env}/z0"]))
    else:
        model = port_family(family, env, 256)
    q = [torch.tensor(ref[f"inputs/{env}/{k}"], dtype=torch.float64) for k in ("obs", "abuf", "ts")]
    got = model.apply(weights(family, env, delay)[1], *q)
    assert got.shape == (256, n) and rel(got, ref[f"out/{family}/{env}/{delay}"]) < TABLE_TOL


GRID_K, GRID_T, GRID_DT, GRID_SEEDS = 8, 3, 0.2, 2


def grid_argv(tmp_path, *extra):
    return ["--envs", "oderl-acrobot", "--delays", "0,3", "--models", "latent_ode,delta_t_rnn",
            "--seed_runs", str(GRID_SEEDS), "--dt", str(GRID_DT), "--mppi_roll_outs", str(GRID_K),
            "--mppi_time_steps", str(GRID_T), "--saved_models_path", str(CHECKPOINTS) + "/",
            "--results", str(tmp_path / "results.jsonl"), "--log_folder", str(tmp_path), *extra]


def test_families_grid_matches_jax_driver_f64(tmp_path, monkeypatch):
    """latent_ode (carried history) and delta_t_rnn on acrobot at delays 0
    and 3 through each package's grid driver on the tracked checkpoints, 2
    seeds of 50 steps (dt 0.2: a 0.5 s step throws acrobot's plant into
    overflow, where f64 rounding parts the packages), K=8, T=3. Both
    drivers load the checkpoints through their own ``train_model`` and plan
    at f64 (the models rebuilt at f64 around the loaded weights); the port
    replays JAX's draws, the latent ODE's z0 draw included. Every record's
    returns within rtol 1e-10, every other field but the timings equal."""
    n, m, high = SHAPES["oderl-acrobot"]

    def jax_f64(train_model):
        def load(model_name, env_name, config, **kw):
            _, params, res = train_model(model_name, env_name, config, **kw)
            model = jax_make_model(model_name, env_name, n, m, high, config, dtype=jnp.float64)
            return model, jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params), res
        return load

    def port_f64(train_model):
        def load(model_name, env_name, config, **kw):
            _, params, res = train_model(model_name, env_name, config, **kw)
            model = (make_latent_ode_model(n, m, norm_stats_for(env_name, high, m), dt=config.dt, dtype=torch.float64,
                                           device="cpu", z0_noise=torch.tensor(fixed_z0_draw(GRID_K, n + 2)))
                     if model_name == "latent_ode" else
                     torch_make_model(model_name, env_name, n, m, high, config, dtype=torch.float64, device="cpu"))
            return model, cast_params(params, torch.float64), res
        return load

    def replayed(evaluate):
        def run(model_name, env_name, delay, seeds, **kw):
            jcfg = jmppi.MPPIConfig(num_samples=GRID_K, horizon=GRID_T, nu=m)
            jparams = jmppi.make_mppi_params(jmppi.default_noise_sigma(m, 1.0, dtype=jnp.float64))
            draws = JaxDraws(seed_keys(seeds), jax_make_env(env_name, dt=GRID_DT), jcfg, jparams, int(10 / GRID_DT))
            return evaluate(model_name, env_name, delay, seeds, dtype=torch.float64, draws=draws, **kw)
        return run

    monkeypatch.setattr(run_exp_multi, "train_model", jax_f64(run_exp_multi.train_model))
    (tmp_path / "jax").mkdir()
    run_exp_multi.main(grid_argv(tmp_path / "jax"))
    jrecs = [json.loads(line) for line in (tmp_path / "jax" / "results.jsonl").read_text().splitlines()]

    monkeypatch.setattr(run_exp_multi_torch, "train_model", port_f64(run_exp_multi_torch.train_model))
    monkeypatch.setattr(run_exp_multi_torch, "evaluate_policy", replayed(run_exp_multi_torch.evaluate_policy))
    (tmp_path / "port").mkdir()
    out = run_exp_multi_torch.main(grid_argv(tmp_path / "port", "--device", "cpu"))
    trecs = [json.loads(line) for line in (tmp_path / "port" / "results.jsonl").read_text().splitlines()]
    assert trecs == out["records"]

    cells = [(r["env_name"], r["delay"], r["model_name"]) for r in trecs]
    assert cells == [(r["env_name"], r["delay"], r["model_name"]) for r in jrecs] == [
        ("oderl-acrobot", d, f) for d in (0, 3) for f in ("latent_ode", "delta_t_rnn")]
    timings = {"episode_elapsed_time", "episode_elapsed_time_per_it", "mppi_rollouts_per_sec"}
    for t, j in zip(trecs, jrecs):
        assert set(t) == set(j) and not t["errored"]
        np.testing.assert_allclose(t["total_rewards"], j["total_rewards"], rtol=1e-10)
        for key in set(j) - timings - {"total_rewards", "total_reward", "total_reward_std"}:
            assert t[key] == j[key], key

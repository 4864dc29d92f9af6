"""The port's multi-device layer (``parallel.sharding``, ``parallel.multihost``
meshes, the sharded checkpoint, ``evaluate_policy``'s shard modes and the
driver's ``--shard``) on the CPU, against the JAX package's
``parallel/sharding.py`` on the 8 virtual devices of tests/conftest.py.

The port runs one process per device, so its side runs in spawned ranks:
one gloo group of 4 ranks (tests/torch_shard_worker.py ``world``) computes
every sharded case at once, and 2 ranks of torchrun's environment run the
driver; the cases below assert on what the ranks saved. The JAX side, and
the port's unsharded references, run in this process on the same inputs:
JAX's noise draws, JAX's initial parameters and JAX's episode draws
(tests/jax_replay_draws.py), at f64 unless a case says otherwise.
"""

import functools
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax_replay_draws import JaxDraws

import torch_shard_worker as W
from jax_planner_cases import jax_command_planner
from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.parallel import make_grid_sharded_episodes as jax_grid_episodes
from neurallaplacecontrol_tpu.parallel import make_k_sharded_mppi_command as jax_k_command
from neurallaplacecontrol_tpu.parallel import make_mesh as jax_make_mesh
from neurallaplacecontrol_tpu.parallel import make_sharded_train_step as jax_train_step
from neurallaplacecontrol_tpu.parallel import shard_params as jax_shard_params
from neurallaplacecontrol_tpu.parallel.sharding import derive_param_pspecs as jax_pspecs
from neurallaplacecontrol_tpu.planners import mppi_delay as jmppi
from neurallaplacecontrol_tpu.training.rollout import EpisodeSettings as JSettings
from neurallaplacecontrol_tpu.training.rollout import build_oracle_dynamics as jax_oracle
from neurallaplacecontrol_tpu.training.rollout import make_batched_episode_fn as jax_batched
from neurallaplacecontrol_tpu_torch.config import Config
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.parallel import derive_param_pspecs, make_mesh
from neurallaplacecontrol_tpu_torch.training import evaluate_policy, make_episode_fn
from neurallaplacecontrol_tpu_torch.training.train import make_optimizer
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
RANK_TIMEOUT_S = 300


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_grid_setup(flags):
    """JAX's side of the worker's ``grid_planner(flags)``."""
    goal = flags == "goal"
    env = jax_make_env("oderl-cartpole" if goal else "oderl-pendulum")
    high = env.spec.action_high
    cfg = jmppi.MPPIConfig(num_samples=32, horizon=6, nu=1, u_scale=high, u_min=-high, u_max=high,
                           **(W.GRID_FLAGS if flags is True else {}))
    params = jmppi.make_mppi_params(jmppi.default_noise_sigma(1, 1.0, dtype=jnp.float64))
    settings = JSettings(delay=1, n_steps=10, encode_obs_time=flags is True, change_goal=goal)
    keys = [jax.random.PRNGKey(s) for s in range(4)]
    return env, cfg, params, jax_oracle(env, 32, 0.05, 1), settings, keys


def record_draws(flags):
    """JAX's draws of the grid episodes, as arrays (``W.ArrayDraws``)."""
    env, cfg, params, _, settings, keys = jax_grid_setup(flags)
    d = JaxDraws(keys, env, cfg, params, settings.n_steps)
    to_np = lambda x: x.numpy()  # noqa: E731
    return {"reset": to_np(d.reset_state(None)), "plan0": to_np(d.plan0(None, None)),
            "noise": np.stack([to_np(d.planner_noise(i, None, None)) for i in range(settings.n_steps)]),
            "dt": np.stack([to_np(d.dt(i, env.spec.ts_grid, env.spec.dt)) for i in range(settings.n_steps)])}


def train_inputs(name):
    model = jax_make_model(name, "oderl-cartpole", 5, 1, 3.0, JConfig())
    init = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))
    key = jax.random.PRNGKey(1)
    s0 = np.asarray(jax.random.normal(key, (32, 5), jnp.float64))
    a0 = np.asarray(jax.random.normal(jax.random.fold_in(key, 1), (32, 4, 1), jnp.float64))
    return init, (s0, a0, s0 + 0.01, np.full((32, 1), 0.05))


class Ranks:
    """The spawned ranks; ``get`` waits for them once and reads a rank's results."""

    def __init__(self, procs, directory):
        self.procs, self.directory, self.outs = procs, directory, None

    def get(self, task, rank=0):
        if self.outs is None:
            self.outs = {}
            for name, p in self.procs:
                self.outs[name] = p.communicate(timeout=RANK_TIMEOUT_S)[0]
            for name, p in self.procs:
                assert p.returncode == 0, f"{name}:\n{self.outs[name][-4000:]}"
        with open(self.directory / f"{task}_rank{rank}.pkl", "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    inputs = {
        "command_noise": {},
        "grid_draws": {flags: record_draws(flags) for flags in (False, True, "goal")},
        "train": {name: train_inputs(name) for name in ("nl", "node", "rnn")},
    }
    for case in W.COMMAND_CASES:
        _, cfg, params, _, _, _, key = jax_command_planner(case)
        inputs["command_noise"][case] = np.asarray(jmppi._sample_noise(key, cfg, params))
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    worker = str(REPO / "tests" / "torch_shard_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    port, procs = free_port(), []
    for r in range(WORLD):
        procs.append((f"world{r}", subprocess.Popen([sys.executable, worker, "world", str(r), str(WORLD), str(port),
                                                     str(d)], env=env, cwd=str(d), stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
    drv_port = free_port()
    for r in range(2):
        run_env = dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(drv_port))
        procs.append((f"driver{r}", subprocess.Popen([sys.executable, worker, "driver", str(r), "2", "0", str(d)],
                                                     env=run_env, cwd=str(d), stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
    ranks = Ranks(procs, d)
    try:
        yield ranks
    finally:
        for _, p in procs:
            p.kill()
            p.wait()


@pytest.mark.parametrize("n_ranks", [WORLD, 2])
@pytest.mark.parametrize("case", list(W.COMMAND_CASES))
def test_k_sharded_command_matches_jax(ranks, case, n_ranks):
    """The port's K-sharded command on 4 ranks and on 2 against JAX's
    ``make_k_sharded_mppi_command`` on 8 devices, on JAX's noise draw: the
    base planner, each flag of tests/test_sharding.py:180-230, the terminal
    cost and carried dynamics (:232-279)."""
    env, cfg, params, dyn, cost, extra, key = jax_command_planner(case)
    command = jax_k_command(cfg, params, dyn, cost, jax_make_mesh(8, tp=2), **extra)
    U = jnp.zeros((cfg.horizon, 1), jnp.float64)
    obs = env.observe(jnp.asarray(W.COMMAND_STATE, jnp.float64))
    a, U_new, aux = jax.jit(command)(U, obs, jnp.asarray(W.COMMAND_BUFFER, jnp.float64), key)
    got = ranks.get("world")[("command", case, n_ranks)]
    np.testing.assert_allclose(got["action"], np.asarray(a), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got["U"], np.asarray(U_new), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got["cost_total"], np.asarray(aux["cost_total"]), rtol=1e-8)
    np.testing.assert_allclose(got["omega"], np.asarray(aux["omega"]), rtol=1e-8, atol=1e-300)


def test_k_sharded_window_encoder_matches_one_process(ranks):
    """With the NL window encoder each rank encodes its own windows, and the
    4-rank plan is the one-process plan (tests/test_precompute_planner.py:190-225)."""
    got = ranks.get("world")[("window_encoder",)]
    np.testing.assert_allclose(got["sharded"][0], got["single"][0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["sharded"][1], got["single"][1], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("mode,rtol", [("rollouts", 1e-9), ("seeds", 1e-12), ("grid", 1e-9), ("grid_beyond", 1e-9)])
def test_sharded_eval_matches_unsharded(ranks, mode, rtol):
    """``evaluate_policy`` under each shard mode on 4 ranks returns the
    unsharded run's per-seed returns (tests/test_sharding.py:281-305,
    :434-442); ``grid_beyond`` is a (1, 2) grid on 4 ranks, whose other two
    receive the results. Every rank holds the same record."""
    for rank in range(WORLD):
        ref, got = ranks.get("world", rank)[("eval", mode)]
        np.testing.assert_allclose(got["total_rewards"], ref["total_rewards"], rtol=rtol, err_msg=f"rank {rank}")
        assert got["shard_group_size"] == WORLD and got["shard_fallback"] is None


@pytest.mark.parametrize("mode", ["seeds", "rollouts", "grid"])
def test_devices_subset_eval_matches_unsharded(ranks, mode):
    """``devices``: each pair of the 4 ranks shards its own evaluation, as the
    driver's hosts do (tests/test_sharding.py:308-333)."""
    for rank in range(WORLD):
        ref, got = ranks.get("world", rank)[("devices", mode)]
        np.testing.assert_allclose(got["total_rewards"], ref["total_rewards"], rtol=1e-9, err_msg=f"rank {rank}")
        assert got["shard_group_size"] == 2


def test_shard_fallbacks_are_stamped(ranks):
    """The JAX package's quiet fallbacks run unsharded here too, and the
    record names them: the random policy under "rollouts", and seeds that
    do not divide the group under "seeds"."""
    out = ranks.get("world")
    assert "random policy" in out[("fallback", "random")]["shard_fallback"]
    ref, got = out[("fallback", "seeds")]
    assert "do not divide" in got["shard_fallback"]
    assert got["total_rewards"] == ref["total_rewards"]


def port_grid_reference(flags):
    env, cfg, params, dyn, settings = W.grid_planner(flags)
    totals, recs = make_episode_fn(env, dyn, cfg, params, settings)(W.ArrayDraws(record_draws(flags)))
    return totals.numpy(), recs


@pytest.mark.parametrize("shape", W.GRID_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grid_episodes_match_unsharded(ranks, shape):
    """The grid episodes on (seeds, k) meshes of the 4 ranks against the
    unsharded episode batch on the same (JAX's) draws: returns and records."""
    totals, recs = port_grid_reference(False)
    got = ranks.get("world")[("grid", False, shape)]
    np.testing.assert_allclose(got["totals"], totals, rtol=1e-9)
    np.testing.assert_allclose(got["sn"], recs.sn.numpy(), rtol=1e-9)
    np.testing.assert_allclose(got["a0"], recs.a0.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("jax_shape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_grid_episodes_match_jax_meshes(ranks, jax_shape):
    """The port's (2, 2) grid against JAX's grid episodes on (2, 4) and (4, 2)
    meshes of its 8 devices (tests/test_sharding.py:395-410)."""
    env, cfg, params, dyn, settings, keys = jax_grid_setup(False)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(jax_shape), axis_names=("seeds", "k"))
    tot, rec = jax_grid_episodes(env, dyn, cfg, params, settings, mesh)(jnp.stack(keys))
    got = ranks.get("world")[("grid", False, (2, 2))]
    np.testing.assert_allclose(got["totals"], np.asarray(tot), rtol=1e-9)
    np.testing.assert_allclose(got["sn"], np.asarray(rec.sn), rtol=1e-9)
    np.testing.assert_allclose(got["a0"], np.asarray(rec.a0), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("shape", W.GOAL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_change_goal_episodes_match_jax(ranks, shape):
    """change_goal episodes (the goal cost in the K-sharded command, the
    goal passed per step) seed-sharded over the 4 gloo ranks and on the 2x2
    grid, against JAX's unsharded batch on the same draws and the port's."""
    env, cfg, params, dyn, settings, keys = jax_grid_setup("goal")
    tot, rec = jax_batched(env, dyn, cfg, params, settings)(jnp.stack(keys))
    totals, recs = port_grid_reference("goal")
    np.testing.assert_allclose(totals, np.asarray(tot), rtol=1e-9)
    got = ranks.get("world")[("grid", "goal", shape)]
    np.testing.assert_allclose(got["totals"], np.asarray(tot), rtol=1e-9)
    np.testing.assert_allclose(got["sn"], np.asarray(rec.sn), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["a0"], np.asarray(rec.a0), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["totals"], totals, rtol=1e-9)


def test_grid_episodes_flags_match_jax(ranks):
    """Null action pinned to the globally-last rollout, the abs-noise cost
    and the age channel on the grid (tests/test_sharding.py:413-431), against
    JAX's unsharded batch and the port's."""
    env, cfg, params, dyn, settings, keys = jax_grid_setup(True)
    tot, rec = jax_batched(env, dyn, cfg, params, settings)(jnp.stack(keys))
    totals, recs = port_grid_reference(True)
    got = ranks.get("world")[("grid", True, (2, 2))]
    np.testing.assert_allclose(got["totals"], np.asarray(tot), rtol=1e-9)
    np.testing.assert_allclose(got["a0"], np.asarray(rec.a0), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["totals"], totals, rtol=1e-9)


def one_device_steps(name, dtype, steps=W.TRAIN_STEPS):
    """The port's plain training step (the JAX test's ref_step) on the whole batch."""
    init, batch = train_inputs(name)
    model = make_model(name, "oderl-cartpole", 5, 1, 3.0, Config(), dtype=dtype, device="cpu")
    params = from_jax_params(init, device="cpu", dtype=dtype)
    s0, a0, sn, ts = (torch.tensor(x, dtype=dtype) for x in batch)
    opt = make_optimizer(Config(learning_rate=1e-4, clip_grad_norm=0.1, weight_decay=0.0, use_lr_scheduler=False))
    state, losses = opt.init(params), []
    for _ in range(steps):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = torch.mean((model.apply(p, s0, a0, ts) - (sn - s0)) ** 2)
        grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
        updates, state = opt.update(grads, state, p)
        params = tree_unflatten(params, [x.detach() + u for x, u in zip(leaves, tree_leaves(updates))])
        losses.append(float(loss.detach()))
    return losses, [x.numpy() for x in tree_leaves(params)]


def jax_steps(name, dtype, sharded, steps=W.TRAIN_STEPS):
    """JAX's step on the same inputs: make_sharded_train_step on a (4, 2)
    mesh of its 8 devices, or the plain jitted step of tests/test_sharding.py."""
    init, batch = train_inputs(name)
    model = jax_make_model(name, "oderl-cartpole", 5, 1, 3.0, JConfig(), dtype=dtype)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), init)
    s0, a0, sn, ts = (jnp.asarray(x, dtype) for x in batch)
    opt = optax.chain(optax.clip_by_global_norm(0.1), optax.adam(1e-4))
    if sharded:
        mesh = jax_make_mesh(8, tp=2)
        params = jax_shard_params(params, mesh)
        step = jax_train_step(model.apply, opt, mesh)
    else:
        @jax.jit
        def step(p, o, s0, a0, sn, ts):
            loss, grads = jax.value_and_grad(lambda p: jnp.mean((model.apply(p, s0, a0, ts) - (sn - s0)) ** 2))(p)
            updates, o = opt.update(grads, o, p)
            return optax.apply_updates(p, updates), o, loss
    state, losses = opt.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, s0, a0, sn, ts)
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(params))]


@pytest.mark.parametrize("name,dtype", [(n, d) for n, d in W.TRAIN_CASES], ids=lambda x: str(x).split(".")[-1])
def test_sharded_train_step(ranks, name, dtype):
    """The dp2 x tp2 step, two updates, against the port's one-device step
    and JAX's: at f64 within 1e-10; at f32 against JAX's sharded step at
    its own test's tolerance (tests/test_sharding.py:140-144)."""
    got = ranks.get("world")[("train", name, str(dtype))]
    if dtype == torch.float64:
        for ref_losses, ref_params in (one_device_steps(name, dtype), jax_steps(name, jnp.float64, False)):
            np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-10)
            for a, b in zip(got["params"], ref_params):
                np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)
    else:
        ref_losses, ref_params = jax_steps(name, jnp.float32, True)
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-5)
        for a, b in zip(got["params"], ref_params):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["nl", "node", "rnn"])
def test_derive_param_pspecs_match_jax(name):
    """The split rule on the nl, node and rnn trees equals JAX's
    PartitionSpecs (tests/test_sharding.py:52-76), a spec as its tuple of axes."""
    jparams = jax_make_model(name, "oderl-cartpole", 5, 1, 3.0, JConfig()).init(jax.random.PRNGKey(0))
    jspecs = jax_pspecs(jparams)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tspecs = derive_param_pspecs(tparams)
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    want = [tuple(s) for s in jax.tree_util.tree_leaves(jspecs, is_leaf=is_spec)]
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import _leaf_paths

    assert [s for _, s in _leaf_paths(tspecs)] == want
    if name == "nl":
        assert tspecs["laplace_rep"][0]["w"] == (None, "tp") and tspecs["laplace_rep"][1]["w"] == ("tp", None)


def test_sharded_checkpoint_roundtrip(ranks):
    """``save_sharded``/``load_sharded`` over ``torch.distributed.checkpoint``
    restore every rank's blocks onto the same placements
    (tests/test_sharding.py:336-358), for the JAX test's tree and for an NL
    tree as ``shard_params`` splits it."""
    for rank in range(WORLD):
        got = ranks.get("world", rank)[("checkpoint",)]
        assert got["plain_local_equal"] and got["plain_local_shape"] == (16, 4)
        assert got["nl_equal"] and got["nl_split"] == "TensorParallelLinear"


def test_meshes_and_process_slice(ranks):
    """``global_mesh`` and ``make_mesh`` shapes over the 4 ranks, and each
    rank's round-robin share of a list (tests/test_sharding.py:46-49, :360-376)."""
    shares = []
    for rank in range(WORLD):
        got = ranks.get("world", rank)[("meshes",)]
        assert got["global"] == (2, 2) and got["names"] == ("dp", "tp") and got["flat"] == (WORLD,)
        assert got["make_mesh"] == ((2, 2), ("dp", "tp"))
        assert got["k_refused"], "a K the ranks do not divide was not refused"
        shares.append(got["slice"])
    assert shares[1] == [1, 5] and sorted(sum(shares, [])) == list(range(7))


@pytest.mark.parametrize("shard", ["seeds", "rollouts", "grid:1x2"])
def test_driver_shard_writes_the_unsharded_records(ranks, shard, tmp_path, monkeypatch):
    """Two ranks of torchrun's environment run the driver under ``--shard``
    on the CPU: rank 0 writes the records of ``--shard none`` (run here, in
    one process), each stamped with the mode and the group size, and the
    random cell with its fallback where the mode has one."""
    import run_exp_multi_torch as driver

    monkeypatch.setattr(driver, "evaluate_policy", functools.partial(evaluate_policy, dtype=torch.float64))
    ref = driver.main(W.driver_argv(tmp_path, "none"))["records"]
    tag = shard.replace(":", "_")
    written = [json.loads(x) for x in (ranks.directory / tag / "results.jsonl").read_text().splitlines()]
    for rank in range(2):
        got = ranks.get("driver", rank)[("driver", shard)]
        assert [r["total_rewards"] for r in got] == [r["total_rewards"] for r in written]
    assert [(r["model_name"], r["delay"]) for r in written] == [(r["model_name"], r["delay"]) for r in ref]
    for got, want in zip(written, ref):
        assert not got["errored"] and got["shard"] == shard and got["shard_group_size"] == 2
        np.testing.assert_allclose(got["total_rewards"], want["total_rewards"], rtol=1e-9 if shard == "rollouts" else 1e-12)
        fallback = got["model_name"] == "random" and shard != "seeds"
        assert (got["shard_fallback"] is not None) == fallback, got["shard_fallback"]


@pytest.mark.parametrize("kw", [{"shard_seeds": True}, {"shard_rollouts": True}, {"shard_grid": (1, 1)}],
                         ids=["seeds", "rollouts", "grid"])
def test_world_of_one_is_the_unsharded_run(kw):
    """Outside a process group a process is a world of one: every shard
    mode runs its one-rank form, the unsharded evaluation."""
    ev = functools.partial(evaluate_policy, "oracle", "oderl-pendulum", 1, range(2), Config(dt=0.5), **W.EVAL_CFG)
    ref, got = ev(), ev(**kw)
    assert got["total_rewards"] == ref["total_rewards"] and got["shard_group_size"] == 1


@pytest.mark.parametrize("kw,cfg,message", [
    ({"shard_grid": (1, 1), "shard_seeds": True}, {}, "exclusive"),
    ({"shard_seeds": True, "shard_rollouts": True}, {}, "exclusive"),
    ({"shard_grid": (1, 1)}, {"nl_planner_precompute": True}, "precompute"),
    ({"shard_grid": (1, 2)}, {}, "needs 2 devices"),
    ({"shard_grid": (3, 1)}, {}, "seeds do not split"),
    ({"devices": [0]}, {}, "restricts a shard mode"),
], ids=["grid_and_seeds", "seeds_and_rollouts", "precompute_on_grid", "too_few_ranks", "seeds_axis", "devices_alone"])
def test_shard_requests_that_cannot_be_met_raise(kw, cfg, message):
    """A shard request that cannot be met raises, as the JAX asserts do."""
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)),
                         device="cpu", dtype=torch.float64)
    model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, Config(), dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match=message):
        evaluate_policy("nl", "oderl-cartpole", 1, range(2), Config(dt=0.5, **cfg), model_apply=model.apply,
                        params=params, **W.EVAL_CFG, **kw)


def test_mesh_refuses_ranks_beyond_the_world():
    with pytest.raises(ValueError, match="beyond the world"):
        make_mesh(2, device="cpu")

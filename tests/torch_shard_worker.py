"""One rank of a gloo group for tests/test_torch_sharding.py, on the CPU.

    python tests/torch_shard_worker.py world <rank> <world> <port> <dir>
    python tests/torch_shard_worker.py driver <rank> <world> <port> <dir>

``world`` joins a group of ``<world>`` ranks (4 in the tests) and runs the
port's side of every sharded case: the K-sharded command on the whole group
and on rank pairs, ``evaluate_policy`` under each shard mode and under
``devices``, grid episodes on JAX's replayed draws, the dp x tp training
step, the sharded checkpoint and the meshes. ``driver`` runs
``run_exp_multi_torch.main`` under ``--shard seeds``, ``rollouts`` and
``grid:1x2`` as one rank of torchrun's environment (set by the caller). The
inputs that come from JAX (noise draws, initial parameters, replayed episode
draws) are read from ``<dir>/inputs.pkl``; each rank writes what it found to
``<dir>/<task>_rank<rank>.pkl``. This file imports no JAX.
"""

import functools
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from neurallaplacecontrol_tpu_torch.config import Config  # noqa: E402
from neurallaplacecontrol_tpu_torch.envs import make_env  # noqa: E402
from neurallaplacecontrol_tpu_torch.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves  # noqa: E402
from neurallaplacecontrol_tpu_torch.parallel import (  # noqa: E402
    Mesh,
    global_mesh,
    make_grid_sharded_episodes,
    make_k_sharded_mppi_command,
    make_mesh,
    make_sharded_train_step,
    multihost,
    shard_params,
    unshard_params,
)
from neurallaplacecontrol_tpu_torch.planners import MPPIConfig, default_noise_sigma, make_mppi_params  # noqa: E402
from neurallaplacecontrol_tpu_torch.training import evaluate_policy  # noqa: E402
from neurallaplacecontrol_tpu_torch.training.rollout import (  # noqa: E402
    EpisodeSettings,
    build_oracle_dynamics,
    build_running_cost,
)
from neurallaplacecontrol_tpu_torch.training.train import make_optimizer  # noqa: E402
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params, load_sharded, save_sharded  # noqa: E402

torch.set_num_threads(1)

# The K-sharded command's cases (tests/test_sharding.py:147-279): name ->
# (MPPIConfig flags, dynamics kind, PRNG key, K, T). The dynamics kinds are
# built the same way on both sides (test_torch_sharding.jax_planner).
COMMAND_CASES = {
    "base": ({}, "plain", 5, 64, 6),
    "sample_null_action": ({"sample_null_action": True}, "plain", 7, 64, 6),
    "noise_abs_cost": ({"noise_abs_cost": True}, "plain", 7, 64, 6),
    "encode_obs_time": ({"encode_obs_time": True}, "strip_age", 7, 64, 6),
    "rollout_samples": ({"rollout_samples": 3, "rollout_var_cost": 0.5}, "plain", 7, 64, 6),
    "step_dependent_dynamics": ({"step_dependent_dynamics": True}, "step", 7, 64, 6),
    "u_per_command": ({"u_per_command": 3}, "plain", 7, 64, 6),
    "terminal_state_cost": ({}, "terminal", 11, 32, 5),
    "carried_dynamics": ({}, "carried", 11, 32, 5),
}
COMMAND_STATE = [0.1, -0.2, 3.0, 0.5]  # cartpole raw state of the cases
COMMAND_BUFFER = [[0.3], [0.6], [-0.9], [1.2]]
# evaluate_policy's cases: pendulum, 20-step episodes, K=16, T=4 (:281-334)
EVAL_CFG = dict(roll_outs=16, time_steps=4, dtype=torch.float64, device="cpu")
# grid episodes (:378-442): pendulum, K=32, T=6, 10 steps, 4 seeds
GRID_SHAPES = [(2, 2), (4, 1), (1, 4)]
GRID_FLAGS = {"sample_null_action": True, "noise_abs_cost": True, "encode_obs_time": True}
# change_goal episodes (the grid case "goal"): cartpole, the same sizes,
# seed-sharded over 4 ranks and on the 2x2 grid
GOAL_SHAPES = [(4, 1), (2, 2)]
# the dp x tp step (:77-144): batch 32 of cartpole, families and dtypes
TRAIN_CASES = [("nl", torch.float64), ("nl", torch.float32), ("node", torch.float64), ("rnn", torch.float64)]
TRAIN_STEPS = 2


def command_planner(case, dtype=torch.float64):
    """(env, cfg, params, dynamics, cost, extra kwargs) of a command case."""
    flags, kind, _, K, T = COMMAND_CASES[case]
    env = make_env("oderl-cartpole")
    cfg = MPPIConfig(num_samples=K, horizon=T, nu=1, u_scale=3.0, u_min=-3.0, u_max=3.0, dt=0.05, **flags)
    params = make_mppi_params(default_noise_sigma(1, 1.0, dtype=dtype))
    base = build_oracle_dynamics(env, 0.05, 1)
    extra, dyn = {}, base
    if kind == "strip_age":
        def dyn(state, window):
            return base(state, window[..., :1])
    elif kind == "step":
        def dyn(state, window, t):
            return base(state, window) + 1e-4 * t
    elif kind == "terminal":
        extra["terminal_state_cost"] = lambda states, actions: torch.sum(states[:, -1, :] ** 2, dim=-1)
    elif kind == "carried":
        extra["dynamics_carry_init"] = lambda state0: state0.new_zeros(state0.shape[0])

        def dyn(carry, state, window):
            carry = carry + torch.sum(window[:, -1, :], dim=-1)
            return carry, base(state, window) + 1e-5 * carry[:, None]
    return env, cfg, params, dyn, build_running_cost(env), extra


def grid_planner(flags=False):
    """The grid case ``flags``: False (pendulum), True (pendulum with
    GRID_FLAGS) or "goal" (cartpole with change_goal)."""
    goal = flags == "goal"
    env = make_env("oderl-cartpole" if goal else "oderl-pendulum")
    high = env.spec.action_high
    cfg = MPPIConfig(num_samples=32, horizon=6, nu=1, u_scale=high, u_min=-high, u_max=high,
                     **(GRID_FLAGS if flags is True else {}))
    params = make_mppi_params(default_noise_sigma(1, 1.0, dtype=torch.float64))
    settings = EpisodeSettings(delay=1, n_steps=10, encode_obs_time=flags is True, change_goal=goal)
    return env, cfg, params, build_oracle_dynamics(env, 0.05, 1), settings


class ArrayDraws:
    """Draws recorded from ``jax_replay_draws.JaxDraws`` (arrays per step,
    seeds on the second axis), served through ``SeedDraws``' methods."""

    def __init__(self, rec: dict, index=None):
        self.rec = rec
        self.index = list(range(rec["reset"].shape[0])) if index is None else list(index)

    def __len__(self):
        return len(self.index)

    def select(self, index):
        return ArrayDraws(self.rec, [self.index[i] for i in index])

    def _t(self, x):
        return torch.tensor(np.asarray(x)[self.index], dtype=torch.float64)

    def reset_state(self, env):
        return self._t(self.rec["reset"])

    def plan0(self, cfg, params):
        return self._t(self.rec["plan0"])

    def planner_noise(self, it, cfg, params):
        return self._t(self.rec["noise"][it])

    def dt(self, it, ts_grid, dt):
        return self._t(self.rec["dt"][it])


def gather_rows(x: torch.Tensor, group) -> np.ndarray:
    """A K-sharded per-rollout field [..., K/n] back to [..., K]."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1).numpy()


def run_commands(inputs: dict, rank: int, world: int) -> dict:
    """Each command case on the whole group and on rank pairs."""
    out = {}
    pair = [rank - rank % 2, rank - rank % 2 + 1]
    for n, ranks in ((world, list(range(world))), (2, pair)):
        mesh = Mesh(ranks, ("k",), device="cpu")
        for case in COMMAND_CASES:
            env, cfg, params, dyn, cost, extra = command_planner(case)
            command = make_k_sharded_mppi_command(cfg, params, dyn, cost, mesh, **extra)
            U = torch.zeros((cfg.horizon, 1), dtype=torch.float64)
            obs = env.observe(torch.tensor(COMMAND_STATE, dtype=torch.float64))
            buf = torch.tensor(COMMAND_BUFFER, dtype=torch.float64)
            a, U_new, aux = command(U, obs, buf, noise=torch.tensor(inputs["command_noise"][case]))
            out[("command", case, n)] = {"action": a.numpy(), "U": U_new.numpy(),
                                         "cost_total": gather_rows(aux["cost_total"], mesh.group()),
                                         "omega": gather_rows(aux["omega"], mesh.group())}
    return out


def run_window_encoder(rank: int, world: int) -> dict:
    """The K-sharded planner with the NL window encoder against the same
    planner in one process (tests/test_precompute_planner.py:190-225), on
    the tracked cartpole-d1 weights at f64."""
    from neurallaplacecontrol_tpu_torch.training.rollout import build_learned_dynamics_encoded
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint
    from neurallaplacecontrol_tpu_torch.planners import mppi_command

    env = make_env("oderl-cartpole")
    spec = env.spec
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)),
                         device="cpu", dtype=torch.float64)
    model = make_model("nl", "oderl-cartpole", spec.n_obs, spec.m, spec.action_high, Config(),
                       dtype=torch.float64, device="cpu")
    K, T = 8 * world, 5
    cfg = MPPIConfig(num_samples=K, horizon=T, nu=1, u_scale=3.0, u_min=-3.0, u_max=3.0)
    mp = make_mppi_params(default_noise_sigma(1, 1.0, dtype=torch.float64))
    encoder, dyn = build_learned_dynamics_encoded(model, params, cfg.dt)
    g = torch.Generator().manual_seed(3)
    U = torch.randn((T, 1), generator=g, dtype=torch.float64)
    obs = env.observe(env.reset(g, torch.float64))
    buf = torch.zeros((4, 1), dtype=torch.float64)
    noise = torch.randn((K, T, 1), generator=g, dtype=torch.float64)
    a1, U1, _ = mppi_command(cfg, mp, dyn, build_running_cost(env), U, obs, buf, noise=noise, window_encoder=encoder)
    command = make_k_sharded_mppi_command(cfg, mp, dyn, build_running_cost(env), Mesh(range(world), ("k",), "cpu"),
                                          window_encoder=encoder)
    a2, U2, _ = command(U, obs, buf, noise=noise)
    return {("window_encoder",): {"single": (a1.numpy(), U1.numpy()), "sharded": (a2.numpy(), U2.numpy())}}


def run_evals(rank: int, world: int) -> dict:
    """evaluate_policy in each shard mode, on the group and on rank pairs."""
    out = {}
    cfg = Config(dt=0.5)
    ev = functools.partial(evaluate_policy, config=cfg, **EVAL_CFG)
    out[("eval", "rollouts")] = (ev("oracle", "oderl-pendulum", 1, range(2)),
                                 ev("oracle", "oderl-pendulum", 1, range(2), shard_rollouts=True))
    out[("eval", "seeds")] = (ev("oracle", "oderl-pendulum", 0, range(8)),
                              ev("oracle", "oderl-pendulum", 0, range(8), shard_seeds=True))
    out[("eval", "grid")] = (ev("oracle", "oderl-pendulum", 1, range(4)),
                             ev("oracle", "oderl-pendulum", 1, range(4), shard_grid=(2, 2)))
    # a grid on part of the devices: the ranks beyond it receive the results
    out[("eval", "grid_beyond")] = (out[("eval", "grid")][0],
                                    ev("oracle", "oderl-pendulum", 1, range(4), shard_grid=(1, 2)))
    pair = [rank - rank % 2, rank - rank % 2 + 1]
    ref = ev("oracle", "oderl-pendulum", 1, range(4))
    for name, kw in (("seeds", {"shard_seeds": True}), ("rollouts", {"shard_rollouts": True}),
                     ("grid", {"shard_grid": (1, 2)})):
        out[("devices", name)] = (ref, ev("oracle", "oderl-pendulum", 1, range(4), devices=pair, **kw))
    out[("fallback", "random")] = ev("random", "oderl-pendulum", 1, range(4), shard_rollouts=True)
    out[("fallback", "seeds")] = (ev("oracle", "oderl-pendulum", 1, range(3)),
                                  ev("oracle", "oderl-pendulum", 1, range(3), shard_seeds=True))
    return out


def run_grids(inputs: dict, world: int) -> dict:
    out = {}
    for flags, shapes in ((False, GRID_SHAPES), (True, [(2, 2)]), ("goal", GOAL_SHAPES)):
        env, cfg, params, dyn, settings = grid_planner(flags)
        draws = ArrayDraws(inputs["grid_draws"][flags])
        for shape in shapes:
            mesh = Mesh(np.arange(world).reshape(shape), ("seeds", "k"), device="cpu")
            totals, recs = make_grid_sharded_episodes(env, dyn, cfg, params, settings, mesh)(draws)
            out[("grid", flags, shape)] = {"totals": totals.numpy(), "sn": recs.sn.numpy(), "a0": recs.a0.numpy()}
    return out


def run_train(inputs: dict, world: int) -> dict:
    out = {}
    opt = make_optimizer(Config(learning_rate=1e-4, clip_grad_norm=0.1, weight_decay=0.0, use_lr_scheduler=False))
    mesh = make_mesh(world, tp=2, device="cpu")
    for name, dtype in TRAIN_CASES:
        init, batch = inputs["train"][name]
        model = make_model(name, "oderl-cartpole", 5, 1, 3.0, Config(), dtype=dtype, device="cpu")
        params = shard_params(from_jax_params(init, device="cpu", dtype=dtype), mesh)
        s0, a0, sn, ts = (torch.tensor(x, dtype=dtype) for x in batch)
        step = make_sharded_train_step(model.apply, opt, mesh)
        state, losses = opt.init(params), []
        for _ in range(TRAIN_STEPS):
            params, state, loss = step(params, state, s0, a0, sn, ts)
            losses.append(float(loss))
        full = unshard_params(params, mesh)
        out[("train", name, str(dtype))] = {"losses": losses, "params": [x.numpy() for x in tree_leaves(full)]}
    return out


def run_checkpoint(directory: Path, rank: int, world: int) -> dict:
    """Save and restore split parameters onto the same placements: the JAX
    test's tree with explicit specs, and an NL tree as ``shard_params``
    splits it."""
    mesh = make_mesh(world, tp=2, device="cpu")
    r, tp = mesh.coord["tp"], mesh.shape["tp"]
    w = torch.arange(16.0 * 8, dtype=torch.float64).reshape(16, 8)
    local = {"w": w[:, r * 8 // tp:(r + 1) * 8 // tp].clone(), "b": torch.arange(8.0, dtype=torch.float64)}
    specs = {"w": (None, "tp"), "b": ()}
    path = save_sharded(directory / "ckpt_plain", local, mesh, specs)
    back = load_sharded(path, local, mesh, specs)
    model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, Config(), dtype=torch.float64, device="cpu")
    params = shard_params(model.init(torch.Generator().manual_seed(0)), mesh)
    path = save_sharded(directory / "ckpt_nl", params, mesh)
    restored = load_sharded(path, params, mesh)
    return {("checkpoint",): {
        "plain_local_equal": bool(torch.equal(back["w"], local["w"]) and torch.equal(back["b"], local["b"])),
        "plain_local_shape": tuple(back["w"].shape),
        "nl_equal": all(torch.equal(a, b) for a, b in zip(tree_leaves(restored), tree_leaves(params))),
        "nl_split": type(restored["laplace_rep"][0]).__name__,
    }}


def run_meshes(world: int) -> dict:
    mesh = global_mesh(("dp", "tp"), shape=(2, world // 2), device="cpu")
    flat = global_mesh(device="cpu")
    dp_tp = make_mesh(device="cpu")
    env, cfg, params, dyn, cost, _ = command_planner("base")
    try:
        make_k_sharded_mppi_command(MPPIConfig(num_samples=world * 16 + 2, horizon=6, nu=1), params, dyn, cost, flat)
        k_refused = False
    except ValueError:
        k_refused = True
    return {("meshes",): {"global": mesh.devices.shape, "names": mesh.axis_names, "flat": flat.devices.shape,
                          "make_mesh": (dp_tp.devices.shape, dp_tp.axis_names),
                          "slice": multihost.process_slice(list(range(7))), "k_refused": k_refused}}


def run_driver(directory: Path, rank: int) -> dict:
    import run_exp_multi_torch as driver

    driver.evaluate_policy = functools.partial(evaluate_policy, dtype=torch.float64)
    out = {}
    for shard in ("seeds", "rollouts", "grid:1x2"):
        tag = shard.replace(":", "_")
        got = driver.main(driver_argv(directory, tag) + ["--shard", shard])
        out[("driver", shard)] = got["records"]
    return out


def driver_argv(directory: Path, tag: str) -> list:
    """The miniature grid of the driver cases: pendulum d1, oracle and
    random, 4 seeds, 20-step episodes, K=8, T=3."""
    return ["--device", "cpu", "--envs", "oderl-pendulum", "--delays", "1", "--models", "oracle,random",
            "--seed_runs", "4", "--dt", "0.5", "--mppi_roll_outs", "8", "--mppi_time_steps", "3",
            "--results", str(directory / tag / "results.jsonl"), "--log_folder", str(directory / tag)]


def main():
    task, rank, world, port, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5])
    if task == "driver":
        out = run_driver(directory, rank)
    else:
        multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
        with open(directory / "inputs.pkl", "rb") as f:
            inputs = pickle.load(f)
        out = {}
        out.update(run_commands(inputs, rank, world))
        out.update(run_window_encoder(rank, world))
        out.update(run_evals(rank, world))
        out.update(run_grids(inputs, world))
        out.update(run_train(inputs, world))
        out.update(run_checkpoint(directory, rank, world))
        out.update(run_meshes(world))
    with open(directory / f"{task}_rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

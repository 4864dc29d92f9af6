#!/usr/bin/env python3
"""Two ranks of the port's K-sharded planner and sharded evaluation sharing
one CUDA card over gloo, one process per rank.

    python3 scripts/port_shard_check.py phase
    python3 scripts/port_shard_check.py seedsplit
    python3 scripts/port_shard_check.py ranks <rank> <port> <out_dir> <eval_returns.json>

``phase`` runs ``chip_smoke.py``'s phase ``shard`` alone (on a card), with
its own unsharded 20-seed evaluation in place of phase ``eval``'s.
``seedsplit`` asks why a block of seeds plans otherwise than the same
seeds inside the 20-seed batch (``seed_split``). ``ranks``
is one of the two processes that ``chip_smoke.run_shard`` spawns: the ranks
join a gloo group on the same card (nccl refuses two ranks on one device),
and each writes ``<out_dir>/rank<rank>.json``:

- ``ticks``: 10 replayed closed-loop ticks of cartpole d1 through the fused
  forward kernel at K=1,000 and K=262,144, each planned K-sharded over the
  two ranks and in one rank on the same global noise draw, with the
  largest gaps of U and of the action; the loop advances on the one-rank
  plan. ``planted`` is the same K-sharded plan with no reduction over the
  ranks (each rank's own half), the fault the limit must catch;
- ``seeds``: the 20-seed evaluation split over the ranks (10 seeds each),
  against the unsharded returns in ``eval_returns.json``;
- ``grid``: ``shard_grid`` (2, 1) and (1, 2) on seeds 0-3;
- ``launches``: the forward kernel's launches in ``seeds`` and ``grid``.

Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TICK_KS = (1000, 262144)
REPLAY_TICKS = 10
GRID_SEEDS = 4


def rel(a, b) -> float:
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def replayed_ticks(K: int, device, mesh) -> dict:
    """The K-sharded plan against the one-rank plan, tick by tick."""
    import torch

    import chip_smoke
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import env_step
    from neurallaplacecontrol_tpu_torch.parallel import make_k_sharded_mppi_command
    from neurallaplacecontrol_tpu_torch.planners import mppi_command, mppi_command_core, mppi_reset
    from neurallaplacecontrol_tpu_torch.planners.mppi_delay import _sample_noise, shard_block
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost

    env, params, model = chip_smoke.load_nl(chip_smoke.MAIN_ENV, device)
    env, cfg, mp, dyn, _, _ = build_planner("nl", chip_smoke.MAIN_ENV, chip_smoke.DELAY,
                                            Config(fused_nl_planner=True), model_apply=model.apply, params=params,
                                            roll_outs=K, time_steps=chip_smoke.T, device=device)
    cost = build_running_cost(env)
    command = make_k_sharded_mppi_command(cfg, mp, dyn, cost, mesh)
    g = torch.Generator(device=device).manual_seed(0)  # the same stream on both ranks
    raw = env.reset(g, torch.float32, device)
    U = mppi_reset(g, cfg, mp)
    buffer = torch.zeros((4, 1), device=device)
    gaps = {"U": 0.0, "action": 0.0, "planted_U": 0.0, "planted_action": 0.0}
    t_ref = t_shard = 0.0
    for _ in range(REPLAY_TICKS):
        obs = env.observe(raw)
        noise = _sample_noise(g, cfg, mp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a_ref, U_ref, _ = mppi_command(cfg, mp, dyn, cost, U, obs, buffer, noise=noise)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a_sh, U_sh, _ = command(U, obs, buffer, noise=noise)
        torch.cuda.synchronize()
        t_ref, t_shard = t_ref + t1 - t0, t_shard + time.perf_counter() - t1
        shifted = torch.roll(U, -1, dims=0)
        shifted[-1] = mp.u_init
        a_pl, U_pl, _ = mppi_command_core(cfg, mp, dyn, cost, shifted, obs, buffer,
                                          shard_block(noise, mesh.group()))
        gaps["U"] = max(gaps["U"], rel(U_sh, U_ref))
        gaps["action"] = max(gaps["action"], float((a_sh - a_ref).abs().max()))
        gaps["planted_U"] = max(gaps["planted_U"], rel(U_pl, U_ref))
        gaps["planted_action"] = max(gaps["planted_action"], float((a_pl - a_ref).abs().max()))
        buffer = torch.roll(buffer, -1, dims=0)
        buffer[-1] = a_ref
        raw = env_step(env, raw, buffer[-(chip_smoke.DELAY + 1)], env.spec.dt)
        U = U_ref
    return {"K": K, "rows_per_rank": K // mesh.size, **gaps, "one_rank_plan_ms": 1e3 * t_ref / REPLAY_TICKS,
            "sharded_plan_ms": 1e3 * t_shard / REPLAY_TICKS}


def run_rank(rank: int, port: int, out_dir: Path, eval_returns: Path) -> None:
    import torch

    import chip_smoke
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.ops import pallas_nl
    from neurallaplacecontrol_tpu_torch.parallel import Mesh, multihost
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda", backend="gloo")
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh([0, 1], ("k",), device=device)
    out = {"rank": rank, "ticks": [replayed_ticks(K, device, mesh) for K in TICK_KS]}

    fwd = pallas_nl.nl_forward_fused
    env, params, model = chip_smoke.load_nl(chip_smoke.MAIN_ENV, device)
    cfg = Config(fused_nl_planner=True)
    kw = dict(model_apply=model.apply, params=params, roll_outs=chip_smoke.K, time_steps=chip_smoke.T,
              device=device)
    ref = json.loads(eval_returns.read_text())
    fwd.launches = fwd.rows = 0
    seeds = evaluate_policy("nl", chip_smoke.MAIN_ENV, chip_smoke.DELAY, chip_smoke.EVAL_SEEDS, cfg,
                            shard_seeds=True, **kw)
    out["seeds"] = {"returns": seeds["total_rewards"], "episode_batch_s": seeds["episode_elapsed_time"],
                    "max_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(seeds["total_rewards"], ref)),
                    "launches": fwd.launches, "rows_per_launch": fwd.rows / max(1, fwd.launches)}
    out["grid"] = {}
    for shape in ((2, 1), (1, 2)):
        fwd.launches = fwd.rows = 0
        r = evaluate_policy("nl", chip_smoke.MAIN_ENV, chip_smoke.DELAY, range(GRID_SEEDS), cfg, shard_grid=shape,
                            **kw)
        out["grid"][f"{shape[0]}x{shape[1]}"] = {
            "returns": r["total_rewards"], "episode_batch_s": r["episode_elapsed_time"],
            "max_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(r["total_rewards"], ref[:GRID_SEEDS])),
            "launches": fwd.launches, "rows_per_launch": fwd.rows / max(1, fwd.launches)}
    torch.cuda.synchronize()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()


def run_phase() -> None:
    """Phase ``shard`` of chip_smoke.py alone, on its own unsharded
    evaluation of the 20 seeds."""
    import torch

    import chip_smoke
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.ops import nl_cuda
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the shard phase needs a GPU")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(f"device {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    nl_cuda.build()
    nl_cuda.library()
    env, params, model = chip_smoke.load_nl(chip_smoke.MAIN_ENV, device)
    r = evaluate_policy("nl", chip_smoke.MAIN_ENV, chip_smoke.DELAY, chip_smoke.EVAL_SEEDS,
                        Config(fused_nl_planner=True), model_apply=model.apply, params=params,
                        roll_outs=chip_smoke.K, time_steps=chip_smoke.T, device=device)
    with tempfile.TemporaryDirectory() as tmp, chip_smoke.phase("shard"):
        chip_smoke.run_shard(device, smi, r["total_rewards"], tmp)


def seed_split() -> dict:
    """Why a seed block's episodes part from the same seeds' in the 20-seed
    batch: the first tick of phase ``eval``'s evaluation (cartpole d1,
    K=1000, T=40), planned for seeds 0-19 and for seeds 0-9 alone on the
    same draws, and each reduction of the planner's step 5-6 on [20, ...]
    against its first 10 seeds alone. Each entry says whether the first 10
    seeds' values are bit-equal, with the largest gap."""
    import torch

    import chip_smoke
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.planners import mppi_command
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import SeedDraws, build_running_cost

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    env, params, model = chip_smoke.load_nl(chip_smoke.MAIN_ENV, device)
    env, cfg, mp, dyn, _, _ = build_planner("nl", chip_smoke.MAIN_ENV, chip_smoke.DELAY,
                                            Config(fused_nl_planner=True), model_apply=model.apply, params=params,
                                            roll_outs=chip_smoke.K, time_steps=chip_smoke.T, device=device)
    cost = build_running_cost(env)
    S, half = len(chip_smoke.EVAL_SEEDS), len(chip_smoke.EVAL_SEEDS) // 2

    def first_tick(draws):
        n = len(draws)
        obs = env.observe(draws.reset_state(env))
        U = draws.plan0(cfg, mp)
        noise = draws.planner_noise(0, cfg, mp)
        buffer = torch.zeros((n, 4, 1), device=device)
        return (obs, U, buffer, noise), mppi_command(cfg, mp, dyn, cost, U, obs, buffer, noise=noise)

    def cmp(a, b) -> dict:
        a = a[: b.shape[0]]
        return {"equal": bool(torch.equal(a, b)), "max_abs_gap": float((a - b).abs().max())}

    out = {}
    (obs, U, buffer, noise), (a20, U20, aux20) = first_tick(SeedDraws(chip_smoke.EVAL_SEEDS, device=device))
    (obs10, U10in, _, noise10), (a10, U10, aux10) = first_tick(
        SeedDraws(chip_smoke.EVAL_SEEDS, device=device).select(range(half)))
    out["draws"] = {"obs": cmp(obs, obs10), "U0": cmp(U, U10in), "noise": cmp(noise, noise10)}
    rows = obs[:, None].expand(S, chip_smoke.K, obs.shape[-1]).reshape(-1, obs.shape[-1])
    windows = noise.reshape(S * chip_smoke.K, chip_smoke.T, 1)[:, :4].contiguous()
    out["forward"] = cmp(dyn(rows, windows), dyn(rows[: half * chip_smoke.K], windows[: half * chip_smoke.K]))
    out["plan"] = {"cost_total": cmp(aux20["cost_total"], aux10["cost_total"]),
                   "omega": cmp(aux20["omega"], aux10["omega"]), "U": cmp(U20, U10), "action": cmp(a20, a10)}
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn((S, chip_smoke.K, chip_smoke.T, 1), generator=g, device=device)
    c = torch.randn((chip_smoke.T, S * chip_smoke.K), generator=g, device=device)
    w = torch.rand((S, chip_smoke.K), generator=g, device=device)
    out["reductions"] = {
        "sum over T x nu of [S, K, T, nu]": cmp(torch.sum(x, dim=(2, 3)), torch.sum(x[:half], dim=(2, 3))),
        "sum over T of [T, S*K]": cmp(torch.sum(c, dim=0), torch.sum(c[:, : half * chip_smoke.K], dim=0)),
        "sum over K of [S, K]": cmp(torch.sum(w, dim=1, keepdim=True), torch.sum(w[:half], dim=1, keepdim=True)),
        "sum over K of [S, K, T, nu]": cmp(torch.sum(w[:, :, None, None] * x, dim=1),
                                           torch.sum(w[:half, :, None, None] * x[:half], dim=1)),
        "min over K of [S, K]": cmp(torch.min(w, dim=1).values, torch.min(w[:half], dim=1).values),
    }
    # the whole episode: the first step whose executed actions differ
    from neurallaplacecontrol_tpu_torch.training.rollout import EpisodeSettings, make_episode_fn

    episode = make_episode_fn(env, dyn, cfg, mp, EpisodeSettings(delay=chip_smoke.DELAY, n_steps=chip_smoke.EVAL_STEPS))
    _, rec20 = episode(SeedDraws(chip_smoke.EVAL_SEEDS, device=device))
    _, rec10 = episode(SeedDraws(chip_smoke.EVAL_SEEDS, device=device).select(range(half)))
    diff = (rec20.a0[:half] != rec10.a0).flatten(2).any(dim=2).any(dim=0)  # [n_steps]
    first = int(torch.nonzero(diff)[0]) if bool(diff.any()) else None
    out["episode"] = {"first_differing_step": first, "steps": chip_smoke.EVAL_STEPS,
                      "action_gap_there": None if first is None else
                      float((rec20.a0[:half, first] - rec10.a0[:, first]).abs().max())}
    print("seed_split " + json.dumps(out), flush=True)
    return out


def main(argv) -> int:
    if argv[:1] == ["phase"]:
        run_phase()
    elif argv[:1] == ["seedsplit"]:
        seed_split()
    elif argv[:1] == ["ranks"] and len(argv) == 5:
        run_rank(int(argv[1]), int(argv[2]), Path(argv[3]), Path(argv[4]))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

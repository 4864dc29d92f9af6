"""Full experiment grid driver of the PyTorch port: {envs} x {delays} x
{models} x {seeds}, on one NVIDIA GPU.

The counterpart of run_exp_multi.py, with the same flags and defaults but
one: ``--device`` (default ``cuda``) replaces ``--platform``. Each (env,
delay, model) cell trains, or loads its
checkpoint, and evaluates all its seeds as one seed-batched episode on the
device (``training.evaluate_policy``); the grid is a sequential loop over
cells. Under ``--fused_nl_planner true`` the NL cells, their gate checks and
a sweep plan through the hand-written CUDA forward kernel.

Training is per delay (``train_model``), or, with ``--ensemble_delays
true``, one delay ensemble per (env, model) (``train_model_ensemble``). A
freshly trained draw of a gated family is control-evaluated against the
random policy (``ensemble_gate_check``): a failed ensemble draw is retrained
per delay, a failed per-delay draw (``--train_gate``) is retrained with the
next model seed. A cell that raises logs its traceback and records
``{"errored": true}`` instead of ending the run (the reference's quarantine,
run_exp_multi.py:46-56, :82-92). With ``--multihost`` the processes split the
cells round-robin, each writes ``<results>.pN``, and after a barrier process
0 merges the shards into ``--results``.

``--shard seeds|rollouts|grid:NSxNK`` evaluates every cell over the ranks of
a ``torch.distributed`` group, one process per device
(``evaluate_policy``'s shard flags). The group comes from torchrun:

    python -m torch.distributed.run --nproc_per_node L run_exp_multi_torch.py --shard rollouts

A host is the L ranks of one node. The cells split by host (round-robin, as
``--multihost`` splits them by process), each host's ranks shard its own
cells, and one rank per host writes the host's records; the records carry
``shard`` and ``shard_group_size``. A host's first rank does its training,
a delay ensemble's included, and broadcasts each cell's parameters to the
host's other ranks; an ensemble over a group of several hosts is refused,
as under ``--multihost``. With ``--multihost`` every process is a
host of one rank. A single process is a world of one, where every shard
mode is the unsharded evaluation.

Usage:
    python run_exp_multi_torch.py [--envs ...] [--delays 0,1,2,3]
        [--models nl,oracle,random,...] [--retrain true] [--fused_nl_planner true]
Results are appended to logs/results.jsonl; summarize them with
    python -m neurallaplacecontrol_tpu_torch.results.summarize logs/results.jsonl
``main`` returns this run's records and the gate checks it made.
"""

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from neurallaplacecontrol_tpu_torch.config import parse_args  # noqa: E402
from neurallaplacecontrol_tpu_torch.envs import make_env  # noqa: E402
from neurallaplacecontrol_tpu_torch.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves  # noqa: E402
from neurallaplacecontrol_tpu_torch.parallel import Mesh, multihost  # noqa: E402
from neurallaplacecontrol_tpu_torch.training import (  # noqa: E402
    evaluate_policy,
    train_model,
    train_model_ensemble,
)
from neurallaplacecontrol_tpu_torch.training.eval import EVAL_MODELS  # noqa: E402
from neurallaplacecontrol_tpu_torch.utils.device import resolve_device  # noqa: E402
from neurallaplacecontrol_tpu_torch.utils.logging import JsonlWriter, setup_logger  # noqa: E402

ENVIRONMENTS = ["oderl-pendulum", "oderl-cartpole", "oderl-acrobot"]
DELAYS = [0, 1, 2, 3]
MODELS = ["nl", "oracle", "random", "delta_t_rnn", "node", "latent_ode"]
TRAIN_SECONDS_PER_MODEL = 1350 * 6  # reference run_exp_multi.py:214
NOT_TRAINED = ("oracle", "random")


def ensemble_gate_check(
    model_name, env_name, delay, model_apply, params, config,
    *, seeds=5, margin_stds=1.0, evaluate=None, random_result=None, device="cuda",
):
    """Control-evaluate a freshly trained cell against the random policy.

    Returns ``(ok, r_model, r_random)``: ``ok`` when the model's mean return
    over ``seeds`` episodes is at least ``random_mean + margin_stds *
    random_std``. This guards against a draw that reaches the train MSE yet
    plans worse than random (training/ensemble.py). ``evaluate`` replaces
    ``evaluate_policy`` (tests plant a bad draw through it);
    ``random_result`` is a random-policy evaluation made before, which
    depends only on (env, delay, seeds, config), so the driver runs it once
    per cell.
    """
    evaluate = evaluate or evaluate_policy
    eval_seeds = list(range(seeds))
    r_m = evaluate(model_name, env_name, delay, seeds=eval_seeds, config=config, model_apply=model_apply,
                   params=params, device=device)
    r_r = random_result
    if r_r is None:
        r_r = evaluate("random", env_name, delay, seeds=eval_seeds, config=config, device=device)
    threshold = r_r["total_reward"] + margin_stds * r_r.get("total_reward_std", 0.0)
    return r_m["total_reward"] >= threshold, r_m, r_r


def _apply_of(model_name, model):
    """What evaluate_policy plans with: the latent ODE itself (carried
    history), every other family's ``apply``."""
    return model if model_name == "latent_ode" else model.apply


def _gate_record(kind, env_name, model_name, delay, attempt, model_seed, ok, r_m, r_r, margin):
    std = r_r.get("total_reward_std", 0.0)
    return {"gate": kind, "env_name": env_name, "model_name": model_name, "delay": delay, "attempt": attempt,
            "model_seed": model_seed, "ok": bool(ok), "model_return": r_m["total_reward"],
            "random_return": r_r["total_reward"], "random_std": std,
            "threshold": r_r["total_reward"] + margin * std}


def _barrier_timeout(cells, config, ns, hosts: int) -> float:
    """A barrier must outlast the slowest host: round-robin can alias with the
    model list so that one host owns every trainable cell, so the timeout
    scales with the worst per-host training load (the budget plus a
    collection and evaluation allowance per cell); an evaluation-only run
    keeps the 1 h floor."""
    if not (config.retrain or config.force_retrain):
        return 3600.0
    worst_trainable = max(
        sum(1 for c in multihost.process_slice(cells, p, hosts) if c[2] not in NOT_TRAINED) for p in range(hosts))
    return max(3600.0, worst_trainable * (ns.train_seconds + 900.0) + 1800.0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--envs", type=str, default=",".join(ENVIRONMENTS))
    parser.add_argument("--delays", type=str, default=",".join(map(str, DELAYS)))
    parser.add_argument("--models", type=str, default=",".join(MODELS))
    parser.add_argument("--results", type=str, default="logs/results.jsonl")
    parser.add_argument("--train_seconds", type=float, default=TRAIN_SECONDS_PER_MODEL)
    parser.add_argument(
        "--ensemble_delays", type=str, default="false",
        help="train all requested delays of each (env, model) as one parameter ensemble "
        "(training.ensemble) instead of one delay at a time",
    )
    parser.add_argument(
        "--ensemble_gate", type=str, default="nl",
        help="comma-separated families control-evaluated against the random policy after ensemble "
        "training; one that fails the margin is retrained per delay. The default gates only the "
        "flagship, which --ensemble_exclude also keeps out of the ensemble by default, so with both "
        "defaults the gate engages only once NL is ensemble-trained. 'none' disables.",
    )
    parser.add_argument("--ensemble_gate_seeds", type=int, default=5,
                        help="control-evaluation seeds of a gate check (both gates)")
    parser.add_argument(
        "--ensemble_gate_margin", type=float, default=1.0,
        help="gate threshold in units of the random policy's per-seed return std: a model passes "
        "at random_mean + margin * random_std or above",
    )
    parser.add_argument(
        "--train_gate", type=str, default="nl",
        help="comma-separated families control-evaluated against the random policy after per-delay "
        "training; a draw that fails the margin is retrained with model_seed + attempt. Uses the "
        "--ensemble_gate_seeds and --ensemble_gate_margin knobs. 'none' disables.",
    )
    parser.add_argument("--train_gate_retries", type=int, default=2,
                        help="reseeded retrains per cell at most when --train_gate fails; the last draw "
                        "is kept, with a warning, if all fail")
    parser.add_argument(
        "--ensemble_exclude", type=str, default="nl",
        help="families trained per delay even under --ensemble_delays true. Defaults to the "
        "flagship: the ensemble is equivalent to train_model in semantics, not in numbers",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of every cell; without CUDA pass 'cpu' (nothing drops to the "
                        "CPU on its own)")
    parser.add_argument(
        "--shard", type=str, default="none",
        help="multi-device evaluation sharding over the ranks of each host: 'seeds' splits the seed "
        "episodes, 'rollouts' each planner's K batch, 'grid:NSxNK' both on a 2-D mesh "
        "(evaluate_policy's shard flags). Launch one process per device with python -m "
        "torch.distributed.run; the random policy has no rollout batch, so its 'rollouts'/'grid' cells "
        "run unsharded (logged, and named in the record's shard_fallback). 'none' runs one process "
        "per host.",
    )
    parser.add_argument(
        "--multihost", type=str, default=None,
        help="'coordinator_host:port,N': join N processes in one torch.distributed group (launch the "
        "same command with distinct --process_id) and split the (env x delay x model) cells round-robin "
        "(parallel.multihost.process_slice). Each process writes <results>.pN; after a barrier process 0 "
        "merges the shards into --results and prints the table (a shared results directory). Every "
        "process must pass the same grid and training flags. Incompatible with --ensemble_delays.",
    )
    parser.add_argument("--process_id", type=int, default=int(os.environ.get("NLC_PROCESS_ID", "0")),
                        help="this process's index for --multihost (or env NLC_PROCESS_ID)")
    parser.add_argument(
        "--profile_trace_dir", type=str, default=None,
        help="write a torch.profiler trace of each cell's evaluation into <dir>/<env>_<model>_d<delay>/ "
        "(utils/timing.py profile_trace)",
    )
    return parser


def main(argv=None) -> dict:
    parser = build_parser()
    ns, rest = parser.parse_known_args(argv)
    config = parse_args(rest)

    # every refusal comes before any work, the process group included
    shard_kwargs = {}
    if ns.shard == "seeds":
        shard_kwargs = {"shard_seeds": True}
    elif ns.shard == "rollouts":
        shard_kwargs = {"shard_rollouts": True}
    elif ns.shard.startswith("grid:"):
        try:
            n_s, sep, n_k = ns.shard[len("grid:"):].lower().partition("x")
            shard_grid = (int(n_s), int(n_k))
            if not sep or min(shard_grid) < 1:
                raise ValueError(shard_grid)
        except ValueError:
            parser.error(f"--shard grid axes must be positive ints 'grid:NSxNK', got {ns.shard!r}")
        shard_kwargs = {"shard_grid": shard_grid}
    elif ns.shard != "none":
        parser.error(f"--shard must be none|seeds|rollouts|grid:NSxNK, got {ns.shard!r}")
    ranks_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if multihost.under_torchrun() else 1
    if multihost.under_torchrun() and ns.multihost:
        parser.error("--multihost names a group, and so does torchrun's environment: pass one")
    if ranks_per_host > 1 and not shard_kwargs:
        parser.error(f"a host of {ranks_per_host} ranks evaluates with --shard; with 'none' every rank "
                     "would run the same cells")
    hosts = int(os.environ.get("WORLD_SIZE", "1")) // ranks_per_host if multihost.under_torchrun() else 1
    if hosts > 1 and ns.ensemble_delays.lower() == "true" and len(ns.delays.split(",")) > 1:
        parser.error(f"--ensemble_delays trains on one host, and torchrun's group spans {hosts}: the ensemble "
                     "couples delays across cells (as under --multihost)")
    envs = ns.envs.split(",")
    delays = [int(d) for d in ns.delays.split(",")]
    models = ns.models.split(",")
    unknown = [m for m in models if m not in EVAL_MODELS]
    if unknown:
        parser.error(f"--models: {unknown} not among {list(EVAL_MODELS)}")
    device = str(resolve_device(ns.device))

    if multihost.under_torchrun():
        multihost.initialize(device=device)
    pid, pcount = 0, 1
    if ns.multihost:
        addr, _, n = ns.multihost.partition(",")
        if not n:
            parser.error("--multihost must be 'coordinator_host:port,N'")
        # the ensemble engages only with more than one delay
        if ns.ensemble_delays.lower() == "true" and len(delays) > 1:
            parser.error("--multihost is incompatible with --ensemble_delays "
                         "(ensemble training couples delays across cells)")
        multihost.initialize(addr, int(n), ns.process_id, device=device)
    # the cells split by host, and each host's ranks shard its cells: a
    # host's first rank writes its records and does its training
    pid, pcount = multihost.host_index(), multihost.host_count()
    host_ranks = multihost.host_ranks()
    writer = multihost.process_index() == host_ranks[0]
    if shard_kwargs and multihost.process_count() > 1:
        shard_kwargs["devices"] = host_ranks

    logger = setup_logger(__file__, log_folder=config.log_folder)
    results_path = ns.results if pcount == 1 else f"{ns.results}.p{pid}"
    if pcount > 1 and writer:
        # the shard is per-run scratch: JsonlWriter appends, so a shard left
        # by an earlier (or aborted) run would be merged again as duplicates
        Path(results_path).unlink(missing_ok=True)
    results = JsonlWriter(results_path) if writer else None
    seeds = list(range(config.seed_start, config.seed_start + config.seed_runs))
    run_records = []  # this run's records (the JSONL file is append-mode)
    gate_log = []  # every gate check of this run

    cells = [(e, d, m) for e in envs for d in delays for m in models]
    owned_cells = None
    if pcount > 1:
        owned_cells = set(multihost.process_slice(cells, pid, pcount))
        logger.info("[multihost] process %d/%d owns %d/%d grid cells", pid, pcount, len(owned_cells), len(cells))

    def owned(env_name, delay, model_name) -> bool:
        return owned_cells is None or (env_name, delay, model_name) in owned_cells

    def gate(kind, env_name, model_name, delay, apply, params, attempt, model_seed, cache):
        ok, r_m, r_r = ensemble_gate_check(
            model_name, env_name, delay, apply, params, config, seeds=ns.ensemble_gate_seeds,
            margin_stds=ns.ensemble_gate_margin, random_result=cache.get((env_name, delay)), device=device)
        cache[(env_name, delay)] = r_r
        gate_log.append(_gate_record(kind, env_name, model_name, delay, attempt, model_seed, ok, r_m, r_r,
                                     ns.ensemble_gate_margin))
        return ok, r_m, r_r

    def train(model_name, env_name, delay, model_seed, fresh):
        """train_model for one cell; ``fresh``: a gate's retrain, from the init."""
        return train_model(
            model_name, env_name, config, delay=delay, retrain=True,
            force_retrain=True if fresh else config.force_retrain, model_seed=model_seed,
            start_from_checkpoint=False if fresh else config.start_from_checkpoint,
            end_training_after_seconds=ns.train_seconds, device=device,
        )

    trained = {}
    use_ensemble = ns.ensemble_delays.lower() == "true" and len(delays) > 1
    excluded = set(ns.ensemble_exclude.lower().split(",")) if use_ensemble else set()
    ens_models = [m for m in models if m not in excluded] if use_ensemble else []
    seq_models = [m for m in models if m not in ens_models]
    if (config.retrain or config.force_retrain) and use_ensemble and writer:
        gated_families = set(ns.ensemble_gate.lower().split(","))
        if not gated_families.intersection(ens_models):
            logger.warning("--ensemble_gate %s gates none of the ensemble-trained families %s (the gated "
                           "families train per delay through --ensemble_exclude): no bad-draw protection "
                           "this run", ns.ensemble_gate, ens_models)
        random_cache = {}  # (env, delay) -> random-policy evaluation
        for env_name in envs:
            for model_name in ens_models:
                if model_name in NOT_TRAINED:
                    continue
                try:
                    t0 = time.time()
                    out = train_model_ensemble(
                        model_name, env_name, config, delays=delays, retrain=True,
                        force_retrain=config.force_retrain, model_seed=config.model_seed,
                        start_from_checkpoint=config.start_from_checkpoint,
                        end_training_after_seconds=ns.train_seconds, device=device,
                    )
                    for delay, (model, params, res) in out.items():
                        trained[(env_name, delay, model_name)] = (model, params)
                        logger.info("[trained %s %s d=%d] loss=%g (ensemble, %.0fs)", env_name, model_name, delay,
                                    res["best_val_loss"], time.time() - t0)
                    if model_name not in gated_families:
                        continue
                    for delay in list(out):
                        model, params = trained[(env_name, delay, model_name)]
                        ok, r_m, r_r = gate("ensemble", env_name, model_name, delay, _apply_of(model_name, model),
                                            params, 0, config.model_seed, random_cache)
                        if ok:
                            continue
                        logger.warning("[ensemble gate %s %s d=%d] model fails the random-control margin "
                                       "(%.1f < %.1f + %g*%.1f): retraining individually", env_name, model_name,
                                       delay, r_m["total_reward"], r_r["total_reward"], ns.ensemble_gate_margin,
                                       r_r.get("total_reward_std", 0.0))
                        model, params, res = train(model_name, env_name, delay, config.model_seed, fresh=True)
                        trained[(env_name, delay, model_name)] = (model, params)
                        logger.info("[trained %s %s d=%d] loss=%g (gate retrain)", env_name, model_name, delay,
                                    res["best_val_loss"])
                except Exception:  # noqa: BLE001 -- the quarantine (reference :46-56)
                    logger.error("[train FAILED %s %s ensemble]\n%s", env_name, model_name, traceback.format_exc())

    if (config.retrain or config.force_retrain) and writer:
        # per-delay training: every model when not ensembling, and the
        # --ensemble_exclude families (by default the NL flagship)
        train_gated = set(ns.train_gate.lower().split(",")) - {"none", ""}
        gate_rand_cache = {}  # (env, delay) -> random-policy evaluation
        for env_name in envs:
            for delay in delays:
                for model_name in seq_models:
                    if model_name in NOT_TRAINED or not owned(env_name, delay, model_name):
                        continue
                    try:
                        t0 = time.time()
                        model, params, res = train(model_name, env_name, delay, config.model_seed, fresh=False)
                        logger.info("[trained %s %s d=%d] loss=%g (%.0fs)", env_name, model_name, delay,
                                    res["best_val_loss"], time.time() - t0)
                        if model_name in train_gated:
                            # the bad-draw gate of the main training path: a
                            # draw can reach the train MSE yet plan below random
                            for attempt in range(ns.train_gate_retries + 1):
                                seed = config.model_seed + attempt
                                ok, r_m, r_r = gate("train", env_name, model_name, delay,
                                                    _apply_of(model_name, model), params, attempt, seed,
                                                    gate_rand_cache)
                                if ok:
                                    break
                                if attempt == ns.train_gate_retries:
                                    logger.warning("[train gate %s %s d=%d] all %d reseeded retrains failed the "
                                                   "random-control margin: keeping the last draw", env_name,
                                                   model_name, delay, ns.train_gate_retries)
                                    break
                                logger.warning("[train gate %s %s d=%d] draw fails the random-control margin "
                                               "(%.1f < %.1f + %g*%.1f): retraining with model_seed=%d", env_name,
                                               model_name, delay, r_m["total_reward"], r_r["total_reward"],
                                               ns.ensemble_gate_margin, r_r.get("total_reward_std", 0.0), seed + 1)
                                model, params, res = train(model_name, env_name, delay, seed + 1, fresh=True)
                        trained[(env_name, delay, model_name)] = (model, params)
                    except Exception:  # noqa: BLE001 -- the quarantine (reference :46-56)
                        logger.error("[train FAILED %s %s d=%d]\n%s", env_name, model_name, delay,
                                     traceback.format_exc())

    host_group = Mesh(host_ranks, ("host",), device=device).group() if len(host_ranks) > 1 else None
    if (config.retrain or config.force_retrain) and host_group is not None:
        # the other ranks wait out their first rank's training here, not in a
        # collective, whose timeout is the group's
        multihost.barrier("nlc_grid_train_done", timeout_s=_barrier_timeout(cells, config, ns, pcount))

    def cell_model(env_name, delay, model_name):
        """(model, params) of a learned cell: the host's first rank trains or
        loads them, and hands them to the host's other ranks."""
        got, err = None, None
        if writer:
            try:
                got = trained.get((env_name, delay, model_name)) or train_model(
                    model_name, env_name, config, delay=delay, retrain=False, model_seed=config.model_seed,
                    device=device)[:2]
            except Exception as e:  # noqa: BLE001 -- raised on every rank of the host below
                err = e
        if host_group is None:
            if err is not None:
                raise err
            return got
        ok = torch.tensor([err is None], dtype=torch.int32, device=device)
        dist.broadcast(ok, src=host_ranks[0], group=host_group)
        if not bool(ok):
            raise err if err is not None else RuntimeError(
                f"rank {host_ranks[0]} of this host found no parameters for the cell")
        if not writer:
            spec = make_env(env_name).spec
            model = make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, config, device=device)
            got = (model, model.init(torch.Generator(device=device).manual_seed(config.model_seed)))
        for x in tree_leaves(got[1]):
            dist.broadcast(x, src=host_ranks[0], group=host_group)
        return got

    for env_name, delay, model_name in cells:
        if not owned(env_name, delay, model_name):
            continue
        try:
            extra = {}
            if model_name not in NOT_TRAINED:
                model, params = cell_model(env_name, delay, model_name)
                extra = dict(model_apply=_apply_of(model_name, model), params=params)
            if ns.profile_trace_dir:
                extra["profile_trace_dir"] = f"{ns.profile_trace_dir}/{env_name}_{model_name}_d{delay}"
            r = evaluate_policy(model_name, env_name, delay, seeds=seeds, config=config, device=device, **extra,
                                **shard_kwargs)
            if shard_kwargs:
                r["shard"], r["shard_group_size"] = ns.shard, r.get("shard_group_size", len(host_ranks))
            r["errored"] = False
            if writer:
                results.write(r)
            run_records.append(r)
            logger.info("[Model Completed evaluation mppi] %s", {
                k: r[k] for k in ("model_name", "env_name", "delay", "total_reward", "total_reward_std")})
        except Exception:  # noqa: BLE001 -- the quarantine (reference :82-92)
            logger.error("[eval FAILED %s %s d=%d]\n%s", env_name, model_name, delay, traceback.format_exc())
            rec = {"model_name": model_name, "env_name": env_name, "delay": delay, "errored": True}
            if writer:
                results.write(rec)
            run_records.append(rec)

    if pcount > 1:
        multihost.barrier("nlc_grid_eval_done", timeout_s=_barrier_timeout(cells, config, ns, pcount))
    if not writer or (pcount > 1 and pid != 0):
        logger.info("Fin (process %d; shard %s).", multihost.process_index(), results_path)
        return {"records": run_records, "gates": gate_log}
    if pcount > 1:
        # parse every shard before writing or unlinking anything: a torn line
        # (a writer killed) fails the merge before any shard is consumed
        shard_records = []
        for i in range(pcount):
            shard = Path(f"{ns.results}.p{i}")
            if not shard.exists():  # a process can own no cell
                continue
            shard_records.append((shard, [json.loads(line) for line in shard.read_text().splitlines()]))
        merged = JsonlWriter(ns.results)
        run_records = []
        for shard, recs in shard_records:
            for rec in recs:
                merged.write(rec)
                run_records.append(rec)
            shard.unlink()  # consumed: a later run must not merge it again
        logger.info("[multihost] merged %d records from %d shards into %s", len(run_records), pcount, ns.results)

    # the table over this run's records only (the results file is
    # append-mode and may hold earlier runs with other configs)
    from neurallaplacecontrol_tpu_torch.results.process import latex_table

    recs = [r for r in run_records if not r.get("errored")]
    if recs:
        try:
            logger.info("Normalized-return table:\n%s", latex_table(recs))
        except Exception:  # noqa: BLE001 -- the table must not end a finished run
            logger.error("summary table failed\n%s", traceback.format_exc())
    logger.info("Fin.")
    return {"records": run_records, "gates": gate_log}


if __name__ == "__main__":
    main()

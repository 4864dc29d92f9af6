"""Probe: NL rollouts/s against the number of seeds run in lockstep, on the
GPU (the port's counterpart of ``scripts/bench_episode_batch.py``).

    python3 scripts/bench_episode_batch_torch.py [--counts 8,16,20] [--device cuda]

Runs ``training.evaluate_policy`` for NL on cartpole with delay 1 (the
trained checkpoint of ``artifacts/checkpoints/``, K=1000, T=40, 200 steps)
through the hand-written forward kernel (``Config.fused_nl_planner``), once
per seed count: each horizon step is one forward launch of count x K rows.
Prints one JSON line per count: ``episodes``, ``mppi_rollouts_per_sec`` and
``episode_elapsed_time`` (the JAX script's quantities), ``device`` and
``power_limit_w``. ``--device cpu`` with small ``--k``/``--t`` and a large
``--dt`` runs it on the CPU through the kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENV, DELAY = "oderl-cartpole", 1


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--counts", default="8,16,20")
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--t", type=int, default=40)
    ap.add_argument("--dt", type=float, default=None, help="the env step (Config().dt by default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint
    from neurallaplacecontrol_tpu_torch.utils.device import card

    config = Config(fused_nl_planner=True) if args.dt is None else Config(fused_nl_planner=True, dt=args.dt)
    spec = make_env(ENV, dt=config.dt).spec
    model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, config, device=args.device)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)),
                         device=args.device)
    where = card(args.device)
    rows = []
    for n in (int(c) for c in args.counts.split(",")):
        r = evaluate_policy("nl", ENV, DELAY, list(range(n)), config, model_apply=model.apply, params=params,
                            roll_outs=args.k, time_steps=args.t, device=args.device)
        rows.append({"episodes": n, "K": args.k, "T": args.t,
                     "mppi_rollouts_per_sec": r["mppi_rollouts_per_sec"],
                     "episode_elapsed_time": r["episode_elapsed_time"], **where})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

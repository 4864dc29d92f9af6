"""bf16 NL compute on the GPU: speed and planning accuracy (the port's
counterpart of ``scripts/bench_bf16.py``).

    python3 scripts/bench_bf16_torch.py [--seeds 8] [--first_seed 0] [--routes plain] [--k 1000 --t 40]

Runs ``evaluate_policy`` for the trained cartpole-d1 NL (K=1000, T=40, 200
steps by default) over seeds ``first_seed .. first_seed + seeds - 1`` with
``nl_compute_dtype`` float32 and bfloat16, on the plain route (the GRU and
trunk GEMMs in bf16, the sphere map and the ILT in f32; ``models.nl``) and,
with ``--routes plain,kernel``, on the fused kernel route too (which packs
f32 weights whatever the dtype). Prints one JSON line per batch (rollouts/s,
returns, the card's name and power limit) and a last line with the bf16/f32
speedup and return delta per route. Needs a CUDA device; ``--device cpu``
runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ENV, DELAY = "oderl-cartpole", 1


def card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--first_seed", type=int, default=0)
    ap.add_argument("--routes", default="plain")
    ap.add_argument("--k", type=int, default=1000)
    ap.add_argument("--t", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    smi = card(args.device)
    seeds = list(range(args.first_seed, args.first_seed + args.seeds))
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)),
                         device=args.device)
    spec = make_env(ENV).spec
    results = {}
    for route in args.routes.split(","):
        for dtype in ("float32", "bfloat16"):
            cfg = Config(nl_compute_dtype=dtype, fused_nl_planner=route == "kernel")
            model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, cfg, device=args.device)
            r = evaluate_policy("nl", ENV, DELAY, seeds, cfg, model_apply=model.apply, params=params,
                                roll_outs=args.k, time_steps=args.t, device=args.device)
            rec = {"route": route, "dtype": dtype, "K": args.k, "T": args.t, "seeds": seeds, "rollouts_per_sec": r["mppi_rollouts_per_sec"],
                   "episode_batch_s": r["episode_elapsed_time"], "total_reward": r["total_reward"],
                   "total_reward_std": r["total_reward_std"], "total_rewards": r["total_rewards"], "card": smi}
            results[(route, dtype)] = rec
            print(json.dumps(rec), flush=True)
    summary = {"card": smi, "seeds": seeds}
    for route in args.routes.split(","):
        f32, bf16 = results[(route, "float32")], results[(route, "bfloat16")]
        diff = np.asarray(bf16["total_rewards"]) - np.asarray(f32["total_rewards"])
        summary[route] = {"speedup": bf16["rollouts_per_sec"] / f32["rollouts_per_sec"],
                          "return_delta": bf16["total_reward"] - f32["total_reward"],
                          "paired_delta_std": float(diff.std(ddof=1)) if len(diff) > 1 else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

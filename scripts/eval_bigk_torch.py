"""Big-K policy evaluation on the GPU: NL cartpole d1 with K=16,384 rollouts
(the port's counterpart of ``scripts/eval_bigk.py``).

    python3 scripts/eval_bigk_torch.py [--roll_outs 16384] [--dtype float32|bfloat16] [--device cuda]

Runs ``training.evaluate_policy`` for NL on cartpole with delay 1 over seeds
0-1, the weights the tracked checkpoint of ``artifacts/checkpoints/``, through
the hand-written forward kernel (``Config.fused_nl_planner``): each horizon
step is one launch over 2 x K rows. ``--dtype bfloat16`` builds the model with
``nl_compute_dtype="bfloat16"``; the kernel route packs the weights in f32
all the same, and the record says so in ``route``. Appends one JSON record to
``--out`` (``artifacts/port/results_bigk_h100.jsonl``, never the JAX run's
``artifacts/results_bigk.jsonl``): ``evaluate_policy``'s record with
``nl_compute_dtype``, ``route``, ``nl_forward_launches`` and the card's name and
power limit, and prints the JAX script's summary keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "artifacts", "port", "results_bigk_h100.jsonl")
ENV, DELAY, SEEDS = "oderl-cartpole", 1, [0, 1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roll_outs", type=int, default=16384)
    ap.add_argument("--time_steps", type=int, default=None)
    ap.add_argument("--dt", type=float, default=None, help="the env step (Config().dt by default)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.ops import pallas_nl
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint
    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(args.device)
    cfg = Config(nl_compute_dtype=args.dtype, fused_nl_planner=True)
    if args.dt is not None:
        cfg = cfg.replace(dt=args.dt)
    spec = make_env(ENV, dt=cfg.dt).spec
    model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, cfg, device=device)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True), repo_root=ROOT),
                         device=device)
    pallas_nl.nl_forward_fused.launches = 0
    r = evaluate_policy("nl", ENV, DELAY, SEEDS, cfg, model_apply=model.apply, params=params,
                        roll_outs=args.roll_outs, time_steps=args.time_steps, device=device)
    r["nl_compute_dtype"] = args.dtype
    # the fused route packs float32 whatever the model's compute dtype
    r["route"] = "kernel (f32 pack)" if args.dtype != "float32" else "kernel"
    r["nl_forward_launches"] = pallas_nl.nl_forward_fused.launches
    r["card"] = card(device)
    r["errored"] = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(r) + "\n")
    summary = {k: r[k] for k in ("model_name", "env_name", "delay", "roll_outs", "total_reward",
                                 "mppi_rollouts_per_sec", "nl_compute_dtype", "route", "nl_forward_launches",
                                 "card")}
    print(json.dumps(summary), flush=True)
    return r


if __name__ == "__main__":
    main()

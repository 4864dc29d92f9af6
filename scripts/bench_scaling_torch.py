"""Planner throughput against K on one GPU (the port's counterpart of
``scripts/bench_scaling.py``).

    python3 scripts/bench_scaling_torch.py [--ks 1000,4096,16384,65536,262144] [--routes kernel,plain]
        [--reps 20] [--dtype float32] [--device cuda]

One ``planners.mppi_command`` per K (T=40) with the NL dynamics of the
trained cartpole-d1 checkpoint in the loop: through the hand-written forward
kernel (route ``kernel``, ``Config.fused_nl_planner``) and through the plain
PyTorch forward (route ``plain``; ``--dtype bfloat16`` runs its GRU and trunk
in bf16). Steady-state planning, not episodes: two warm-up plans, then
``--reps`` plans timed to the device's end. Prints one JSON line per (route,
K): ``K``, ``T``, ``ms_per_plan``, ``rollouts_per_s``,
``model_forwards_per_s`` (the JAX script's quantities), ``route``,
``dtype``, ``device`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

ENV, DELAY = "oderl-cartpole", 1


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ks", default="1000,4096,16384,65536,262144")
    ap.add_argument("--t", type=int, default=40)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--routes", default="kernel,plain")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.planners import mppi_command, mppi_reset
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint
    from neurallaplacecontrol_tpu_torch.utils.device import card

    dev = torch.device(args.device)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)), device=dev)
    where = card(dev)
    rows = []
    for route in args.routes.split(","):
        config = Config(fused_nl_planner=route == "kernel", nl_compute_dtype=args.dtype)
        spec = make_env(ENV, dt=config.dt).spec
        model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, config, device=dev)
        for K in (int(k) for k in args.ks.split(",")):
            env, cfg, mparams, dynamics, _, _ = build_planner("nl", ENV, DELAY, config, model_apply=model.apply,
                                                              params=params, roll_outs=K, time_steps=args.t,
                                                              device=dev)
            cost = build_running_cost(env)
            g = torch.Generator(device=dev).manual_seed(1)
            obs = env.observe(env.reset(g, device=dev))
            buf = torch.zeros((config.action_buffer_size, spec.m), device=dev)
            U = mppi_reset(g, cfg, mparams)
            for _ in range(2):
                a, U, _ = mppi_command(cfg, mparams, dynamics, cost, U, obs, buf, generator=g)
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                a, U, _ = mppi_command(cfg, mparams, dynamics, cost, U, obs, buf, generator=g)
            sync(dev)
            dt_cmd = (time.perf_counter() - t0) / args.reps
            if not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"route {route} at K={K}: a non-finite action")
            rows.append({"route": route, "dtype": args.dtype, "K": K, "T": args.t, "ms_per_plan": 1e3 * dt_cmd,
                         "rollouts_per_s": K / dt_cmd, "model_forwards_per_s": K * args.t / dt_cmd, **where})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

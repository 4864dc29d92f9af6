"""The int8 NL planner forward on the GPU: control quality and speed beside
float32 and bfloat16 (the port's counterpart of ``scripts/bench_int8.py``).

    python3 scripts/bench_int8_torch.py --mode quality [--k 200 --t 40 --seeds 4]
    python3 scripts/bench_int8_torch.py --mode perf [--ks 16384,65536 --iters 20]

``quality``: the episode returns of the int8 apply (``ops.quant``, the
horizon folded) against the f32 apply on the same seeds, and
``planner_saturation_probe``'s clip fractions. ``perf``: one plan's latency
over a K sweep for the variants float32, bfloat16, f32_fold (the fold with
no int8: the fold's own share), int8_fold and, on the port only, the f32
forward kernel route (``fused_nl_planner``). A plan ends when its action is
read on the host. Prints one JSON line per measurement with the card's name
and power limit. Needs a CUDA device; ``--device cpu`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def card(device: str) -> str:
    if device == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def flagship(env_name: str, delay: int, device):
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    cfg = Config()
    env = make_env(env_name, dt=cfg.dt)
    spec = env.spec
    model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, cfg, device=device)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", env_name, delay, "exp", 0, True)),
                         device=device)
    return cfg, env, spec, model, params


def mode_quality(args, smi: str):
    from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
    from neurallaplacecontrol_tpu_torch.ops.quant import planner_saturation_probe, quantized_apply_for
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy

    cfg, env, spec, model, params = flagship(args.env, args.delay, args.device)
    norm = norm_stats_for(args.env, spec.action_high, spec.m)
    obs0 = env.observe(env.reset(torch.Generator().manual_seed(0))).to(args.device)
    sat = planner_saturation_probe(
        model.apply, params, norm, obs0, action_high=spec.action_high, action_dim=spec.m, K=min(args.k, 256),
        T=args.t, dt=cfg.dt, generator=torch.Generator(device=args.device).manual_seed(1),
        action_buffer_size=cfg.action_buffer_size)
    seeds = list(range(args.seeds))
    common = dict(params=params, roll_outs=args.k, time_steps=args.t, device=args.device)
    res_f32 = evaluate_policy("nl", args.env, args.delay, seeds, cfg, model_apply=model.apply, **common)
    qapply = quantized_apply_for("nl", args.env, params, cfg, spec, fold_t=float(cfg.dt))
    res_int8 = evaluate_policy("nl", args.env, args.delay, seeds, cfg, model_apply=qapply, **common)
    print(json.dumps({
        "mode": "quality", "env": args.env, "delay": args.delay, "k": args.k, "t": args.t, "seeds": args.seeds,
        "f32_total_reward": res_f32["total_reward"], "int8_total_reward": res_int8["total_reward"],
        "f32_per_seed": res_f32["total_rewards"], "int8_per_seed": res_int8["total_rewards"],
        "f32_episode_batch_s": res_f32["episode_elapsed_time"],
        "int8_episode_batch_s": res_int8["episode_elapsed_time"],
        "obs_saturation": {"clip_frac_mean": sat["clip_frac_mean"], "clip_frac_max": sat["clip_frac_max"],
                           "clip_frac_final_step": sat["clip_frac_per_step"][-1]},
        "card": smi,
    }), flush=True)


def mode_perf(args, smi: str):
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.ops.quant import quantized_apply_for
    from neurallaplacecontrol_tpu_torch.serving import make_controller

    base, env, spec, model, params = flagship(args.env, args.delay, args.device)
    bf16_cfg = Config(nl_compute_dtype="bfloat16")
    variants = {  # the configuration and apply of each; built once, swept over K
        "float32": (base, model.apply),
        "bfloat16": (bf16_cfg, make_model("nl", args.env, spec.n_obs, spec.m, spec.action_high, bf16_cfg,
                                          device=args.device).apply),
        "f32_fold": (base, quantized_apply_for("nl", args.env, params, base, spec, quantize_gru=False,
                                               mlp_int8_layers=(), fold_t=float(base.dt))),
        "int8_fold": (base, quantized_apply_for("nl", args.env, params, base, spec, fold_t=float(base.dt))),
        "f32_kernel": (base.replace(fused_nl_planner=True), model.apply),
    }
    obs = env.observe(env.reset(torch.Generator().manual_seed(0))).to(args.device)
    for K in (int(k) for k in args.ks.split(",")):
        noise = None
        for name, (cfg, apply) in variants.items():
            ctrl = make_controller("nl", args.env, args.delay, cfg, model_apply=apply, params=params, roll_outs=K,
                                   time_steps=args.t, device=args.device)
            if noise is None:  # one draw for every variant
                g = torch.Generator(device=args.device).manual_seed(0)
                noise = torch.randn((K, args.t, spec.m), generator=g, device=args.device) @ ctrl.mppi_params.noise_chol.T
            state = ctrl.reset(0)
            ctrl.step(state, obs, noise=noise)[0].cpu()  # warm-up: builds, caches
            t0 = time.perf_counter()
            for _ in range(args.iters):
                ctrl.step(state, obs, noise=noise)[0].cpu()
            sec = (time.perf_counter() - t0) / args.iters
            print(json.dumps({"mode": "perf", "variant": name, "K": K, "T": args.t, "sec_per_plan": sec,
                              "rollouts_per_sec": K / sec, "card": smi}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("quality", "perf"), required=True)
    ap.add_argument("--env", default="oderl-cartpole")
    ap.add_argument("--delay", type=int, default=1)
    ap.add_argument("--k", type=int, default=200)  # quality mode's planner K
    ap.add_argument("--t", type=int, default=40)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--ks", default="16384,65536")  # perf mode's K sweep
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    smi = card(args.device)
    if args.mode == "quality":
        mode_quality(args, smi)
    else:
        mode_perf(args, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

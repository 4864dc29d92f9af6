"""The hand-written CUDA kernels against their plain PyTorch versions on the
GPU, at three levels (the port's counterpart of ``scripts/bench_pallas.py``).

    python3 scripts/bench_pallas_torch.py [--device cuda] [--out artifacts/port/bench_kernels_h100.json]

1. head: ``ops.pallas_ilt.nl_head_fused`` (the theta/phi head and the
   fourier combine, kernel 2) against ``nl_head_plain``, B = 1,024, 16,384,
   131,072, on seeded random head weights;
2. forward: ``ops.pallas_nl.nl_forward_fused`` (the planner-side NL forward,
   kernel 1) against the model's plain ``apply``, B = 1,000, 16,384,
   131,072, on cartpole at the default width;
3. planner: one ``mppi_command`` (K rollouts x T=40) with the kernel's
   dynamics against the plain forward's, K = 1,000, 16,384, 65,536.

Each is timed in steady state (CUDA events around ``--reps`` calls after a
warm-up). The records keep the JAX script's keys: ``xla_*`` is the plain
PyTorch route here and ``pallas_*`` the CUDA kernel's. Each also carries
``device`` and ``power_limit_w``. Writes the records as JSON to ``--out``
and prints one JSON line per record. The kernels are built from
``neurallaplacecontrol_tpu_torch/csrc/nl_kernels.cu`` with ``nvcc`` at the
first call; the CPU has no kernel (use ``--device cpu`` to run the plain
versions against themselves, as a harness check).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENV, DELAY = "oderl-cartpole", 1


def timeit(fn, device, reps=100) -> float:
    """Seconds per call of ``fn``."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def bench_head(results, device, where, sizes=(1024, 16384, 131072), reps=100):
    from neurallaplacecontrol_tpu_torch.ops import pallas_ilt

    D, terms, H, t = 5, 17, 128, 0.125
    rng = np.random.default_rng(0)
    w = rng.standard_normal((H, 2 * D * terms)).astype(np.float32) * 0.05
    b = rng.standard_normal(2 * D * terms).astype(np.float32) * 0.05
    head = pallas_ilt.to_device(pallas_ilt.pack_head_weights(w, b, D, terms, t), device)
    hopper = torch.as_tensor(pallas_ilt.repack_head(head, D, terms), device=device) if device.type == "cuda" else None
    for B in sizes:
        x = torch.as_tensor(rng.standard_normal((B, H)), dtype=torch.float32, device=device)
        plain = lambda: pallas_ilt.nl_head_plain(x, head, D)  # noqa: E731
        fused = lambda: pallas_ilt.nl_head_fused(x, head, D, terms=terms, hopper=hopper)  # noqa: E731
        xla_t, pal_t = timeit(plain, device, reps), timeit(fused, device, reps)
        rec = dict(level="head", B=B, xla_us=xla_t * 1e6, pallas_us=pal_t * 1e6, speedup=xla_t / pal_t,
                   maxdiff=float((plain() - fused()).abs().max()), **where)
        results.append(rec)
        print(json.dumps(rec), flush=True)


def bench_forward_and_planner(results, device, where, sizes=(1000, 16384, 131072), ks=(1000, 16384, 65536),
                              reps=100):
    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.planners import mppi_command, mppi_reset
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    config = Config()
    spec = make_env(ENV).spec
    model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, config, device=device)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True)), device=device)
    fused_apply = model.make_fused_planner_apply(params, config.dt)
    g = torch.Generator(device=device).manual_seed(5)
    for B in sizes:
        obs = torch.randn((B, spec.n_obs), generator=g, device=device)
        abuf = (torch.rand((B, 4, spec.m), generator=g, device=device) * 2 - 1) * spec.action_high
        ts = torch.full((B, 1), config.dt, device=device)
        plain = lambda: model.apply(params, obs, abuf, ts)  # noqa: E731
        fused = lambda: fused_apply(params, obs, abuf, ts)  # noqa: E731
        xla_t, pal_t = timeit(plain, device, reps), timeit(fused, device, reps)
        a, c = plain(), fused()
        rec = dict(level="forward", B=B, xla_us=xla_t * 1e6, pallas_us=pal_t * 1e6, speedup=xla_t / pal_t,
                   max_rel_diff=float(((a - c).abs() / (1.0 + a.abs())).max()), **where)
        results.append(rec)
        print(json.dumps(rec), flush=True)

    for K in ks:
        plans = {}
        for route in ("xla", "pallas"):
            cfg_r = config.replace(fused_nl_planner=route == "pallas")
            env, cfg, mparams, dynamics, _, _ = build_planner("nl", ENV, DELAY, cfg_r, model_apply=model.apply,
                                                              params=params, roll_outs=K, time_steps=40,
                                                              device=device)
            cost = build_running_cost(env)
            obs1 = env.observe(env.reset(torch.Generator(device=device).manual_seed(1), device=device))
            buf = torch.zeros((4, spec.m), device=device)
            U = mppi_reset(torch.Generator(device=device).manual_seed(2), cfg, mparams)
            noise = torch.randn((K, 40, spec.m), generator=torch.Generator(device=device).manual_seed(3),
                                device=device) @ mparams.noise_chol.T

            def plan(cfg=cfg, mparams=mparams, dynamics=dynamics, cost=cost, obs1=obs1, buf=buf, U=U, noise=noise):
                return mppi_command(cfg, mparams, dynamics, cost, U.clone(), obs1, buf, noise=noise)[0]

            plans[route] = (plan, timeit(plan, device, 50 if K <= 16384 else 20))
        (p_x, xla_t), (p_p, pal_t) = plans["xla"], plans["pallas"]
        rec = dict(level="planner", K=K, T=40, xla_ms=xla_t * 1e3, pallas_ms=pal_t * 1e3,
                   xla_rollouts_per_s=K / xla_t, pallas_rollouts_per_s=K / pal_t, speedup=xla_t / pal_t,
                   action_diff=float((p_x() - p_p()).abs().max()), **where)
        results.append(rec)
        print(json.dumps(rec), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(ROOT / "artifacts" / "port" / "bench_kernels_h100.json"))
    ap.add_argument("--head_sizes", default="1024,16384,131072")
    ap.add_argument("--forward_sizes", default="1000,16384,131072")
    ap.add_argument("--ks", default="1000,16384,65536")
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in f32, as chip_smoke holds them
    where = card(device)
    results = []
    sizes = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
    bench_head(results, device, where, sizes(args.head_sizes), args.reps)
    bench_forward_and_planner(results, device, where, sizes(args.forward_sizes), sizes(args.ks), args.reps)
    out = {"device": where["device"], "power_limit_w": where["power_limit_w"], "torch": torch.__version__,
           "results": results}
    if not all(math.isfinite(v) for r in results for v in r.values() if isinstance(v, float)):
        raise RuntimeError("a non-finite measurement")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print("wrote", args.out, flush=True)
    return out


if __name__ == "__main__":
    main()

"""JAX reference returns for phase ``precision`` of the PyTorch port's smoke run.

    JAX_PLATFORMS=cpu python scripts/port_jax_precision_reference.py

Runs the JAX package's own ``evaluate_policy`` for NL on cartpole with delay 1
(K=1000, T=40, 200 steps, seeds 0-19, the tracked checkpoint) on the CPU in
the two reduced precisions: ``nl_compute_dtype="bfloat16"`` on the plain
route, and the int8 forward of ``ops.quant.quantized_apply_for`` with the
planner's horizon folded (``fold_t=dt``). Writes every return, the wall time,
the commit and the command to
``artifacts/port/jax_eval_cartpole_d1_precision.json``, which
``chip_smoke.py`` reads, since the GPU machine has no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from neurallaplacecontrol_tpu.config import Config  # noqa: E402
from neurallaplacecontrol_tpu.envs import make_env  # noqa: E402
from neurallaplacecontrol_tpu.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu.ops.quant import quantized_apply_for  # noqa: E402
from neurallaplacecontrol_tpu.training import evaluate_policy, train_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_eval_cartpole_d1_precision.json")
ENV, DELAY, SEEDS = "oderl-cartpole", 1, list(range(20))
FIELDS = ("total_rewards", "total_reward", "total_reward_std", "episode_elapsed_time",
          "roll_outs", "time_steps", "dt")


def main() -> int:
    cfg = Config()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    _, params, _ = train_model("nl", ENV, cfg, delay=DELAY, retrain=False)
    spec = make_env(ENV, dt=cfg.dt).spec
    bf16_cfg = cfg.replace(nl_compute_dtype="bfloat16")
    routes = {
        "bf16": (bf16_cfg, make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, bf16_cfg).apply),
        "int8": (cfg, quantized_apply_for("nl", ENV, params, cfg, spec, fold_t=float(cfg.dt))),
    }
    out = {
        "env": ENV, "delay": DELAY, "seeds": SEEDS, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_precision_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "config": "Config() defaults; bf16: nl_compute_dtype='bfloat16'; int8: quantized_apply_for(fold_t=dt)",
        "policies": {},
    }
    for name, (route_cfg, apply) in routes.items():
        t0 = time.perf_counter()
        r = evaluate_policy("nl", ENV, DELAY, SEEDS, config=route_cfg, model_apply=apply, params=params)
        rec = {k: r[k] for k in FIELDS}
        rec["wall_s"] = time.perf_counter() - t0
        out["policies"][name] = rec
        print(name, json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""JAX reference returns for the PyTorch port's closed-loop check.

    JAX_PLATFORMS=cpu python scripts/port_jax_reference.py

Runs the JAX package's own ``evaluate_policy`` for cartpole with delay 1 at
the default ``Config`` (f32, K=1000, T=40, 200 steps) over seeds 0-19 for
``random``, ``oracle`` and ``nl`` (the tracked checkpoint), on the CPU, and
writes every return, the wall time of each policy, the commit and the command
to ``artifacts/port/jax_eval_cartpole_d1.json``. ``chip_smoke.py`` reads that
file, since the GPU machine has no JAX.
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
from neurallaplacecontrol_tpu.training import evaluate_policy, train_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_eval_cartpole_d1.json")
ENV, DELAY, SEEDS = "oderl-cartpole", 1, list(range(20))
FIELDS = ("total_rewards", "total_reward", "total_reward_std", "episode_elapsed_time",
          "roll_outs", "time_steps", "dt")


def main() -> int:
    cfg = Config()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    model, params, _ = train_model("nl", ENV, cfg, delay=DELAY, retrain=False)
    out = {
        "env": ENV, "delay": DELAY, "seeds": SEEDS, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "dtype": "float32", "config": "Config() defaults", "policies": {},
    }
    for name in ("random", "oracle", "nl"):
        t0 = time.perf_counter()
        kwargs = {"model_apply": model.apply, "params": params} if name == "nl" else {}
        r = evaluate_policy(name, ENV, DELAY, SEEDS, config=cfg, **kwargs)
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

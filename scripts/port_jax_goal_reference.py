"""JAX reference returns for the change_goal batch of the PyTorch port's smoke run.

    JAX_PLATFORMS=cpu python scripts/port_jax_goal_reference.py

Runs the JAX package's own ``evaluate_policy`` for ``nl`` with
``change_goal=True`` (the planner's goal flips from x = -2 to x = +2 once half
the episode has elapsed) on cartpole with delay 1, at the default ``Config``
otherwise (f32, K=1000, T=40, 200 steps), over seeds 0-19, on the CPU. The
checkpoint is the tracked one under ``artifacts/checkpoints/``, loaded through
``train_model`` with ``saved_models_path`` pointing there, as the port's phase
loads it. Writes every return, the checkpoint's path and sha256, the wall
time, the commit and the command to
``artifacts/port/jax_eval_cartpole_d1_change_goal.json``; ``chip_smoke.py``
phase ``eval`` holds the port's batch to it, since the GPU machine has no JAX.
"""

from __future__ import annotations

import hashlib
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
from neurallaplacecontrol_tpu.utils.checkpoint import model_checkpoint_name  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_eval_cartpole_d1_change_goal.json")
ENV, DELAY, SEEDS = "oderl-cartpole", 1, list(range(20))
FIELDS = ("total_rewards", "total_reward", "total_reward_std", "episode_elapsed_time",
          "roll_outs", "time_steps", "dt")


def main() -> int:
    checkpoints = os.path.join("artifacts", "checkpoints")
    cfg = Config(saved_models_path=os.path.join(ROOT, checkpoints) + os.sep)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    name = model_checkpoint_name(  # as train_model names it
        "nl", ENV, DELAY, cfg.ts_grid, 0, cfg.train_with_expert_trajectories,
        training_epochs=None if cfg.end_training_after_seconds else cfg.training_epochs,
        samples_used=cfg.training_use_only_samples)
    with open(os.path.join(ROOT, checkpoints, name), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    model, params, _ = train_model("nl", ENV, cfg, delay=DELAY, retrain=False)
    t0 = time.perf_counter()
    r = evaluate_policy("nl", ENV, DELAY, SEEDS, config=cfg, model_apply=model.apply, params=params,
                        change_goal=True)
    rec = {k: r[k] for k in FIELDS}
    rec["wall_s"] = time.perf_counter() - t0
    out = {
        "env": ENV, "delay": DELAY, "seeds": SEEDS, "change_goal": True, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_goal_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "dtype": "float32", "config": f"Config(saved_models_path='{checkpoints}/'), defaults otherwise",
        "checkpoint": {"path": f"{checkpoints}/{name}", "sha256": digest},
        "nl": rec,
    }
    print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())

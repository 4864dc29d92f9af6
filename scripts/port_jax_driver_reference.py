"""JAX reference returns for phase ``driver`` of the PyTorch port's smoke run.

    JAX_PLATFORMS=cpu python scripts/port_jax_driver_reference.py

Runs the JAX package's own ``evaluate_policy`` for ``nl`` (the tracked
checkpoint under ``artifacts/checkpoints/``, loaded through ``train_model``
with ``saved_models_path`` pointing there, as the port's phase loads it) on
pendulum and acrobot with delay 1, at the default ``Config`` otherwise (f32,
K=1000, T=40, 200 steps), over seeds 0-19, on the CPU, and writes every
return, the checkpoint's path and sha256, the wall time, the commit and the
command to ``artifacts/port/jax_eval_driver_d1.json``.
``chip_smoke.py`` phase ``driver`` holds the port's NL cells to it, since the
GPU machine has no JAX: the JAX package's full-run records of these cells
(``artifacts/results_full_r5.jsonl``) predate its per-hemisphere sphere map,
which changes the forward's f32 bits, so they are not the package at HEAD.
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
OUT = os.path.join(ROOT, "artifacts", "port", "jax_eval_driver_d1.json")
ENVS, DELAY, SEEDS = ("oderl-pendulum", "oderl-acrobot"), 1, list(range(20))
FIELDS = ("total_rewards", "total_reward", "total_reward_std", "episode_elapsed_time",
          "roll_outs", "time_steps", "dt")


def main() -> int:
    checkpoints = os.path.join("artifacts", "checkpoints")
    cfg = Config(saved_models_path=os.path.join(ROOT, checkpoints) + os.sep)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    out = {
        "delay": DELAY, "seeds": SEEDS, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_driver_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "dtype": "float32", "config": f"Config(saved_models_path='{checkpoints}/'), defaults otherwise",
        "cells": {},
    }
    for env in ENVS:
        name = model_checkpoint_name(  # as train_model names it
            "nl", env, DELAY, cfg.ts_grid, 0, cfg.train_with_expert_trajectories,
            training_epochs=None if cfg.end_training_after_seconds else cfg.training_epochs,
            samples_used=cfg.training_use_only_samples)
        with open(os.path.join(ROOT, checkpoints, name), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        model, params, _ = train_model("nl", env, cfg, delay=DELAY, retrain=False)
        t0 = time.perf_counter()
        r = evaluate_policy("nl", env, DELAY, SEEDS, config=cfg, model_apply=model.apply, params=params)
        rec = {k: r[k] for k in FIELDS}
        rec["checkpoint"] = {"path": f"{checkpoints}/{name}", "sha256": digest}
        rec["wall_s"] = time.perf_counter() - t0
        out["cells"][f"{env}/nl"] = rec
        print(env, json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", OUT)
    return 0


if __name__ == "__main__":
    sys.exit(main())

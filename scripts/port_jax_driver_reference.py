"""JAX reference returns for the PyTorch port's NL cells on the H100.

    JAX_PLATFORMS=cpu python scripts/port_jax_driver_reference.py \\
        [--envs pendulum,cartpole,acrobot] [--delays 0,1,2,3] \\
        [--out artifacts/port/jax_eval_table.json]

Runs the JAX package's own ``evaluate_policy`` for ``nl`` (the tracked
checkpoint under ``artifacts/checkpoints/``, loaded through ``train_model``
with ``saved_models_path`` pointing there, as the port loads it) on every
(env, delay) cell asked for, at the default ``Config`` otherwise (f32, K=1000,
T=40, 200 steps), over seeds 0-19, on the CPU. A cell whose checkpoint was
trained with the age channel (its GRU input is one wider than the env's
action: pendulum at delay 0) runs under ``Config(encode_obs_time=True)``, the
only flag it loads under. Each cell's returns, checkpoint path and sha256,
``Config`` fields, and wall time go into ``--out`` under ``"<env>/<delay>/nl"``;
cells already in that file and not re-run are kept, so several processes may
fill one file (each cell is written under a lock as soon as it is done).

``chip_smoke.py`` phase ``table`` holds the port's NL cells to this file,
since the GPU machine has no JAX: the JAX package's full-run records of these
cells (``artifacts/results_full_r5.jsonl``) predate its per-hemisphere sphere
map, which changes the forward's f32 bits, so they are not the package at
HEAD. ``artifacts/port/jax_eval_driver_d1.json`` (pendulum and acrobot at
delay 1) was made by this script before it took arguments.
"""

from __future__ import annotations

import argparse
import fcntl
import hashlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from neurallaplacecontrol_tpu.config import Config  # noqa: E402
from neurallaplacecontrol_tpu.envs import make_env  # noqa: E402
from neurallaplacecontrol_tpu.training import evaluate_policy, train_model  # noqa: E402
from neurallaplacecontrol_tpu.utils.checkpoint import model_checkpoint_name  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = os.path.join("artifacts", "checkpoints")
OUT = os.path.join("artifacts", "port", "jax_eval_table.json")
SEEDS = list(range(20))
FIELDS = ("total_rewards", "total_reward", "total_reward_std", "episode_elapsed_time",
          "roll_outs", "time_steps", "dt")


def checkpoint_path(env: str, delay: int, cfg: Config) -> str:
    name = model_checkpoint_name(  # as train_model names it
        "nl", env, delay, cfg.ts_grid, 0, cfg.train_with_expert_trajectories,
        training_epochs=None if cfg.end_training_after_seconds else cfg.training_epochs,
        samples_used=cfg.training_use_only_samples)
    return os.path.join(CHECKPOINTS, name)


def has_age_channel(env: str, path: str) -> bool:
    """True when the checkpoint's GRU takes the action plus the age channel."""
    with np.load(os.path.join(ROOT, path)) as z:
        (w_ih,) = [z[k] for k in z.files if k.endswith("encoder/gru/0/w_ih")]
    return w_ih.shape[0] == make_env(env).spec.m + 1


def write_cell(out_path: str, head: dict, key: str, rec: dict) -> None:
    """Add one cell to ``out_path``, keeping the cells other runs wrote."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    lock = os.open(os.path.dirname(out_path), os.O_RDONLY)
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        cells = {}
        if os.path.exists(out_path):
            with open(out_path) as f:
                cells = json.load(f)["cells"]
        cells[key] = rec
        with open(out_path, "w") as f:
            json.dump({**head, "cells": dict(sorted(cells.items()))}, f, indent=1)
    finally:
        os.close(lock)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs", default="pendulum,cartpole,acrobot")
    ap.add_argument("--delays", default="0,1,2,3")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    envs = [e if e.startswith("oderl-") else f"oderl-{e}" for e in args.envs.split(",")]
    delays = [int(d) for d in args.delays.split(",")]
    out_path = os.path.join(ROOT, args.out)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    head = {
        "seeds": SEEDS, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_driver_reference.py "
                   "--envs <envs> --delays <delays>",
        "platform": jax.devices()[0].platform, "jax": jax.__version__, "dtype": "float32",
        "config": "Config(**cell['config']), defaults otherwise",
    }
    for env in envs:
        for delay in delays:
            path = checkpoint_path(env, delay, Config())
            fields = {"saved_models_path": CHECKPOINTS + os.sep,
                      "encode_obs_time": has_age_channel(env, path)}
            cfg = Config(**{**fields, "saved_models_path": os.path.join(ROOT, CHECKPOINTS) + os.sep})
            with open(os.path.join(ROOT, path), "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            model, params, _ = train_model("nl", env, cfg, delay=delay, retrain=False)
            t0 = time.perf_counter()
            r = evaluate_policy("nl", env, delay, SEEDS, config=cfg, model_apply=model.apply,
                                params=params)
            rec = {k: r[k] for k in FIELDS}
            rec.update(delay=delay, config=fields, checkpoint={"path": path, "sha256": digest},
                       wall_s=time.perf_counter() - t0)
            write_cell(out_path, head, f"{env}/{delay}/nl", rec)
            print(env, delay, json.dumps(rec), flush=True)
    print("wrote", out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

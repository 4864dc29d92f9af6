"""JAX reference curve for the port's from-scratch flagship training.

    JAX_PLATFORMS=cpu python scripts/port_jax_e2e_reference.py [--updates 40000] [--seeds 0,1,2]

Trains the JAX package's NL on pendulum with delay 1 at the default
``Config`` (f32, nl_hidden_units 128, batch 16, 500 updates a segment) on
the 200,000 rows of the tracked expert buffer
``artifacts/offlinedata/...pendulum_delay-1...npz``, the data of
``scripts/e2e_nl_pendulum.py``, once per seed: the init is
``model.init(PRNGKey(seed))`` and every epoch draws its batch order from the
split of ``PRNGKey(seed + 10_000)`` that ``training.train.train_model``
makes, with each segment's loss cap from the previous segment's median
(``scripts/port_jax_train_reference.py``'s ``run`` is the pattern). Each run
stops after ``--updates`` updates.

Writes ``artifacts/port/jax_e2e_pendulum_d1.json``: the mean train loss of
every 500-update segment of each run, the updates at each segment's end, the
commit, the command and the seconds. ``scripts/e2e_nl_pendulum_torch.py``
and ``chip_smoke.py`` phase ``train`` hold the port's curve to the band these
runs span (``scripts/e2e_nl_pendulum_torch.py::curve_band``). Reads the
buffer and writes nothing else.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from neurallaplacecontrol_tpu.config import Config  # noqa: E402
from neurallaplacecontrol_tpu.data import replay_buffer_filename  # noqa: E402
from neurallaplacecontrol_tpu.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu.training.train import make_optimizer, make_train_segment_fn  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_e2e_pendulum_d1.json")
ENV, DELAY = "oderl-pendulum", 1
KEYS = ("s0", "a0", "sn", "ts")


def run(model, cfg, seed: int, data, updates: int) -> dict:
    """``train_model``'s epochs and segments from ``model.init(PRNGKey(seed))``
    until ``updates`` updates: each segment's mean loss and the updates at
    its end."""
    optimizer = make_optimizer(cfg)
    segment = make_train_segment_fn(model, optimizer)
    params = model.init(jax.random.PRNGKey(seed))
    opt_state = optimizer.init(params)
    n = data[0].shape[0]
    bs = min(cfg.training_batch_size, n)
    data_key = jax.random.PRNGKey(seed + 10_000)
    loss_cap, done, means, ends = float("inf"), 0, [], []
    t0 = time.perf_counter()
    while done < updates:
        data_key, _k_data, k_perm, _k_sub = jax.random.split(data_key, 4)
        perm = jax.random.permutation(k_perm, n)
        n_batches = n // bs
        seg_len = max(1, min(cfg.iters_per_log, n_batches))
        n_segments = n_batches // seg_len
        batches = perm[: n_segments * seg_len * bs].reshape(n_segments, seg_len, bs)
        for idx in batches:
            params, opt_state, losses = segment(params, opt_state, *data, idx, loss_cap)
            losses = np.asarray(losses)
            done += seg_len
            means.append(float(losses.mean()))
            ends.append(done)
            seg_median = float(np.median(losses))
            if math.isfinite(seg_median) and seg_median > 0:
                loss_cap = cfg.training_loss_skip_factor * seg_median
            if len(means) % 10 == 0:
                print(f"seed {seed}: {done} updates, segment mean loss {means[-1]:.6g} "
                      f"({time.perf_counter() - t0:.0f} s)", flush=True)
            if done >= updates:
                break
    return {"segment_mean_loss": means, "updates_at_segment_end": ends, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--updates", type=int, default=40_000)
    ap.add_argument("--seeds", type=str, default="0,1,2")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    cfg = Config()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    path = os.path.join(ROOT, "artifacts", "offlinedata", replay_buffer_filename(ENV, DELAY))
    with np.load(path) as z:
        data = [jnp.asarray(np.asarray(z[k], np.float32)) for k in KEYS]
    model = make_model("nl", ENV, 3, 1, 2.0, cfg, dtype=jnp.float32)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = {str(s): run(model, cfg, s, data, args.updates) for s in seeds}
    out = {
        "env": ENV, "delay": DELAY, "rows": int(data[0].shape[0]), "data_file": os.path.relpath(path, ROOT),
        "batch_size": cfg.training_batch_size, "segment_len": cfg.iters_per_log, "updates": args.updates,
        "seeds": seeds, "dtype": "float32", "config": "Config() defaults", "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_e2e_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "seconds": time.perf_counter() - t_start, "runs": runs,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

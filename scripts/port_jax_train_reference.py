"""JAX reference for the PyTorch port's training check on the card.

    JAX_PLATFORMS=cpu python scripts/port_jax_train_reference.py

Trains the JAX package's NL on pendulum with delay 1 at the default
``Config`` (nl_hidden_units 128, GRU 64 x 2, 17 fourier terms, batch 16,
lr 1e-4, clip 0.1, loss-skip factor 100) on the CPU, the way
``training.train.train_model`` runs it: the init is
``model.init(PRNGKey(0))``, the data the first 4,000 transitions of the
tracked pendulum-d1 replay buffer, and each epoch draws its batch order from
the split of ``PRNGKey(10_000)`` that ``train_model`` makes (one segment of
250 updates per epoch), with each segment's loss cap taken from the previous
segment's median. Two runs of the first segment (250 updates) from the same
init, data and batch order: in f32, as ``train_model`` trains, and in f64
(``jax_enable_x64``, the init and data cast up). Training this early is
chaotic: two correct f32 runs part within ~40 updates, two correct f64 runs
within ~300, so a longer record could not tell a wrong run from a right one.

Writes ``artifacts/port/jax_train_pendulum_d1.npz``: the init, the data, the
batch indices [1, 250, 16], the f32 run's losses [1, 250], its params after
the 250 updates (``final``) and their forward on the 4,000 inputs
(``pred``), the f64 run's losses (``losses64``) and forward (``pred64``),
and a JSON record (commit, command, JAX version, seconds). ``chip_smoke.py`` reads it, since the GPU machine has no JAX and
no ``offlinedata/``.
"""

from __future__ import annotations

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
from neurallaplacecontrol_tpu.utils.checkpoint import _flatten  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_train_pendulum_d1.npz")
ENV, DELAY, N_DATA = "oderl-pendulum", 1, 4000
F32_SEGMENTS, F64_SEGMENTS = 1, 1
KEYS = ("s0", "a0", "sn", "ts")


def run(model, cfg, params, data, batch_idx):
    """``train_model``'s segments over ``batch_idx`` [segments, S, bs]: the
    params after them, every update's loss and each segment's cap."""
    optimizer = make_optimizer(cfg)
    segment = make_train_segment_fn(model, optimizer)
    opt_state = optimizer.init(params)
    loss_cap = float("inf")
    losses, caps = [], []
    for seg, idx in enumerate(batch_idx):
        caps.append(loss_cap)
        params, opt_state, seg_losses = segment(params, opt_state, *data, jnp.asarray(idx), loss_cap)
        seg_losses = np.asarray(seg_losses)
        losses.append(seg_losses)
        seg_median = float(jnp.median(seg_losses))
        if math.isfinite(seg_median) and seg_median > 0:
            loss_cap = cfg.training_loss_skip_factor * seg_median
        print(f"{seg_losses.dtype} segment {seg}: mean loss {seg_losses.mean():.6g}, median {seg_median:.6g}",
              flush=True)
    return params, np.stack(losses), caps


def main() -> int:
    t_start = time.perf_counter()
    cfg = Config()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                            text=True).stdout.strip() or None
    model = make_model("nl", ENV, 3, 1, 2.0, cfg, dtype=jnp.float32)
    init = model.init(jax.random.PRNGKey(cfg.model_seed))
    init_flat = {k: np.asarray(v) for k, v in _flatten(init).items()}  # the segment donates init
    init64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), init)

    path = os.path.join(ROOT, "offlinedata", replay_buffer_filename(ENV, DELAY))
    with np.load(path) as z:
        data = {k: np.asarray(z[k][:N_DATA], np.float32) for k in KEYS}

    # the batch order of train_model's first epochs on N_DATA samples
    bs = cfg.training_batch_size
    seg_len = min(cfg.iters_per_log, N_DATA // bs)
    n_segments = (N_DATA // bs) // seg_len
    assert n_segments == 1, n_segments
    data_key = jax.random.PRNGKey(cfg.model_seed + 10_000)
    batch_idx = []
    for _ in range(max(F32_SEGMENTS, F64_SEGMENTS)):
        data_key, _k_data, k_perm, _k_sub = jax.random.split(data_key, 4)
        perm = np.asarray(jax.random.permutation(k_perm, N_DATA))
        batch_idx.append(perm[: seg_len * bs].reshape(seg_len, bs))
    batch_idx = np.stack(batch_idx).astype(np.int32)  # [segments, seg_len, bs]

    data32 = [jnp.asarray(data[k]) for k in KEYS]
    params, losses, caps = run(model, cfg, init, data32, batch_idx[:F32_SEGMENTS])
    pred = np.asarray(model.apply(params, data32[0], data32[1], data32[3]))

    jax.config.update("jax_enable_x64", True)  # only now: the f32 run ran as train_model runs
    model64 = make_model("nl", ENV, 3, 1, 2.0, cfg, dtype=jnp.float64)
    init64 = jax.tree_util.tree_map(jnp.asarray, init64)
    data64 = [jnp.asarray(data[k], jnp.float64) for k in KEYS]
    params64, losses64, caps64 = run(model64, cfg, init64, data64, batch_idx[:F64_SEGMENTS])
    pred64 = np.asarray(model64.apply(params64, data64[0], data64[1], data64[3]))
    assert losses64.dtype == np.float64 and pred64.dtype == np.float64

    meta = {
        "env": ENV, "delay": DELAY, "n_data": N_DATA, "f32_segments": F32_SEGMENTS,
        "f64_segments": F64_SEGMENTS, "segment_len": seg_len, "batch_size": bs, "loss_caps": caps,
        "loss_caps64": caps64, "commit": commit,
        "command": "JAX_PLATFORMS=cpu python scripts/port_jax_train_reference.py",
        "platform": jax.devices()[0].platform, "jax": jax.__version__,
        "config": "Config() defaults", "data_file": os.path.basename(path),
        "seconds": time.perf_counter() - t_start,
    }
    arrays = {f"init/{k}": v for k, v in init_flat.items()}
    arrays.update({f"final/{k}": v for k, v in _flatten(params).items()})
    arrays.update({f"data/{k}": v for k, v in data.items()})
    arrays.update(batch_idx=batch_idx, losses=losses, pred=pred, losses64=losses64, pred64=pred64,
                  meta=np.array(json.dumps(meta)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(json.dumps(meta), flush=True)
    print("wrote", OUT, os.path.getsize(OUT), "bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Replay-buffer files (port of ``data/replay.py``): write-once ``.npz``
caches keyed by every collection hyperparameter (the reference's cache key,
mppi_dataset_collector.py:354-363,441).

The JAX module also writes and prefers a native ``.rbuf`` sibling through
its host runtime; that path waits for the port's ``runtime/``. The ``.npz``
here is the same file the JAX package writes and reads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device

FIELDS = ("s0", "a0", "sn", "ts")


def replay_buffer_filename(
    env_name: str,
    delay: int,
    model_name: str = "oracle",
    encode_obs_time: bool = False,
    action_buffer_size: int = 4,
    ts_grid: str = "exp",
    random_action_noise=1.0,
    observation_noise=0.0,
    friction: bool = False,
) -> str:
    """Mirrors the reference cache key (mppi_dataset_collector.py:354-359)."""
    return (
        f"replay_buffer_env-name-{env_name}_delay-{delay}_model-name-{model_name}"
        f"_encode-obs-time-{encode_obs_time}_action-buffer-size-{action_buffer_size}"
        f"_ts-grid-{ts_grid}_random-action-noise-{random_action_noise}"
        f"_observation-noise-{observation_noise}_friction-{friction}.npz"
    )


def save_replay_buffer(path, s0, a0, sn, ts) -> None:
    """Write the ``.npz``. A ``.rbuf`` sibling left by the JAX package is
    removed first, since its loader would prefer it to the fresh file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Path(str(path).replace(".npz", "") + ".rbuf").unlink(missing_ok=True)
    arrays = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in zip(FIELDS, (s0, a0, sn, ts))}
    np.savez_compressed(path, **arrays)


def load_replay_buffer(path, device="cuda"):
    """(s0, a0, sn, ts) of a ``.npz`` buffer as tensors on ``device``."""
    dev = resolve_device(device)
    with np.load(path) as z:
        return tuple(torch.as_tensor(z[k], device=dev) for k in FIELDS)

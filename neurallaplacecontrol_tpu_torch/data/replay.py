"""Replay-buffer files (port of ``data/replay.py``): write-once ``.npz``
caches keyed by every collection hyperparameter (the reference's cache key,
mppi_dataset_collector.py:354-363,441), each with a native ``.rbuf`` sibling
(``runtime``: one float32 file that opens as an mmap in O(1)) that loading
prefers. The ``.npz`` stays the portable file. Both are the files the JAX
package writes and reads.
"""

from __future__ import annotations

import logging
import zipfile
from pathlib import Path

import numpy as np
import torch

from .. import runtime
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

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


def _rbuf_path(path) -> Path:
    return Path(str(path).replace(".npz", "") + ".rbuf")


def save_replay_buffer(path, s0, a0, sn, ts) -> None:
    """Write the ``.npz`` and, for float32 data, its ``.rbuf`` sibling.

    An existing sibling is removed first, so a failed native write never
    leaves a stale one to shadow the fresh ``.npz``. Where the native
    library cannot be built, this logs a warning and writes the ``.npz``
    alone."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rb_path = _rbuf_path(path)
    rb_path.unlink(missing_ok=True)
    arrays = {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
              for k, v in zip(FIELDS, (s0, a0, sn, ts))}
    np.savez_compressed(path, **arrays)
    if not all(a.dtype == np.float32 for a in arrays.values()):
        return  # the native file is float32; the loader reads other data from the .npz
    try:
        runtime.write_buffer(str(rb_path), *(arrays[k] for k in FIELDS))
    except (RuntimeError, OSError) as e:
        rb_path.unlink(missing_ok=True)
        logger.warning("replay buffer %s: no native .rbuf sibling written (%s); the .npz alone", path.name, e)


_HEADER_READERS = {(1, 0): np.lib.format.read_array_header_1_0, (2, 0): np.lib.format.read_array_header_2_0}


def _npz_metadata(path):
    """(shapes, dtypes) per array from each member's ``.npy`` header alone,
    without decompressing any payload."""
    shapes, dtypes = {}, {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            key = name[:-4] if name.endswith(".npy") else name
            with zf.open(name) as f:
                version = np.lib.format.read_magic(f)
                if version not in _HEADER_READERS:
                    raise ValueError(f"{path}: .npy format {version} of {name}")
                shape, _, dtype = _HEADER_READERS[version](f)
            shapes[key], dtypes[key] = shape, dtype
    return shapes, dtypes


def _load_rbuf(path):
    """The four arrays from the ``.rbuf`` sibling, as heap copies; None when
    there is none to use: no sibling, data other than float32, a truncated
    or corrupt file, or one whose row count differs from the ``.npz``'s."""
    rb_path = _rbuf_path(path)
    if not rb_path.exists():
        return None
    try:
        shapes, dtypes = _npz_metadata(path)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if not all(dtypes.get(k) == np.float32 for k in FIELDS):
        return None
    try:
        rb = runtime.open_buffer(str(rb_path), {k: shapes[k][1:] for k in FIELDS})
    except IOError:
        return None
    except RuntimeError as e:
        logger.warning("replay buffer %s: the native library is unavailable (%s); reading the .npz", path, e)
        return None
    try:
        if rb.n != shapes["s0"][0]:
            return None  # a stale sibling
        # copy before close: tensors made from the views alias the mapping
        return rb.copy_arrays()
    finally:
        rb.close()


def load_replay_buffer(path, device="cuda"):
    """(s0, a0, sn, ts) of a buffer as tensors on ``device``, from the
    ``.rbuf`` sibling where there is one to use, else from the ``.npz``."""
    dev = resolve_device(device)
    host = _load_rbuf(path)
    if host is not None:
        return tuple(torch.from_numpy(host[k]).to(dev) for k in FIELDS)
    with np.load(path) as z:
        return tuple(torch.as_tensor(z[k], device=dev) for k in FIELDS)

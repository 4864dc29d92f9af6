"""Shared utilities: device selection, checkpoints and the training timer."""

from .checkpoint import (  # noqa: F401
    checkpoint_read_path,
    from_jax_params,
    load_pytree,
    model_checkpoint_name,
    resolve_checkpoint,
    save_pytree,
)
from .device import resolve_device  # noqa: F401
from .timing import Timer  # noqa: F401

"""Shared utilities: device selection and checkpoint loading."""

from .checkpoint import (  # noqa: F401
    from_jax_params,
    load_pytree,
    model_checkpoint_name,
    resolve_checkpoint,
)
from .device import resolve_device  # noqa: F401

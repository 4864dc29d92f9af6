"""NL checkpoints: the JAX package's ``.npz`` format, read into torch tensors.

A checkpoint is a flat ``.npz`` whose keys are the parameter tree's paths
joined by ``/`` (``neurallaplacecontrol_tpu/utils/checkpoint.py:17-49``),
for example ``encoder/gru/0/w_ih`` with shape ``[in, 3H]``. List entries are
numbered path parts. The port keeps the tree as it is: nested dicts and
lists of tensors with the JAX layout, so ``from_jax_params`` is the whole
weight carry-over and the tests can hand both packages the same numbers.

Trained weights are read from ``artifacts/checkpoints/`` only: the tracked
directory that every checkout carries.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

REPO_ROOT = Path(__file__).resolve().parents[2]


def _unflatten(flat: dict):
    """``{"a/0/b": x}`` -> ``{"a": [{"b": x}]}``: numbered parts become lists."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def flatten_params(params) -> dict:
    """The ``/``-joined key scheme of the JAX checkpoints, as numpy arrays."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out[prefix] = node.detach().cpu().numpy() if torch.is_tensor(node) else np.asarray(node)
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(params, "")
    return out


def from_jax_params(tree, device="cuda", dtype=None):
    """A JAX parameter tree of numpy arrays -> the same tree of torch tensors.

    ``dtype`` casts every leaf (the checkpoints hold float32); None keeps it.
    """
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return torch.as_tensor(np.array(node), dtype=dtype, device=dev)

    return convert(tree)


def load_pytree(path, device="cuda", dtype=None):
    """Load a checkpoint ``.npz`` into the JAX package's tree, as torch tensors."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return from_jax_params(_unflatten(flat), device=device, dtype=dtype)


def resolve_checkpoint(name: str, repo_root=None) -> str:
    """Path of a tracked checkpoint under ``artifacts/checkpoints/``."""
    root = Path(repo_root) if repo_root else REPO_ROOT
    path = root / "artifacts" / "checkpoints" / name
    if not path.is_file():
        raise FileNotFoundError(f"no tracked checkpoint {path}")
    return str(path)


def model_checkpoint_name(
    model_name: str,
    env_name: str,
    delay: int,
    ts_grid: str,
    model_seed: int,
    train_with_expert: bool,
    training_epochs=None,
    samples_used=None,
) -> str:
    """Checkpoint file name of a trained model (the JAX package's scheme)."""
    name = (
        f"{model_name}_{env_name}_delay-{delay}_ts-grid-{ts_grid}_{model_seed}"
        f"_train-with-expert-trajectories-{train_with_expert}"
    )
    if training_epochs is not None:
        name += f"_training_for_epochs-{training_epochs}"
    if samples_used is not None:
        name += f"_samples_used-{samples_used}"
    return name + ".npz"

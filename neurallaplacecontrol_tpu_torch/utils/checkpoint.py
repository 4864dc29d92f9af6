"""NL checkpoints: the JAX package's ``.npz`` format, as torch tensors.

A checkpoint is a flat ``.npz`` whose keys are the parameter tree's paths
joined by ``/`` (``neurallaplacecontrol_tpu/utils/checkpoint.py:17-49``),
for example ``encoder/gru/0/w_ih`` with shape ``[in, 3H]``. List entries are
numbered path parts. The port keeps the tree as it is: nested dicts and
lists of tensors with the JAX layout, so ``from_jax_params`` is the whole
weight carry-over and the tests can hand both packages the same numbers.

``save_pytree`` writes the format the JAX package's ``load_pytree`` reads,
and ``load_pytree`` reads the files the JAX package writes.
``resolve_checkpoint`` finds the trained weights tracked under
``artifacts/checkpoints/``, the directory every checkout carries;
``checkpoint_read_path`` is training's rule for where a load may come from.

``save_sharded`` and ``load_sharded`` keep a parameter tree split over the
ranks of a mesh (``parallel.sharding``) with ``torch.distributed.checkpoint``:
each split layer's blocks are the shards of a ``DTensor`` over the "tp"
group, and the rest is saved once. They stand for the JAX module's orbax
directories, which the port does not read: the two formats are not one.
Sharded weights travel between the packages as the ``.npz`` trees above.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..config import Config
from .device import resolve_device

REPO_ROOT = Path(__file__).resolve().parents[2]


def unflatten_params(flat: dict):
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


def from_jax_params_like(tree, like, dtype=None):
    """A JAX parameter tree of numpy arrays as the port's tree ``like``: the
    same keys and shapes, else ``ValueError``; each leaf on the device of its
    counterpart in ``like``, in ``dtype`` (its counterpart's when None)."""
    flat, want = flatten_params(tree), flatten_params(like)
    if sorted(flat) != sorted(want):
        raise ValueError(f"keys {sorted(flat)} differ from the model's {sorted(want)}")
    for key, value in want.items():
        if flat[key].shape != value.shape:
            raise ValueError(f"{key} has shape {flat[key].shape}, the model {value.shape}")
    return _unflatten_like(flat, like, dtype=dtype)


def save_pytree(path, params) -> None:
    """Write ``params`` as the JAX package's flat ``/``-joined ``.npz``."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten_params(params))


def load_pytree(path, device="cuda", dtype=None, like=None):
    """Load a checkpoint ``.npz`` into the JAX package's tree, as torch tensors.

    With ``like`` (a parameter tree), the file must hold exactly its keys
    with its shapes, else ``ValueError``; each leaf takes the dtype and the
    device of its counterpart in ``like``, and ``device``/``dtype`` are not
    read.
    """
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    if like is None:
        return from_jax_params(unflatten_params(flat), device=device, dtype=dtype)
    try:
        return from_jax_params_like(flat, like)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _unflatten_like(flat: dict, like, prefix: str = "", dtype=None):
    if isinstance(like, dict):
        return {k: _unflatten_like(flat, v, f"{prefix}/{k}" if prefix else k, dtype) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_unflatten_like(flat, v, f"{prefix}/{i}" if prefix else str(i), dtype) for i, v in enumerate(like)]
    return torch.tensor(flat[prefix], dtype=dtype or like.dtype, device=like.device)


def tracked_checkpoint_path(name: str, repo_root=None) -> Path:
    """Where a tracked checkpoint of this name lives, whether or not it exists."""
    return (Path(repo_root) if repo_root else REPO_ROOT) / "artifacts" / "checkpoints" / name


def resolve_checkpoint(name: str, repo_root=None) -> str:
    """Path of a tracked checkpoint under ``artifacts/checkpoints/``."""
    path = tracked_checkpoint_path(name, repo_root)
    if not path.is_file():
        raise FileNotFoundError(f"no tracked checkpoint {path}")
    return str(path)


def checkpoint_read_path(name: str, config: Config, retrain: bool, force_retrain: bool) -> str:
    """Where a checkpoint load may come from (saves always go to
    ``saved_models_path``): the JAX package's ``training/train.py``
    ``_checkpoint_read_path``.

    ``config.saved_models_path`` first. Only an eval-only load (neither
    ``retrain`` nor ``force_retrain``) with the path at its default, compared
    by ``realpath``, falls back on the tracked ``artifacts/checkpoints/`` when
    the path has no file: a training run never warm-starts from the tracked
    weights, and a custom path stays strict.
    """
    path = os.path.join(config.saved_models_path, name)
    if (
        not retrain
        and not force_retrain
        and not os.path.isfile(path)
        and os.path.realpath(config.saved_models_path) == os.path.realpath(Config.saved_models_path)
    ):
        return str(tracked_checkpoint_path(name))
    return path


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


def _leaf_paths(tree, prefix=""):
    """(``/``-joined path, leaf) in ``models.common.tree_leaves`` order; a
    tuple is a leaf here (a spec), a list a container."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaf_paths(v, f"{prefix}/{i}" if prefix else str(i))]
    return [(prefix, tree)]


def _sharded_state_dict(params, mesh, specs):
    """``params`` (this rank's tree) as a flat state dict whose split leaves
    are ``DTensor``s over the mesh's "tp" group."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from ..parallel.sharding import _leaf_shard_dims

    items = _leaf_paths(params)
    if specs is None:
        dims = _leaf_shard_dims(params)
    else:
        dims = [s.index("tp") if "tp" in s else None for _, s in _leaf_paths(specs)]
    if mesh is None or mesh.shape.get("tp", 1) == 1 or all(d is None for d in dims):
        return dict(items)
    tp_mesh = DeviceMesh.from_group(mesh.group("tp"), mesh.device.type)
    return {k: x if d is None else DTensor.from_local(x.contiguous(), tp_mesh, [Shard(d)], run_check=False)
            for (k, x), d in zip(items, dims)}


def save_sharded(path, params, mesh=None, specs=None) -> str:
    """Save this rank's ``params`` into the ``torch.distributed.checkpoint``
    directory ``path``; every rank of ``mesh`` calls it. The placements come
    from ``specs`` (``parallel.sharding.derive_param_pspecs``'s tuples, one
    per leaf) or, by default, from the tree's split layers
    (``parallel.sharding.shard_params``). Returns the absolute path."""
    import torch.distributed.checkpoint as dcp

    path = Path(path).absolute()
    dcp.save(_sharded_state_dict(params, mesh, specs), checkpoint_id=str(path))
    return str(path)


def load_sharded(path, like, mesh=None, specs=None):
    """Restore a ``save_sharded`` directory onto ``like``'s placements: this
    rank's tree, with its blocks of the split leaves (``like`` holds this
    rank's shapes, as ``shard_params`` gives them; ``mesh`` and ``specs`` as
    for ``save_sharded``). ``like``'s tensors are not written."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.tensor import DTensor

    from ..models.common import tree_leaves, tree_unflatten
    from ..parallel.sharding import _rewrap

    fresh = _rewrap(like, tree_unflatten(like, [torch.empty_like(x) for x in tree_leaves(like)]))
    state = _sharded_state_dict(fresh, mesh, specs)
    dcp.load(state, checkpoint_id=str(Path(path).absolute()))
    leaves = [v.to_local() if isinstance(v, DTensor) else v for v in state.values()]
    return _rewrap(like, tree_unflatten(like, leaves))

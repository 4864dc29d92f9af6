"""The weights a cell runs: a tracked checkpoint's arrays, widened where the
configuration asks. Both the port and the reference get the same tree."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .seeds import stream_seed


def load_checkpoint(path: Path) -> dict:
    """A checkpoint ``.npz`` of ``/``-joined keys (``encoder/gru/0/w_ih``) as
    the nested tree (numbered parts become lists) of float32 arrays."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = np.asarray(z[key], dtype=np.float32)

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)


def to_device(tree, device, dtype=torch.float32):
    if isinstance(tree, dict):
        return {k: to_device(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device, dtype) for v in tree]
    return torch.as_tensor(tree, dtype=dtype, device=device)


def widen(params, width: int, std: float, seed: int, device) -> dict:
    """The tree of width 128 embedded in one of ``width`` trunk units and
    ``width // 2`` GRU units: the old weights in the leading units of each
    GRU gate block (r, z, n) and of the trunk, every new weight and bias
    drawn N(0, std^2) from ``seed``, on the device, in one call."""
    H, Hn = params["encoder"]["gru"][0]["w_hh"].shape[0], width // 2
    plan = []  # (old tensor, new shape, gate blocks or None)
    for i, layer in enumerate(params["encoder"]["gru"]):
        k = layer["w_ih"].shape[0] if i == 0 else Hn
        plan += [(layer["w_ih"], (k, 3 * Hn), True), (layer["w_hh"], (Hn, 3 * Hn), True),
                 (layer["b_ih"], (3 * Hn,), True), (layer["b_hh"], (3 * Hn,), True)]
    out = params["encoder"]["out"]
    l0, l1, l2 = params["laplace_rep"]
    plan += [(out["w"], (Hn, out["w"].shape[1]), False), (l0["w"], (l0["w"].shape[0], width), False),
             (l0["b"], (width,), False), (l1["w"], (width, width), False), (l1["b"], (width,), False),
             (l2["w"], (width, l2["w"].shape[1]), False)]
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, "widen"))
    sizes = [int(np.prod(shape)) for _, shape, _ in plan]
    flat = std * torch.randn(sum(sizes), generator=g, dtype=torch.float32, device=device)
    grown, offset = [], 0
    for (old, shape, gates), size in zip(plan, sizes):
        new = flat[offset:offset + size].reshape(shape).clone()
        offset += size
        old = torch.as_tensor(old, dtype=torch.float32, device=device)
        if gates:
            rows = (slice(0, old.shape[0]),) if old.dim() == 2 else ()
            for gate in range(3):
                new[rows + (slice(gate * Hn, gate * Hn + H),)] = old[rows + (slice(gate * H, (gate + 1) * H),)]
        else:
            new[tuple(slice(0, k) for k in old.shape)] = old
        grown.append(new)
    gru = [dict(zip(("w_ih", "w_hh", "b_ih", "b_hh"), grown[4 * i:4 * i + 4]))
           for i in range(len(params["encoder"]["gru"]))]
    rest = grown[4 * len(gru):]
    dev = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "encoder": {"gru": gru, "out": {"w": rest[0], "b": dev(out["b"])}},
        "laplace_rep": [{"w": rest[1], "b": rest[2]}, {"w": rest[3], "b": rest[4]},
                        {"w": rest[5], "b": dev(l2["b"])}],
    }

"""Shared neural-net primitives on parameter trees (port of ``models/common.py``).

Parameters keep the JAX layout: a linear layer is ``{"w": [in, out], "b":
[out]}`` and a GRU layer is ``{"w_ih": [in, 3H], "w_hh": [H, 3H], "b_ih",
"b_hh"}`` with the gate blocks in r/z/n order. A tree is nested dicts and
lists of tensors; ``tree_leaves`` walks it in the JAX package's order
(dict keys sorted).

The initializers draw the JAX package's distributions (xavier-uniform
linear weights, U(+-1/sqrt(in)) biases, U(+-1/sqrt(H)) GRU tensors) from an
explicit ``torch.Generator``: the stream is the port's own, so the values
differ from JAX's; tests carry a JAX init across with ``from_jax_params``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..ops.pallas_nl import gru_gates  # noqa: F401  (the GRU step, shared with the kernels' plain forward)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    return build(like)


def cast_params(params, dtype):
    """Every leaf of a parameter tree in ``dtype``."""
    return tree_map(lambda x: x.to(dtype), params)


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def _uniform(generator, shape, bound: float, dtype) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device if generator is not None else None)
    return (u * 2.0 - 1.0) * bound


def linear_init(generator, in_dim: int, out_dim: int, xavier: bool = True, dtype=torch.float32):
    bound = math.sqrt(6.0 / (in_dim + out_dim)) if xavier else 1.0 / math.sqrt(in_dim)
    return {
        "w": _uniform(generator, (in_dim, out_dim), bound, dtype),
        "b": _uniform(generator, (out_dim,), 1.0 / math.sqrt(in_dim), dtype),
    }


def mlp_init(generator, sizes: Sequence[int], xavier: bool = True, dtype=torch.float32):
    return [linear_init(generator, sizes[i], sizes[i + 1], xavier=xavier, dtype=dtype)
            for i in range(len(sizes) - 1)]


def gru_init(generator, in_dim: int, hidden: int, num_layers: int = 1, dtype=torch.float32):
    bound = 1.0 / math.sqrt(hidden)
    params = []
    for layer in range(num_layers):
        d_in = in_dim if layer == 0 else hidden
        params.append({
            "w_ih": _uniform(generator, (d_in, 3 * hidden), bound, dtype),
            "w_hh": _uniform(generator, (hidden, 3 * hidden), bound, dtype),
            "b_ih": _uniform(generator, (3 * hidden,), bound, dtype),
            "b_hh": _uniform(generator, (3 * hidden,), bound, dtype),
        })
    return params


def linear_apply(p, x):
    if type(p) is not dict and hasattr(p, "parallel_apply"):  # a layer split over ranks (parallel.sharding.TensorParallelLinear)
        return p.parallel_apply(x)
    if x.dim() == 2:  # one fused launch
        return torch.addmm(p["b"], x, p["w"])
    return x @ p["w"] + p["b"]


def mlp_apply_tanh(layers, x):
    """Linear-tanh stack with a linear final layer."""
    for layer in layers[:-1]:
        x = torch.tanh(linear_apply(layer, x))
    return linear_apply(layers[-1], x)


def _gru_cell(p, h, x):
    return gru_gates(linear_apply({"w": p["w_ih"], "b": p["b_ih"]}, x),
                     linear_apply({"w": p["w_hh"], "b": p["b_hh"]}, h), h)


def gru_apply(params, xs):
    """Run a multi-layer GRU over ``xs`` [B, T, D]; returns the last layer's
    final hidden state [B, H]. Layers step together, bottom-up, per time step."""
    B, T = xs.shape[0], xs.shape[1]
    hs = [xs.new_zeros((B, p["w_hh"].shape[0])) for p in params]
    for t in range(T):
        x = xs[:, t]
        for li, p in enumerate(params):
            hs[li] = _gru_cell(p, hs[li], x)
            x = hs[li]
    return hs[-1]

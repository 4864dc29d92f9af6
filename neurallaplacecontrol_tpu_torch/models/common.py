"""Shared neural-net primitives on parameter trees (port of ``models/common.py``).

Parameters keep the JAX layout: a linear layer is ``{"w": [in, out], "b":
[out]}`` and a GRU layer is ``{"w_ih": [in, 3H], "w_hh": [H, 3H], "b_ih",
"b_hh"}`` with the gate blocks in r/z/n order.
"""

from __future__ import annotations

import torch


def linear_apply(p, x):
    return x @ p["w"] + p["b"]


def mlp_apply_tanh(layers, x):
    """Linear-tanh stack with a linear final layer."""
    for layer in layers[:-1]:
        x = torch.tanh(linear_apply(layer, x))
    return linear_apply(layers[-1], x)


def gru_gates(gi, gh, h):
    """GRU gate nonlinearity (r/z/n blocks; the candidate's hidden path is
    gated by reset after the hidden matmul and its own bias)."""
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def _gru_cell(p, h, x):
    gi = x @ p["w_ih"] + p["b_ih"]
    gh = h @ p["w_hh"] + p["b_hh"]
    return gru_gates(gi, gh, h)


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

"""Neural ODE baseline dynamics model (port of ``models/node.py``).

Reference: train_utils.py:637-738 (xOdeFuncInXAndU + NODE). The normalized
state, augmented with ``augment_dim`` zero channels, is integrated through a
learned vector field f(x, u) with the last buffered action held constant
(raw, any time-age channel sliced off), from 0 to the prediction horizon
(divided by dt * 8 under ``normalize_time``), by explicit Euler at step size
0.05 (train_utils.py:731-737).

torchdiffeq takes a data-dependent number of Euler substeps; here, as in
the JAX package, there are always 16, of length h = clip(t_remaining, 0,
0.05), the later ones of zero length when the horizon is short: the grid
and the partial last step of torchdiffeq for any horizon below 16 x 0.05.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import mlp_apply_tanh, mlp_init, tree_map

_STEP_SIZE = 0.05  # train_utils.py:736
_MAX_SUBSTEPS = 16  # covers normalized horizons up to 0.8 (the exp grid's tail)


def make_node_model(state_dim: int, action_dim: int, norm: NormStats, hidden_units: int = 270,
                    augment_dim: int = 1, method: str = "euler", encode_obs_time: bool = False,
                    normalize: bool = True, normalize_time: bool = True, dt: float = 0.05,
                    dtype=torch.float32, device="cuda") -> DynamicsModel:
    del method, encode_obs_time  # only euler (config.py:40); the age channel is sliced off
    device = resolve_device(device)
    state_mean = torch.as_tensor(np.asarray(norm.state_mean), dtype=dtype, device=device)
    state_std = torch.as_tensor(np.asarray(norm.state_std), dtype=dtype, device=device)

    def init(generator=None):
        """Fresh parameters with the JAX tree's keys and shapes, drawn from
        ``generator`` and placed on the model's device."""
        sizes = [state_dim + action_dim + augment_dim, hidden_units, hidden_units, state_dim + augment_dim]
        return tree_map(lambda x: x.to(device), {"ode_func": mlp_init(generator, sizes, dtype=dtype)})

    def apply(params, obs, action_buffer, ts):
        """obs [B,n], action_buffer [B,A,m(+1)] or [B,m], ts [B,1] or [B] -> [B,n]."""
        x = (obs - state_mean) / state_std if normalize else obs
        if ts.dim() == 2:
            ts = ts[..., 0]
        if normalize_time:
            ts = ts / (dt * 8.0)
        if action_buffer.dim() == 2:
            action_buffer = action_buffer[:, None, :]
        u = action_buffer[:, -1, :action_dim]
        if augment_dim > 0:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (augment_dim,))], dim=-1)
        # f(x, u) = MLP([x, u]): u is constant over the substeps, so its share
        # of the first layer is formed once
        first, *rest = params["ode_func"]
        n_x = x.shape[-1]
        # a column-parallel first layer takes its whole input through its
        # ``enter`` (parallel.sharding.TensorParallelLinear)
        enter = getattr(first, "enter", None) or (lambda v: v)
        u_term = torch.addmm(first["b"], enter(u), first["w"][n_x:])
        # substep i has length clip(t - 0.05 i, 0, 0.05): the same as clipping
        # what is left of t after the i substeps before it
        offsets = torch.arange(_MAX_SUBSTEPS, dtype=x.dtype, device=x.device)[:, None] * _STEP_SIZE
        steps = torch.clamp(ts.to(x.dtype)[None] - offsets, 0.0, _STEP_SIZE)[..., None]
        for i in range(_MAX_SUBSTEPS):
            hidden = torch.tanh(torch.addmm(u_term, enter(x), first["w"][:n_x]))
            x = torch.addcmul(x, steps[i], mlp_apply_tanh(rest, hidden))
        return x[..., :state_dim]

    return DynamicsModel(name="node", init=init, apply=apply)

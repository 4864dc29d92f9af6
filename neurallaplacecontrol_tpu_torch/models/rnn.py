"""RNN and DeltaT-RNN baseline dynamics models (port of ``models/rnn.py``).

Reference: train_utils.py:552-586 (RNN) and :589-631 (DeltaTRNN). Both run a
single-layer GRU over the action buffer, oldest to newest, and decode from
[h_last, obs] with one linear layer; the DeltaT variant also feeds the
prediction horizon (divided by dt * 8 under ``normalize_time``) into the
head, the one time-aware discrete baseline. The plain RNN ignores
``normalize_time``. A time-age channel (``encode_obs_time``) enters the GRU
as it is, not normalized; without ``normalize`` the actions are divided by 3.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import gru_apply, gru_init, linear_apply, linear_init, tree_map


def _make(state_dim, action_dim, norm: NormStats, hidden_units: int, with_dt: bool,
          encode_obs_time: bool = False, normalize: bool = True, normalize_time: bool = True,
          dt: float = 0.05, dtype=torch.float32, device="cuda") -> DynamicsModel:
    device = resolve_device(device)
    gru_in = action_dim + (1 if encode_obs_time else 0)
    head_in = hidden_units + state_dim + (1 if with_dt else 0)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    state_mean, state_std = tensor(norm.state_mean), tensor(norm.state_std)
    action_mean, action_std = tensor(norm.action_mean), tensor(norm.action_std)

    def init(generator=None):
        """Fresh parameters with the JAX tree's keys and shapes, drawn from
        ``generator`` and placed on the model's device."""
        params = {
            "gru": gru_init(generator, gru_in, hidden_units, num_layers=1, dtype=dtype),
            "out": linear_init(generator, head_in, state_dim, xavier=False, dtype=dtype),
        }
        return tree_map(lambda x: x.to(device), params)

    def _norm_actions(action_buffer):
        acts = action_buffer[..., :action_dim]
        acts = (acts - action_mean) / action_std if normalize else acts / 3.0
        return torch.cat([acts, action_buffer[..., action_dim:]], dim=-1)

    def apply(params, obs, action_buffer, ts):
        """obs [B,n], action_buffer [B,A,m(+1)], ts [B,1] or [B] -> [B,n]."""
        obs_n = (obs - state_mean) / state_std if normalize else obs
        h = gru_apply(params["gru"], _norm_actions(action_buffer))
        if not with_dt:
            return linear_apply(params["out"], torch.cat([h, obs_n], dim=-1))
        if ts.dim() == 1:
            ts = ts[:, None]
        if normalize_time:
            ts = ts / (dt * 8.0)
        return linear_apply(params["out"], torch.cat([h, obs_n, ts.to(h.dtype)], dim=-1))

    return DynamicsModel(name="delta_t_rnn" if with_dt else "rnn", init=init, apply=apply)


def make_rnn_model(state_dim, action_dim, norm, hidden_units=160, **kw) -> DynamicsModel:
    kw.pop("normalize_time", None)  # the RNN ignores time (train_utils.py:578-586)
    return _make(state_dim, action_dim, norm, hidden_units, with_dt=False, **kw)


def make_delta_t_rnn_model(state_dim, action_dim, norm, hidden_units=160, **kw) -> DynamicsModel:
    return _make(state_dim, action_dim, norm, hidden_units, with_dt=True, **kw)

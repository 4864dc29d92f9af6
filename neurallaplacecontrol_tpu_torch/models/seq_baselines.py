"""Irregular-time sequence baselines: the standalone ODE-RNN and GRU-D-style
classic RNNs (port of ``models/seq_baselines.py``).

Rebuild of the latent-ODE library extras (reference baseline_models/
latent_ode_lib/ode_rnn.py:14-109 and rnn_baselines.py:33-345): sequence
models that consume irregularly-sampled trajectories [B, T, D] with
timestamps [T] and reconstruct the signal. The ODE evolution between
observations takes fixed Euler substeps.

API (both families):
    params = model.init(generator)
    y_hat  = model.reconstruct(params, x_seq, ts)   # [B,T,D] causal recon
    h_T    = model.encode(params, x_seq, ts)        # [B, latent]

Parameters keep the JAX layout (``{"ih": {"w", "b"}, "hh": ...}`` for the
GRU cell, ``models.common`` MLP lists), so ``sequence_params_from_jax``
carries a JAX init across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..ops.pallas_nl import gru_gates
from ..utils.checkpoint import from_jax_params_like
from ..utils.device import resolve_device
from .common import linear_apply, linear_init, mlp_apply_tanh, mlp_init


@dataclass(frozen=True)
class SequenceModel:
    name: str
    init: Callable  # generator -> params
    encode: Callable  # (params, x_seq [B,T,D], ts [T]) -> [B, latent]
    reconstruct: Callable  # (params, x_seq, ts) -> [B,T,D]
    dtype: torch.dtype = torch.float64
    device: torch.device = torch.device("cpu")


def _gru_cell_init(generator, in_dim, hidden, dtype):
    return {"ih": linear_init(generator, in_dim, 3 * hidden, dtype=dtype),
            "hh": linear_init(generator, hidden, 3 * hidden, dtype=dtype)}


def _gru_cell(params, x, h):
    return gru_gates(linear_apply(params["ih"], x), linear_apply(params["hh"], h), h)


def _gaps(ts: torch.Tensor) -> torch.Tensor:
    """The interval before each observation; the first starts at 0."""
    return torch.diff(torch.cat([ts[:1] * 0.0, ts]))


def _generator_for(device, generator):
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def make_ode_rnn(
    input_dim: int,
    latent_dim: int = 10,
    n_gru_units: int = 100,
    n_units: int = 100,
    rhs_units: int = 100,
    substeps: int = 4,
    dtype=torch.float64,
    device="cuda",
) -> SequenceModel:
    """Standalone ODE-RNN (ode_rnn.py:14-109): between observations the
    hidden state evolves under a learned ODE dh/dt = f(h) (``substeps``
    Euler steps of a tanh MLP); at each observation a GRU cell updates it;
    a tanh MLP decodes per-step outputs. ``n_gru_units`` is kept for the
    JAX signature and, as there, not read."""
    dev = resolve_device(device)

    def init(generator=None):
        g = _generator_for(dev, generator)
        return {
            "rhs": mlp_init(g, [latent_dim, rhs_units, latent_dim], dtype=dtype),
            "gru": _gru_cell_init(g, input_dim, latent_dim, dtype),
            "dec": mlp_init(g, [latent_dim, n_units, input_dim], dtype=dtype),
        }

    def _hidden(params, x_seq, ts):
        h = x_seq.new_zeros((x_seq.shape[0], latent_dim))
        hs = []
        for x_t, dt in zip(x_seq.unbind(1), _gaps(ts).unbind(0)):
            step = dt / substeps
            for _ in range(substeps):
                h = h + step * mlp_apply_tanh(params["rhs"], h)
            h = _gru_cell(params["gru"], x_t, h)
            hs.append(h)
        return torch.stack(hs, dim=1)  # [B,T,latent]

    def encode(params, x_seq, ts):
        return _hidden(params, x_seq, ts)[:, -1]

    def reconstruct(params, x_seq, ts):
        return mlp_apply_tanh(params["dec"], _hidden(params, x_seq, ts))

    return SequenceModel("ode_rnn", init, encode, reconstruct, dtype, dev)


def make_classic_rnn(
    input_dim: int,
    latent_dim: int = 100,
    cell: str = "gru",  # 'gru' | 'expdecay' (GRU-D style)
    n_units: int = 100,
    dtype=torch.float64,
    device="cuda",
) -> SequenceModel:
    """Classic RNN over irregular samples (rnn_baselines.py Classic_RNN
    :217-345). cell='expdecay' multiplies the hidden state by
    exp(-clip(decay_net(delta_t), 0, 1000)) before each update — the GRU-D
    mechanism of GRUCellExpDecay (:33-70), with the time gap as the decay
    feature."""
    if cell not in ("gru", "expdecay"):
        raise ValueError(f"cell must be 'gru' or 'expdecay', got {cell!r}")
    dev = resolve_device(device)

    def init(generator=None):
        g = _generator_for(dev, generator)
        params = {
            "gru": _gru_cell_init(g, input_dim, latent_dim, dtype),
            "dec": mlp_init(g, [latent_dim, n_units, input_dim], dtype=dtype),
        }
        if cell == "expdecay":
            params["decay"] = linear_init(g, 1, 1, dtype=dtype)
        return params

    def _hidden(params, x_seq, ts):
        B = x_seq.shape[0]
        h = x_seq.new_zeros((B, latent_dim))
        hs = []
        for x_t, dt in zip(x_seq.unbind(1), _gaps(ts).unbind(0)):
            if cell == "expdecay":
                d = linear_apply(params["decay"], dt.expand(B, 1).to(x_seq.dtype))
                h = h * torch.exp(-torch.clamp(d, 0.0, 1000.0))
            h = _gru_cell(params["gru"], x_t, h)
            hs.append(h)
        return torch.stack(hs, dim=1)

    def encode(params, x_seq, ts):
        return _hidden(params, x_seq, ts)[:, -1]

    def reconstruct(params, x_seq, ts):
        return mlp_apply_tanh(params["dec"], _hidden(params, x_seq, ts))

    return SequenceModel(f"classic_rnn_{cell}", init, encode, reconstruct, dtype, dev)


def sequence_params_from_jax(model: SequenceModel, tree, dtype=None):
    """A JAX ``SequenceModel.init`` tree (numpy leaves) as the port's params
    for ``model``, on its device, in ``dtype`` (the model's when None); the
    tree must have the keys and shapes of ``model.init``'s."""
    like = model.init(torch.Generator(device=model.device).manual_seed(0))
    return from_jax_params_like(tree, like, dtype=dtype or model.dtype)

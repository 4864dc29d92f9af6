"""Latent-ODE baseline dynamics model: an ODE-RNN encoder and a latent ODE
decoder (port of ``models/latent_ode.py``).

A VAE over short trajectories (Rubanova et al. 2019, vendored by the
reference in baseline_models/latent_ode_lib/):

- the encoder is an ODE-RNN over the (obs || action) history at the buffer's
  times [-(A-1)dt .. 0], oldest to newest: 4 Euler substeps of a learned ODE
  between observations and a GRU update at each (encoder_decoder.py:
  250-327), giving q(z0) = N(z_mean, z_std) with z_std = |y_std| + 1e-6;
- the decoder solves a learned latent ODE from 0 to each row's own horizon
  with the adaptive dopri5 of ``ops.integrate`` (rtol 1e-3, atol 1e-4, 24
  masked steps) and decodes linearly (encoder_decoder.py:330-343);
- training maximizes an IWAE bound over 3 samples, -logsumexp_s(rec_ll -
  kl) + log 3, with a Gaussian likelihood of fixed std ``obsrv_std``
  (base_models.py:332-334, likelihood_eval.py:14-23).

Sizes follow the reference: latents = state_dim + 2 (w_latent_ode.py:41-44),
hidden units 128. The actions enter the encoder raw (w_latent_ode.py:111).

The draws of z0's noise. The JAX model takes them from a key: ``train_step``
from the key of its update, ``apply`` and the carried planner dynamics from
``PRNGKey(0)`` on every call. Its evaluator maps the planner over seeds, so
each seed's K rows see the same [K, latents] draw. Here ``predict_diff`` and
``train_step`` take the draw ``eps`` [S, B, latents] as an argument, and
``apply`` and the carried dynamics use one fixed draw ``z0_noise`` [K,
latents], made once from a CPU ``torch.Generator`` seeded with
``noise_seed``, in f64 and then cast (or handed in, as the tests hand in
JAX's): a call with B rows gives row i the draw's row i mod K, so the S x K
rows of a seed-batched plan see it once per seed, as under JAX's vmap. The
values are the port's own, not JAX's.

Planning with history. The reference keeps a rolling observation buffer on
the module (w_latent_ode.py:160-172). Here ``apply`` tiles the current
observation as the history, and ``make_carried_dynamics`` gives the planner
a closure that carries the last A rollout states instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.integrate import odeint_dopri5, odeint_dopri5_with_stats
from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import linear_apply, linear_init, mlp_apply_tanh, mlp_init, tree_map

_ACTION_LATENT = 2
_KL_COEF = 1.0
_IWAE_SAMPLES = 3
_DECODER_MAX_STEPS = 24
_ENCODER_SUBSTEPS = 4


@dataclass(frozen=True)
class LatentODEModel(DynamicsModel):
    """The latent ODE's entry points beyond the (obs, action_buffer, ts)
    interface; see ``make_latent_ode_model``."""

    encode_history: Optional[Callable] = None
    predict_diff: Optional[Callable] = None
    train_step: Optional[Callable] = None
    decoder_nfes: Optional[Callable] = None
    z0_noise: Optional[torch.Tensor] = None  # [K, latents], the fixed draw of apply
    state_dim: int = 0
    action_dim: int = 0
    latents: int = 0


def tile_rows(draw: torch.Tensor, rows: int) -> torch.Tensor:
    """``draw`` [K, ...] over ``rows`` rows, row i taking draw row i mod K."""
    reps = -(-rows // draw.shape[0])
    return draw.repeat((reps,) + (1,) * (draw.dim() - 1))[:rows]


def make_latent_ode_model(
    state_dim: int,
    action_dim: int,
    norm: NormStats,
    hidden_units: int = 128,
    obsrv_std: float = 0.01,
    action_buffer_size: int = 4,
    encode_obs_time: bool = False,
    normalize: bool = True,
    normalize_time: bool = True,
    dt: float = 0.05,
    dtype=torch.float32,
    device="cuda",
    noise_rows: int = 1000,
    noise_seed: int = 0,
    z0_noise: Optional[torch.Tensor] = None,
) -> LatentODEModel:
    """The latent ODE. ``z0_noise`` [K, latents] replaces the fixed draw of
    ``apply`` and the carried dynamics; else it is ``noise_rows`` rows drawn
    from a generator seeded with ``noise_seed``."""
    del encode_obs_time, normalize_time, action_buffer_size
    device = resolve_device(device)
    input_dim = state_dim + action_dim  # w_latent_ode.py:40
    latents = state_dim + _ACTION_LATENT  # w_latent_ode.py:42

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    state_mean, state_std = tensor(norm.state_mean), tensor(norm.state_std)
    if z0_noise is None:  # drawn on the CPU in f64, so that every device and dtype sees one draw
        g = torch.Generator().manual_seed(noise_seed)
        z0_noise = torch.randn((noise_rows, latents), generator=g, dtype=torch.float64)
    z0_noise = torch.as_tensor(z0_noise, dtype=dtype, device=device)
    if z0_noise.dim() != 2 or z0_noise.shape[1] != latents:
        raise ValueError(f"z0_noise must be [K, {latents}], got {tuple(z0_noise.shape)}")

    def init(generator=None):
        """Fresh parameters with the JAX tree's keys and shapes, drawn from
        ``generator`` and placed on the model's device."""
        gru_sizes = [2 * latents + input_dim, hidden_units]
        params = {
            "enc_ode": mlp_init(generator, [latents, hidden_units, latents], dtype=dtype),
            "enc_gru": {
                "update": mlp_init(generator, gru_sizes + [latents], dtype=dtype),
                "reset": mlp_init(generator, gru_sizes + [latents], dtype=dtype),
                "state": mlp_init(generator, gru_sizes + [2 * latents], dtype=dtype),
            },
            "dec_ode": mlp_init(generator, [latents, hidden_units, hidden_units, latents], dtype=dtype),
            "dec_out": linear_init(generator, latents, input_dim, dtype=dtype),
        }
        return tree_map(lambda x: x.to(device), params)

    def _gru_update(p, y_mean, y_std, x):
        """GRU over (mean, std) pairs (encoder_decoder.py GRU_unit :22-103;
        every observation is present, so no mask)."""
        concat = torch.cat([y_mean, y_std, x], dim=-1)
        update = torch.sigmoid(mlp_apply_tanh(p["update"], concat))
        reset = torch.sigmoid(mlp_apply_tanh(p["reset"], concat))
        new = mlp_apply_tanh(p["state"], torch.cat([y_mean * reset, y_std * reset, x], dim=-1))
        new_mean, new_std = new[..., :latents], new[..., latents:]
        y_mean = (1.0 - update) * new_mean + update * y_mean
        y_std = (1.0 - update) * torch.abs(new_std) + update * y_std
        return y_mean, y_std

    def encode_history(params, obs_hist, act_hist):
        """obs_hist [B, A, n], act_hist [B, A, m] -> (z_mean, z_std) [B, latents]."""
        obs_n = (obs_hist - state_mean) / state_std if normalize else obs_hist
        x_seq = torch.cat([obs_n, act_hist], dim=-1)
        A = obs_hist.shape[1]
        times = torch.arange(-(A - 1), 1, dtype=x_seq.dtype, device=x_seq.device) * dt
        gaps = torch.diff(times, prepend=times[:1])  # the first gap is 0
        y_mean = x_seq.new_zeros((x_seq.shape[0], latents))
        y_std = x_seq.new_zeros((x_seq.shape[0], latents))
        for a in range(A):
            if a > 0:  # a gap of 0 leaves y_mean as it is
                h = gaps[a] / _ENCODER_SUBSTEPS
                for _ in range(_ENCODER_SUBSTEPS):
                    y_mean = y_mean + h * mlp_apply_tanh(params["enc_ode"], y_mean)
            y_mean, y_std = _gru_update(params["enc_gru"], y_mean, y_std, x_seq[:, a])
        return y_mean, torch.abs(y_std) + 1e-6

    def _dec_rhs(params):
        return lambda z, t: mlp_apply_tanh(params["dec_ode"], z)

    def predict_diff(params, eps, obs_hist, act_hist, ts):
        """Decode z0 = z_mean + z_std * eps for each draw of ``eps`` [S, B,
        latents] at each row's own horizon ts [B, 1] (the reference asserts
        one shared horizon per batch, w_latent_ode.py:177-181). Returns the
        decoded [S, B, n + m] and (z_mean, z_std)."""
        z_mean, z_std = encode_history(params, obs_hist, act_hist)
        S, B = eps.shape[0], z_mean.shape[0]
        z0 = (z_mean[None] + z_std[None] * eps).reshape(S * B, latents)
        t1 = ts.reshape(-1).to(z0.dtype).repeat(S)
        zs = odeint_dopri5(_dec_rhs(params), z0, torch.stack([torch.zeros_like(t1), t1], dim=1),
                           rtol=1e-3, atol=1e-4, max_steps=_DECODER_MAX_STEPS)
        return linear_apply(params["dec_out"], zs[-1]).reshape(S, B, input_dim), (z_mean, z_std)

    def apply(params, obs, action_buffer, ts):
        """Planning-path forward: the predicted state diff [B, n], the
        history the tiled current observation, z0's noise the fixed draw."""
        A = action_buffer.shape[1]
        obs_hist = obs[:, None, :].expand(obs.shape[0], A, obs.shape[1])
        eps = tile_rows(z0_noise, obs.shape[0])[None].to(obs.dtype)
        outs, _ = predict_diff(params, eps, obs_hist, action_buffer[..., :action_dim], ts)
        return outs[0][..., :state_dim]

    def train_step(params, eps, hist_obs, hist_act, ts, target_diff):
        """The IWAE loss (base_models.py:332-334) over the draws ``eps``
        [3, B, latents]: -mean_B logsumexp_S (rec_ll - kl) + log S."""
        outs, (z_mean, z_std) = predict_diff(params, eps, hist_obs, hist_act, ts)
        # data_to_predict pads the action channels with zeros (w_latent_ode.py:112-118)
        target = torch.cat([target_diff, target_diff.new_zeros(target_diff.shape[:-1] + (action_dim,))], dim=-1)
        sigma2 = obsrv_std**2
        rec_ll = -0.5 * torch.sum((outs - target[None]) ** 2 / sigma2 + math.log(2 * math.pi * sigma2), dim=-1)
        kl = 0.5 * torch.sum(z_std**2 + z_mean**2 - 1.0 - 2.0 * torch.log(z_std), dim=-1)
        iwae = torch.logsumexp(rec_ll - _KL_COEF * kl[None], dim=0) - math.log(float(eps.shape[0]))
        return -torch.mean(iwae)

    def decoder_nfes(params, obs, action_buffer, ts):
        """Accepted dopri5 steps x 7 for one decode of z_mean from the tiled
        observation to the first row's horizon, [1] int32: the reference's
        _get_and_reset_nfes (w_latent_ode.py:207-227). As in the JAX model,
        the B rows are one trajectory here: one step size for all, the
        error norm over every row's latents."""
        A = action_buffer.shape[1]
        obs_hist = obs[:, None, :].expand(obs.shape[0], A, obs.shape[1])
        z_mean, _ = encode_history(params, obs_hist, action_buffer[..., :action_dim])
        t1 = ts.reshape(-1)[:1].to(z_mean.dtype)
        _, n_acc = odeint_dopri5_with_stats(
            _dec_rhs(params), z_mean[None], torch.stack([torch.zeros_like(t1), t1], dim=1),
            rtol=1e-3, atol=1e-4, max_steps=_DECODER_MAX_STEPS)
        return 7 * n_acc[:, 0]

    return LatentODEModel(
        name="latent_ode", init=init, apply=apply, encode_history=encode_history,
        predict_diff=predict_diff, train_step=train_step, decoder_nfes=decoder_nfes,
        z0_noise=z0_noise, state_dim=state_dim, action_dim=action_dim, latents=latents,
    )


def make_carried_dynamics(model: LatentODEModel, params, dt: float, state_dim: int, action_dim: int,
                          action_buffer_size: int = 4):
    """History-carrying planner dynamics: the rollout carries the last A
    rollout states as the encoder's history (the functional counterpart of
    the reference's batch_obs_buffer, w_latent_ode.py:160-172). Returns
    ``(carry_init(state0) -> carry, dynamics(carry, state, window) ->
    (carry, next_state))``; z0's noise is the model's fixed draw.
    ``action_buffer_size`` must match the training window length."""
    ts_cache = {}

    def carry_init(state0):
        return state0[:, None, :].expand(state0.shape[0], action_buffer_size, state0.shape[1])

    def dynamics(carry, state, window):
        hist = torch.cat([carry[:, 1:], state[:, None]], dim=1)
        key = (state.shape[0], state.dtype, state.device)
        if key not in ts_cache:
            ts_cache[key] = (torch.full((state.shape[0], 1), dt, dtype=state.dtype, device=state.device),
                             tile_rows(model.z0_noise, state.shape[0])[None].to(state.dtype))
        ts, eps = ts_cache[key]
        outs, _ = model.predict_diff(params, eps, hist, window[..., :action_dim], ts)
        return hist, state + outs[0][..., :state_dim]

    return carry_init, dynamics

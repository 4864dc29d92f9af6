"""Neural Laplace dynamics model, the flagship (port of ``models/nl.py``).

Architecture per reference w_nl.py:
- ReverseGRUEncoder (:14-29): the action buffer is flipped along time and
  run through a 2-layer GRU (hidden = nl_hidden_units//2 = 64), last hidden
  state -> Linear -> 2-dim action latent.
- LaplaceRepresentationFunc (:32-63): MLP (2*terms + latent) -> hidden ->
  hidden -> 2*terms*out_dim with tanh activations; outputs split into
  Riemann-sphere angles theta in (-pi, pi), phi in (-pi/2, pi/2) via scaled
  tanh.
- forward (:117-145): normalize state/action (time by dt*8), encode actions,
  p = concat(obs, action_latent), reconstruct the state-diff through the
  fourier ILT (ops.ilt.laplace_reconstruct, 17 terms).

``apply`` is the plain PyTorch forward at any float dtype; the planner's
``make_fused_planner_apply`` runs the whole forward as one CUDA kernel
(ops.pallas_nl) on weights packed for one shared query time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.ilt import effective_terms, laplace_reconstruct
from ..ops.pallas_ilt import to_device
from ..ops.pallas_nl import nl_forward_fused, pack_nl_forward
from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import gru_apply, linear_apply, mlp_apply_tanh

_ACTION_LATENT = 2  # w_nl.py:89


def make_nl_model(
    state_dim: int,
    action_dim: int,
    norm: NormStats,
    s_recon_terms: int = 17,
    ilt_algorithm: str = "fourier",
    encode_obs_time: bool = False,
    normalize: bool = True,
    normalize_time: bool = True,
    dt: float = 0.05,
    dtype=torch.float32,
    compute_dtype: str = "float32",
    device="cuda",
) -> DynamicsModel:
    device = resolve_device(device)
    if ilt_algorithm != "fourier":
        raise NotImplementedError(f"NL with ILT {ilt_algorithm!r} is not ported yet; only 'fourier' is")
    if compute_dtype != "float32":
        raise NotImplementedError(f"nl_compute_dtype={compute_dtype!r} is not ported yet")
    s_recon_terms = effective_terms(s_recon_terms, ilt_algorithm)
    gru_in = action_dim + (1 if encode_obs_time else 0)

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    state_mean, state_std = tensor(norm.state_mean), tensor(norm.state_std)
    action_mean, action_std = tensor(norm.action_mean), tensor(norm.action_std)

    def rep_fn(params, theta_s, phi_s, p):
        """(theta_s, phi_s)[B,terms] + p[B,L] -> sphere angles [B,D,terms]."""
        x = torch.cat([theta_s, phi_s, p], dim=-1)
        out = mlp_apply_tanh(params, x)
        out = out.reshape(out.shape[:-1] + (2 * state_dim, s_recon_terms))
        theta = torch.tanh(out[..., :state_dim, :]) * math.pi
        phi = torch.tanh(out[..., state_dim:, :]) * (math.pi / 2.0)
        return theta, phi

    def _norm_actions(action_buffer):
        # normalize only the action channels; a time-age channel
        # (encode_obs_time) passes through raw
        acts = action_buffer[..., :action_dim]
        acts = (acts - action_mean) / action_std if normalize else acts / 3.0
        return torch.cat([acts, action_buffer[..., action_dim:]], dim=-1)

    def _encode_actions(params, action_buffer, out_dtype):
        """Reverse-GRU action encoding (w_nl.py:25-29) -> [B, 2] action latent."""
        act_n = _norm_actions(action_buffer)
        if act_n.dim() == 2:
            act_n = act_n[:, None, :]
        lead = act_n.shape[:-2]
        rev = torch.flip(act_n, dims=(-2,)).reshape((-1,) + act_n.shape[-2:])
        h = gru_apply(params["encoder"]["gru"], rev)
        p_action = linear_apply(params["encoder"]["out"], h).to(out_dtype)
        return p_action.reshape(lead + (_ACTION_LATENT,))

    def _decode(params, obs, p_action, ts):
        """Laplace-side forward given the action latent."""
        if normalize:
            obs_n = (obs - state_mean) / state_std
            if normalize_time:
                ts = ts / (dt * 8.0)  # w_nl.py:123
        else:
            obs_n = obs  # w_nl.py:129
        # floor the query time in the units ts has here: the fourier
        # contour's e^{sigma t}/T prefactor grows like 1/t (f32 stability)
        ts = torch.clamp_min(ts, 2.5e-3 if (normalize and normalize_time) else 2.5e-3 * dt * 8.0)
        p = torch.cat([obs_n, p_action.to(obs_n.dtype)], dim=-1)
        return laplace_reconstruct(
            lambda theta_s, phi_s, p_: rep_fn(params["laplace_rep"], theta_s, phi_s, p_),
            p,
            ts,
            recon_dim=state_dim,
            algorithm=ilt_algorithm,
            terms=s_recon_terms,
        )

    def apply(params, obs, action_buffer, ts):
        """obs [B,n], action_buffer [B,A,m(+t)], ts [B,1] or [B] -> [B,n]."""
        p_action = _encode_actions(params, action_buffer, obs.dtype)
        return _decode(params, obs, p_action, ts)

    def make_fused_planner_apply(params, t: float):
        """Planner-specialized forward through the fused kernel (ops.pallas_nl).

        Valid when every query shares one horizon ``t`` (the planner's ts_pred
        is a constant dt vector). Normalizations and the fixed contour are
        folded into the packed float32 weights, so the kernel consumes RAW obs
        and action buffers; the returned function ignores its params and ts
        arguments (re-specialize after a parameter update).
        """
        t_model = t / (dt * 8.0) if (normalize and normalize_time) else t
        t_floor = 2.5e-3 if (normalize and normalize_time) else 2.5e-3 * dt * 8.0
        t_model = max(t_model, t_floor)
        packed = to_device(
            pack_nl_forward(
                params, t_model, state_dim, action_dim, s_recon_terms,
                norm.state_mean, norm.state_std, norm.action_mean, norm.action_std,
                normalize=normalize, encode_obs_time=encode_obs_time,
            ),
            device,
        )

        def apply_fused(p_ignored, obs, action_buffer, ts):
            del p_ignored, ts  # fixed at specialization time
            B, A = action_buffer.shape[0], action_buffer.shape[1]
            acts_flat = action_buffer.reshape(B, A * gru_in).contiguous()
            return nl_forward_fused(
                obs.contiguous(), acts_flat, packed, state_dim, gru_in, terms=s_recon_terms
            )

        apply_fused.packed = packed
        return apply_fused

    return DynamicsModel(name="nl", apply=apply, make_fused_planner_apply=make_fused_planner_apply)

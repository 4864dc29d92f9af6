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
  p = concat(obs, action_latent), reconstruct the state-diff through the ILT
  (ops.ilt.laplace_reconstruct, default algorithm 'fourier', 17 terms).

``apply`` is the plain PyTorch forward at any float dtype, under any of the
six ILT algorithms, and the one that training differentiates; the planner's
``make_fused_planner_apply`` runs the whole forward as one CUDA kernel
(ops.pallas_nl) on weights packed for one shared query time, for the
fourier ILT only, at any width: ragged widths are zero-padded at pack time,
and widths whose weights do not fit in shared memory run the kernel's
weight-streaming variant.

``compute_dtype="bfloat16"`` runs the matrix stack (the GRU, its head and
the trunk MLP) in bfloat16, as the JAX model does: the MLP's output goes
back to float32 before the theta/phi tanh heads, and the normalization, the
sphere map and the ILT stay float32. The parameter tree keeps its dtypes,
so a checkpoint loads in either mode. The fused route packs float32 weights
whatever the compute dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import snap_cme_terms
from ..ops.ilt import effective_terms, laplace_reconstruct
from ..ops.pallas_ilt import to_device
from ..ops.pallas_nl import ACTION_STEPS, nl_forward_fused, pack_nl_forward, repack_nl_forward
from ..utils.device import resolve_device
from .base import DynamicsModel, NormStats
from .common import gru_apply, gru_init, linear_apply, linear_init, mlp_apply_tanh, mlp_init, tree_leaves, tree_map

_ACTION_LATENT = 2  # w_nl.py:89
_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_nl_model(
    state_dim: int,
    action_dim: int,
    norm: NormStats,
    hidden_units: int = 128,
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
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"nl_compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, not {compute_dtype!r}")
    cdtype = _COMPUTE_DTYPES[compute_dtype]
    if ilt_algorithm == "cme":
        s_recon_terms = snap_cme_terms(s_recon_terms)  # w_nl.py:86-88
    # every algorithm's true node count; the MLP head is sized from it
    s_recon_terms = effective_terms(s_recon_terms, ilt_algorithm)
    laplace_latent_dim = state_dim + _ACTION_LATENT  # w_nl.py:90
    gru_in = action_dim + (1 if encode_obs_time else 0)
    gru_hidden = hidden_units // 2

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    state_mean, state_std = tensor(norm.state_mean), tensor(norm.state_std)
    action_mean, action_std = tensor(norm.action_mean), tensor(norm.action_std)

    def init(generator=None):
        """Fresh parameters with the JAX tree's keys and shapes, drawn from
        ``generator`` (on its device) and placed on the model's device."""
        params = {
            "encoder": {
                "gru": gru_init(generator, gru_in, gru_hidden, num_layers=2, dtype=dtype),
                "out": linear_init(generator, gru_hidden, _ACTION_LATENT, dtype=dtype),
            },
            "laplace_rep": mlp_init(
                generator,
                [s_recon_terms * 2 + laplace_latent_dim, hidden_units, hidden_units,
                 s_recon_terms * 2 * state_dim],
                dtype=dtype,
            ),
        }
        return tree_map(lambda x: x.to(device), params)

    # the last parameter tree cast to the compute dtype, reused while its
    # leaves are the same tensors at the same version (a planner calls the
    # forward T times a plan on one tree); never for leaves that autograd
    # tracks, whose casts belong to one graph
    cast_cache = {"encoder": {}, "laplace_rep": {}}

    def _compute_cast(tree, part: str):
        if cdtype == torch.float32:
            return tree
        leaves = tree_leaves(tree)
        if any(x.requires_grad for x in leaves):
            return tree_map(lambda x: x.to(cdtype), tree)
        cache, key = cast_cache[part], tuple((id(x), x._version) for x in leaves)
        if cache.get("key") != key:  # the leaves stay referenced, so their ids stay theirs
            cache.update(key=key, leaves=leaves, cast=tree_map(lambda x: x.to(cdtype), tree))
        return cache["cast"]

    def rep_fn(params, theta_s, phi_s, p):
        """(theta_s, phi_s)[B,terms] + p[B,L] -> sphere angles [B,D,terms]."""
        x = torch.cat([theta_s, phi_s, p], dim=-1)
        if cdtype == torch.float32:
            out = mlp_apply_tanh(params, x)
        else:
            out = mlp_apply_tanh(_compute_cast(params, "laplace_rep"), x.to(cdtype)).to(torch.float32)
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
        if cdtype != torch.float32:
            rev = rev.to(cdtype)
        enc = _compute_cast(params["encoder"], "encoder")
        h = gru_apply(enc["gru"], rev)
        p_action = linear_apply(enc["out"], h).to(out_dtype)
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

    def make_fused_planner_apply(params, t: float, actions: int = ACTION_STEPS):
        """Planner-specialized forward through the fused kernel (ops.pallas_nl).

        Valid when every query shares one horizon ``t`` (the planner's ts_pred
        is a constant dt vector). Normalizations and the fixed contour are
        folded into the packed float32 weights, so the kernel consumes RAW obs
        and action buffers; the returned function ignores its params and ts
        arguments (re-specialize after a parameter update).

        Any width: ``repack_nl_forward`` zero-pads ragged ones, and packs the
        wide layout, which the kernel library streams, for dims whose
        weights do not fit in shared memory over ``actions`` action steps
        (the planner's action buffer). Raises ``ValueError`` for another ILT than fourier; it never
        falls back to the plain forward.
        """
        if ilt_algorithm != "fourier":
            raise ValueError(f"the fused planner path is fourier-only, not {ilt_algorithm!r}")
        t_model = t / (dt * 8.0) if (normalize and normalize_time) else t
        t_floor = 2.5e-3 if (normalize and normalize_time) else 2.5e-3 * dt * 8.0
        t_model = max(t_model, t_floor)
        host = pack_nl_forward(
            params, t_model, state_dim, action_dim, s_recon_terms,
            norm.state_mean, norm.state_std, norm.action_mean, norm.action_std,
            normalize=normalize, encode_obs_time=encode_obs_time,
        )
        packed = to_device(host, device)
        # the kernel's own layout, built once here; the CPU path never reads it
        hopper = torch.as_tensor(repack_nl_forward(host, state_dim, gru_in, s_recon_terms, actions),
                                 device=device)

        def apply_fused(p_ignored, obs, action_buffer, ts):
            del p_ignored, ts  # fixed at specialization time
            B, A = action_buffer.shape[0], action_buffer.shape[1]
            acts_flat = action_buffer.reshape(B, A * gru_in).contiguous()
            return nl_forward_fused(
                obs.contiguous(), acts_flat, packed, state_dim, gru_in, terms=s_recon_terms,
                hopper=hopper,
            )

        apply_fused.packed = packed
        apply_fused.hopper = hopper
        return apply_fused

    def make_planner_window_encoder(params):
        """The planner's ``window_encoder``: every candidate action window
        [K, T, A, m(+age)] through the reverse GRU in one call -> [K, T, 2].
        The NL window encoding sees only the actions (w_nl.py:117-127), so
        it can leave the horizon loop; the latents follow the windows' dtype,
        as ``apply``'s follow the observation's."""

        def encode(windows):
            return _encode_actions(params, windows, windows.dtype)

        return encode

    def apply_encoded(params, obs, p_action, ts):
        """``apply`` with the action latent precomputed:
        apply(params, o, w, ts) == apply_encoded(params, o, encode(w), ts)."""
        return _decode(params, obs, p_action, ts)

    return DynamicsModel(name="nl", init=init, apply=apply, make_fused_planner_apply=make_fused_planner_apply,
                         make_planner_window_encoder=make_planner_window_encoder, apply_encoded=apply_encoded)

"""int8-quantized NL planner forward (port of ``ops/quant.py``).

The last rung of the precision ladder after float32 and bfloat16: every
matrix product of the NL forward in int8 with an int32 accumulator. The NL
network suits it:

- every recurrent and hidden activation is bounded in (-1, 1) by a tanh or a
  convex combination, so the activation scales are analytic and static (no
  calibration pass and no max-reduction at run time);
- the planner feeds normalized actions bounded by action_high / std = 2
  (``models.base.norm_stats_for``) and sphere angles bounded by pi;
- what is numerically delicate (the normalization, the theta/phi heads and
  the ILT) stays float32, as on the bfloat16 route (``models.nl``).

The scheme: symmetric int8 with each input feature's bound folded into the
weights (so every quantized activation has the scale 127), per-output-channel
weight scales, and int8 x int8 -> int32 products through ``torch._int_mm``
(cuBLASLt's integer GEMM on the card). Activations beyond their bound
saturate, as in any int8 pipeline. Rounding is half to even, as in the JAX
package.

``torch._int_mm`` on CUDA takes more than 16 rows and inner and outer sizes
that are multiples of 8. The weights are therefore zero-padded once, at
quantization time, to those multiples (``wq_mm``, stored [n_pad, k_pad] and
handed over transposed, the column-major operand cuBLASLt takes), and each
activation is zero-padded to the padded inner size and to at least 17 rows:
the padded products add exact zeros to the int32 sums, and the padded rows
and columns are dropped. The same padded product runs on the CPU, so the CPU
tests reach it. Nothing falls back to a float product.

Like the JAX module, this is an experiment that ``Config`` does not reach:
pass ``quantized_apply_for(...)`` as ``model_apply``. ``scripts/bench_int8_torch.py``
measures it on the card.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .pallas_nl import gru_gates
from .ilt import fourier_spherical_host, laplace_reconstruct

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA: more than 16 rows
_INT_MM_ALIGN = 8  # torch._int_mm on CUDA: inner and outer sizes multiples of 8


def _round_up(x: int, m: int = _INT_MM_ALIGN) -> int:
    return -(-x // m) * m


def _quantize_matrix(w: torch.Tensor, in_bounds: torch.Tensor):
    """Fold the per-input-feature bounds into ``w`` [in, out] and quantize per
    output channel: (wq int8 [in, out], scale f32 [out]), with ``(xq @ wq) *
    scale`` the product for xq = x / bound * 127."""
    w_folded = w * in_bounds[:, None]
    col_max = torch.clamp_min(torch.amax(torch.abs(w_folded), dim=0), 1e-30)
    wq = torch.round(w_folded / col_max * 127.0).to(torch.int8)
    # the scale folds both 1/127 factors (the activation and weight grids)
    return wq, (col_max / (127.0 * 127.0)).to(torch.float32)


def pad_for_int_mm(wq: torch.Tensor) -> torch.Tensor:
    """``wq`` [k, n] -> the product's operand [n_pad, k_pad] (transposed,
    zero-padded to multiples of 8, contiguous)."""
    k, n = wq.shape
    return F.pad(wq.T, (0, _round_up(k) - k, 0, _round_up(n) - n)).contiguous()


def _quantize_acts(x: torch.Tensor, in_bounds) -> torch.Tensor:
    return torch.round(torch.clamp(x / in_bounds, -1.0, 1.0) * 127.0).to(torch.int8)


def int8_matmul_int32(xq: torch.Tensor, wq_mm: torch.Tensor) -> torch.Tensor:
    """The int32 sums ``xq @ wq`` [B, n] of int8 ``xq`` [B, k] and the padded
    operand ``wq_mm`` [n_pad, k_pad] of ``wq`` [k, n], through one
    ``torch._int_mm`` on rows and columns zero-padded to its sizes; the
    caller slices the n live columns."""
    B, k = xq.shape
    pad_k, pad_b = wq_mm.shape[1] - k, max(0, _INT_MM_MIN_ROWS - B)
    if pad_k or pad_b:
        xq = F.pad(xq, (0, pad_k, 0, pad_b))
    return torch._int_mm(xq, wq_mm.t())[:B]


def _int8_matmul(xq, wq_mm, n: int, scale, b):
    y = int8_matmul_int32(xq, wq_mm)[:, :n]
    return y.to(torch.float32) * scale + b


def _q_linear(x: torch.Tensor, in_bounds, wq_mm, scale, b, keep_nan: bool = True) -> torch.Tensor:
    """Quantize the activations and take the int8 product, NaN kept.

    The cast of a NaN to int8 gives a finite value, which would let a
    diverged rollout (NaN everywhere on the float32 route) return ordinary
    outputs; the ``0 * sum`` term is NaN where any input is, and adds zero
    elsewhere. ``keep_nan=False`` leaves it out where the caller's next step
    reads ``x`` itself (the GRU's hidden product: the gates mix h back in).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _int8_matmul(_quantize_acts(x2, in_bounds), wq_mm, scale.shape[0], scale, b)
    if keep_nan:
        y = y + 0.0 * torch.sum(x2, dim=-1, keepdim=True)
    return y.reshape(lead + (scale.shape[0],))


def _linear_l1_bounds(p: Mapping, in_bounds: torch.Tensor) -> torch.Tensor:
    """The analytic bound of each output, |y_j| <= sum_i |w_ij| b_i + |b_j|."""
    return torch.abs(p["w"]).T @ in_bounds + torch.abs(p["b"])


def quantize_nl_params(
    params: Mapping,
    *,
    state_dim: int,
    action_dim: int,
    s_recon_terms: int,
    obs_bound: float | Sequence[float] = 6.0,
    action_bound: float = 2.0,
) -> dict:
    """Quantize a trained NL parameter tree (``models.nl``'s layout) to int8,
    on the tree's device.

    ``obs_bound`` bounds |normalized obs| per state channel (a scalar or one
    per channel): 6 sigma covers the expert data, and planner rollouts that
    exceed it saturate. ``action_bound`` bounds the normalized actions, 2.0
    for every env (action_high / (action_high / 2)). The keys are the JAX
    package's, with each int8 matrix's padded product operand beside it
    (``wq_mm``, ``wq_ih_mm``, ``wq_hh_mm``).
    """
    f32 = dict(dtype=torch.float32, device=params["encoder"]["out"]["w"].device)

    def as_f32(x):
        return torch.as_tensor(x, **f32)

    obs_b = torch.broadcast_to(torch.as_tensor(obs_bound, **f32), (state_dim,))
    gru_layers = []
    in_bounds = torch.full((action_dim,), float(action_bound), **f32)
    h_bounds = None
    for p in params["encoder"]["gru"]:
        hidden = p["w_hh"].shape[0]
        h_bounds = torch.ones((hidden,), **f32)  # |h| < 1 by the GRU's algebra
        wq_ih, s_ih = _quantize_matrix(as_f32(p["w_ih"]), in_bounds)
        wq_hh, s_hh = _quantize_matrix(as_f32(p["w_hh"]), h_bounds)
        gru_layers.append({
            "wq_ih": wq_ih, "wq_ih_mm": pad_for_int_mm(wq_ih), "s_ih": s_ih, "b_ih": as_f32(p["b_ih"]),
            "wq_hh": wq_hh, "wq_hh_mm": pad_for_int_mm(wq_hh), "s_hh": s_hh, "b_hh": as_f32(p["b_hh"]),
            "in_bounds": in_bounds,
        })
        in_bounds = h_bounds  # the next layer reads this layer's h
    out_p = {k: as_f32(v) for k, v in params["encoder"]["out"].items()}
    wq_out, s_out = _quantize_matrix(out_p["w"], h_bounds)
    p_action_bound = _linear_l1_bounds(out_p, h_bounds)  # analytic, exact

    # the rep MLP's input: [theta_s (pi), phi_s (pi/2), obs_n, p_action]
    mlp_in_bounds = torch.cat([
        torch.full((s_recon_terms,), math.pi, **f32),
        torch.full((s_recon_terms,), math.pi / 2.0, **f32),
        obs_b,
        p_action_bound,
    ])
    mlp_layers = []
    in_b = mlp_in_bounds
    for layer in params["laplace_rep"]:
        w = as_f32(layer["w"])
        wq, s = _quantize_matrix(w, in_b)
        mlp_layers.append({"wq": wq, "wq_mm": pad_for_int_mm(wq), "s": s, "b": as_f32(layer["b"]),
                           "w": w, "in_bounds": in_b})  # the float32 copy for mixed configs
        in_b = torch.ones((w.shape[1],), **f32)  # tanh-bounded hidden
    return {
        "gru": gru_layers,
        "gru_f32": [{k: as_f32(v) for k, v in p.items()} for p in params["encoder"]["gru"]],
        "enc_out": {"wq": wq_out, "wq_mm": pad_for_int_mm(wq_out), "s": s_out, "b": out_p["b"],
                    "in_bounds": h_bounds},
        "enc_out_f32": out_p,
        "mlp": mlp_layers,
        "mlp_in_bounds": mlp_in_bounds,
    }


def _gru_q(layers, xs: torch.Tensor) -> torch.Tensor:
    """The int8 GRU over ``xs`` [B, T, in] -> the last layer's final h [B, H].

    A layer's input products do not depend on its own recurrence, so each
    layer takes them for all T steps in one product before stepping; every
    row's quantization and integer sums are the ones a step-by-step run
    takes, so the outputs are the same.
    """
    B, T = xs.shape[0], xs.shape[1]
    for p in layers:
        gi = _q_linear(xs, p["in_bounds"], p["wq_ih_mm"], p["s_ih"], p["b_ih"])  # [B, T, 3H]
        h = xs.new_zeros((B, p["wq_hh"].shape[0]))
        hs = []
        for t in range(T):
            # |h| < 1; the gates read h itself, so a NaN in h reaches the output
            gh = _q_linear(h, 1.0, p["wq_hh_mm"], p["s_hh"], p["b_hh"], keep_nan=False)
            h = gru_gates(gi[:, t], gh, h)
            hs.append(h)
        xs = torch.stack(hs, dim=1)
    return h


def make_int8_nl_apply(
    qparams: dict,
    *,
    state_dim: int,
    action_dim: int,
    s_recon_terms: int,
    norm,
    ilt_algorithm: str = "fourier",
    normalize: bool = True,
    normalize_time: bool = True,
    dt: float = 0.05,
    quantize_gru: bool = True,
    mlp_int8_layers: Sequence[int] = (0, 1, 2),
    fold_t: float | None = None,
):
    """A ``model.apply`` with the matrix stack in int8; its params argument
    is ignored (the quantized weights are bound here, as in
    ``make_fused_planner_apply``). It runs on ``qparams``'s device.

    It computes what ``models.nl``'s apply computes (the normalization of
    w_nl.py:119-129, the horizon floor, the [theta_s, phi_s, p] input, the
    theta/phi heads of w_nl.py:57-63) with every product quantized;
    ``quantize_gru=False`` keeps the GRU and its head in float32, and
    ``mlp_int8_layers`` names the MLP layers that run in int8. Buffers with an
    age channel (``encode_obs_time``) are not taken: the age is unbounded.

    ``fold_t`` specializes it for the planner: when every query shares one
    raw horizon ``t``, the sphere-angle block of the MLP's input is a batch
    constant and folds exactly into layer 0's bias (the fold of
    ``ops.pallas_nl.pack_nl_forward``). That removes the largest int8 error
    term, the theta/phi features on a pi/127 grid. The returned apply then
    ignores its ts argument.
    """
    w0 = qparams["mlp"][0]["w"]
    f32 = dict(dtype=torch.float32, device=w0.device)
    state_mean = torch.as_tensor(np.asarray(norm.state_mean), **f32)
    state_std = torch.as_tensor(np.asarray(norm.state_std), **f32)
    action_mean = torch.as_tensor(np.asarray(norm.action_mean), **f32)
    action_std = torch.as_tensor(np.asarray(norm.action_std), **f32)

    t_floor = 2.5e-3 if (normalize and normalize_time) else 2.5e-3 * dt * 8.0
    folded = None
    if fold_t is not None:
        if ilt_algorithm != "fourier":
            raise ValueError(f"fold_t is fourier-only (as pack_nl_forward), not {ilt_algorithm!r}")
        t_model = fold_t / (dt * 8.0) if (normalize and normalize_time) else fold_t
        t_model = max(float(t_model), t_floor)
        th_s, ph_s = fourier_spherical_host(t_model, s_recon_terms)
        tp = torch.as_tensor(np.concatenate([th_s, ph_s]), **f32)  # [2 terms]
        # the exact fold: [tp, p] @ w0 + b0 == p @ w0[2T:] + (b0 + tp @ w0[:2T])
        w_p = w0[2 * s_recon_terms:, :]
        b_eff = qparams["mlp"][0]["b"] + tp @ w0[: 2 * s_recon_terms, :]
        in_b_p = qparams["mlp_in_bounds"][2 * s_recon_terms:]
        wq_p, s_p = _quantize_matrix(w_p, in_b_p)
        folded = {"t_model": t_model, "wq": wq_p, "wq_mm": pad_for_int_mm(wq_p), "s": s_p, "b": b_eff,
                  "w": w_p, "in_bounds": in_b_p}

    def rep_fn(theta_s, phi_s, p):
        if folded is not None:
            x = p.to(torch.float32)
            if 0 in mlp_int8_layers:
                x = _q_linear(x, folded["in_bounds"], folded["wq_mm"], folded["s"], folded["b"])
            else:
                x = x @ folded["w"] + folded["b"]
            x = torch.tanh(x)
            layers = list(enumerate(qparams["mlp"]))[1:]
        else:
            x = torch.cat([theta_s, phi_s, p], dim=-1).to(torch.float32)
            layers = list(enumerate(qparams["mlp"]))
        for i, layer in layers:
            if i in mlp_int8_layers:
                x = _q_linear(x, layer["in_bounds"], layer["wq_mm"], layer["s"], layer["b"])
            else:
                x = x @ layer["w"] + layer["b"]
            if i < len(qparams["mlp"]) - 1:
                x = torch.tanh(x)
        out = x.reshape(x.shape[:-1] + (2 * state_dim, s_recon_terms))
        theta = torch.tanh(out[..., :state_dim, :]) * math.pi
        phi = torch.tanh(out[..., state_dim:, :]) * (math.pi / 2.0)
        return theta, phi

    def apply(params_ignored, obs, action_buffer, ts):
        del params_ignored
        acts = (action_buffer - action_mean) / action_std if normalize else action_buffer / 3.0
        if acts.dim() == 2:
            acts = acts[:, None, :]
        rev = torch.flip(acts.to(torch.float32), dims=(-2,))
        if quantize_gru:
            eo = qparams["enc_out"]
            p_action = _q_linear(_gru_q(qparams["gru"], rev), eo["in_bounds"], eo["wq_mm"], eo["s"], eo["b"])
        else:
            from ..models.common import gru_apply, linear_apply

            p_action = linear_apply(qparams["enc_out_f32"], gru_apply(qparams["gru_f32"], rev))
        obs_n = ((obs - state_mean) / state_std if normalize else obs).to(torch.float32)
        if folded is not None:  # the fold's horizon, whatever ts says
            ts = torch.full((obs.shape[0],), folded["t_model"], **f32)
        else:
            if normalize and normalize_time:
                ts = ts / (dt * 8.0)
            ts = torch.clamp_min(ts, t_floor)
        p = torch.cat([obs_n, p_action], dim=-1)
        return laplace_reconstruct(rep_fn, p, ts, recon_dim=state_dim, algorithm=ilt_algorithm,
                                   terms=s_recon_terms)

    return apply


def planner_saturation_probe(
    apply_fn,
    params,
    norm,
    obs0: torch.Tensor,
    *,
    action_high,
    action_dim: int,
    K: int,
    T: int,
    dt: float,
    generator: torch.Generator | None = None,
    action_buffer_size: int = 4,
    obs_bound: float | Sequence[float] = 6.0,
    actions: torch.Tensor | None = None,
):
    """How often planner-rollout observations leave ``obs_bound``.

    The int8 route saturates normalized observations at ``obs_bound``
    (``quantize_nl_params``). Diverged rollouts are the ones MPPI should
    penalize, so a high clipped fraction foretells a loss of int8 quality.
    The probe rolls out as the planner does (windows sliding over [history,
    actions], state' = state + apply(state, window, dt)) under uniform
    random actions in [-action_high, action_high] drawn from ``generator``
    (or the draw ``actions`` [K, T, action_dim] handed in), and reports the
    fraction of |obs_n| > obs_bound at each horizon step with its mean and
    max. Pass the float32 apply: saturation is measured on the unclipped
    dynamics that the int8 route approximates.
    """
    f32 = dict(dtype=torch.float32, device=obs0.device)
    state_mean = torch.as_tensor(np.asarray(norm.state_mean), **f32)
    state_std = torch.as_tensor(np.asarray(norm.state_std), **f32)
    obs_b = torch.broadcast_to(torch.as_tensor(obs_bound, **f32), (obs0.shape[-1],))
    if actions is None:
        a_high = torch.broadcast_to(torch.as_tensor(action_high, **f32), (action_dim,))
        actions = (torch.rand((K, T, action_dim), generator=generator, **f32) * 2.0 - 1.0) * a_high
    hist = torch.zeros((K, action_buffer_size - 1, action_dim), **f32)
    full = torch.cat([hist, actions.to(**f32)], dim=1)  # [K, A - 1 + T, nu]
    state = torch.broadcast_to(obs0.to(torch.float32), (K,) + tuple(obs0.shape[-1:]))
    ts_pred = torch.full((K, 1), dt, **f32)
    fracs = []
    for t in range(T):
        state = state + apply_fn(params, state, full[:, t:t + action_buffer_size], ts_pred)
        obs_n = (state - state_mean) / state_std
        fracs.append(torch.mean((torch.abs(obs_n) > obs_b).to(torch.float32)))
    fracs = [float(f) for f in torch.stack(fracs).cpu()]
    return {
        "obs_bound": [float(b) for b in obs_b.cpu()],
        "clip_frac_per_step": [round(f, 6) for f in fracs],
        "clip_frac_mean": round(float(np.mean(fracs)), 6),
        "clip_frac_max": round(float(np.max(fracs)), 6),
    }


def quantized_apply_for(
    model_name: str, env_name: str, params, config, spec,
    quantize_gru: bool = True, mlp_int8_layers: Sequence[int] = (0, 1, 2),
    fold_t: float | None = None,
):
    """Quantize a trained flagship and return its int8 apply, wired as
    ``models.make_model`` wires NL (width, terms and normalization flags from
    the config), for ``evaluate_policy(..., model_apply=quantized_apply_for(...),
    params=params)``. It runs on the device of ``params``. Raises
    ``ValueError`` for another model than NL and for ``encode_obs_time``."""
    if model_name != "nl":
        raise ValueError(f"the int8 route is NL-only, not {model_name!r}")
    if config.encode_obs_time:
        raise ValueError("the int8 route does not take encode_obs_time (the age channel is unbounded)")
    from ..config import snap_cme_terms
    from ..models.base import norm_stats_for
    from .ilt import effective_terms

    terms = config.nl_s_recon_terms
    if config.nl_ilt_algorithm == "cme":
        terms = snap_cme_terms(terms)
    terms = effective_terms(terms, config.nl_ilt_algorithm)
    norm = norm_stats_for(env_name, spec.action_high, spec.m)
    q = quantize_nl_params(params, state_dim=spec.n_obs, action_dim=spec.m, s_recon_terms=terms)
    return make_int8_nl_apply(
        q, state_dim=spec.n_obs, action_dim=spec.m, s_recon_terms=terms, norm=norm,
        ilt_algorithm=config.nl_ilt_algorithm, normalize=config.normalize,
        normalize_time=config.normalize_time, dt=config.dt, quantize_gru=quantize_gru,
        mlp_int8_layers=mlp_int8_layers, fold_t=fold_t,
    )

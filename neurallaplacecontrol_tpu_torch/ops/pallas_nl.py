"""The fused planner-path NL forward (port of ``ops/pallas_nl.py``).

The planner calls the NL model T times per tick at batch K with one shared
query horizon t. ``pack_nl_forward`` folds every normalization and the fixed
fourier contour into the weights on the host (the JAX module's host code,
unchanged), so the forward consumes RAW obs and action buffers:

    reverse GRU (2 layers, newest -> oldest over the A-long buffer)
    encoder linear -> action latent
    trunk MLP (2 tanh layers; obs normalization and contour in layer 1)
    theta/phi head + inverse stereographic map + fourier combine

``nl_forward_fused`` launches the CUDA kernel ``nl_forward_kernel``
(``csrc/nl_kernels.cu``) on CUDA tensors and computes ``nl_forward_plain``,
the same function in plain PyTorch on the same operands, on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.common import gru_gates
from . import nl_cuda
from .ilt import fourier_spherical_host
from .pallas_ilt import _host, nl_head_plain, pack_head_weights


def pack_nl_forward(
    params,
    t_model: float,
    state_dim: int,
    action_dim: int,
    terms: int,
    state_mean,
    state_std,
    action_mean,
    action_std,
    normalize: bool = True,
    encode_obs_time: bool = False,
):
    """Fold normalizations + the fixed contour into a flat tuple of float32
    numpy operands. ``t_model`` is the (already normalized + floored) query time.
    """
    gru = params["encoder"]["gru"]
    assert len(gru) == 2, "NL encoder is a 2-layer GRU (w_nl.py:21)"
    l1, l2 = gru
    w_ih1 = _host(l1["w_ih"]).copy()
    b_ih1 = _host(l1["b_ih"]).copy()

    # fold action normalization into layer-1 input weights. The age channel
    # (encode_obs_time) is un-normalized (models/nl.py _norm_actions).
    m = action_dim
    a_mean = np.zeros(m, np.float32) if not normalize else _host(action_mean)
    a_std = np.full(m, 3.0, np.float32) if not normalize else _host(action_std)
    a_mean = np.broadcast_to(a_mean, (m,))
    a_std = np.broadcast_to(a_std, (m,))
    # (a - mu)/sigma @ w == a @ (w/sigma) - mu @ (w/sigma): scale the rows,
    # then shift the bias with the SCALED weights
    w_ih1[:m, :] = w_ih1[:m, :] / a_std[:, None]
    b_ih1 = b_ih1 - a_mean @ w_ih1[:m, :]

    trunk = params["laplace_rep"]
    w1 = _host(trunk[0]["w"])
    b1 = _host(trunk[0]["b"]).copy()
    L = state_dim + 2  # laplace latent dim (w_nl.py:90)
    assert w1.shape[0] == 2 * terms + L

    # fourier contour s_k = sigma + i k pi / T at the shared query time
    theta_s, phi_s = fourier_spherical_host(float(t_model), terms)
    b1 = b1 + theta_s @ w1[:terms] + phi_s @ w1[terms : 2 * terms]

    w1_obs = w1[2 * terms : 2 * terms + state_dim].copy()
    w1_act = w1[2 * terms + state_dim :].copy()
    if normalize:
        s_mean = _host(state_mean)
        s_std = _host(state_std)
        b1 = b1 - (s_mean / s_std) @ w1_obs
        w1_obs = w1_obs / s_std[:, None]

    head = pack_head_weights(trunk[-1]["w"], trunk[-1]["b"], state_dim, terms, t_model)

    return (
        w_ih1, _host(l1["w_hh"]), b_ih1[None, :], _host(l1["b_hh"])[None, :],
        _host(l2["w_ih"]), _host(l2["w_hh"]), _host(l2["b_ih"])[None, :], _host(l2["b_hh"])[None, :],
        _host(params["encoder"]["out"]["w"]), _host(params["encoder"]["out"]["b"])[None, :],
        w1_obs, w1_act, b1[None, :],
        _host(trunk[1]["w"]), _host(trunk[1]["b"])[None, :],
    ) + head


def nl_forward_plain(obs, acts_flat, packed, state_dim: int, in_dim: int):
    """The forward kernel's function in plain PyTorch, on the same packed operands."""
    (
        w_ih1, w_hh1, b_ih1, b_hh1, w_ih2, w_hh2, b_ih2, b_hh2,
        w_enc, b_enc, w1_obs, w1_act, b1, w2, b2,
    ) = packed[:15]
    B = obs.shape[0]
    A = acts_flat.shape[1] // in_dim
    H = w_hh1.shape[0]
    h1 = obs.new_zeros((B, H))
    h2 = obs.new_zeros((B, H))
    # flipped buffer: consume newest -> oldest (w_nl.py:27)
    for step in range(A):
        src = A - 1 - step
        x_t = acts_flat[:, src * in_dim : (src + 1) * in_dim]
        h1 = gru_gates(x_t @ w_ih1 + b_ih1, h1 @ w_hh1 + b_hh1, h1)
        h2 = gru_gates(h1 @ w_ih2 + b_ih2, h2 @ w_hh2 + b_hh2, h2)
    p_act = h2 @ w_enc + b_enc
    hid = torch.tanh(obs @ w1_obs + p_act @ w1_act + b1)
    hid = torch.tanh(hid @ w2 + b2)
    return nl_head_plain(hid, packed[15:], state_dim)


def nl_forward_fused(obs, acts_flat, packed, state_dim: int, in_dim: int, *, terms: int):
    """Raw obs [B, n] + raw flattened action buffer [B, A*in] -> state
    difference [B, state_dim] through the forward kernel.

    ``terms`` is the count of live fourier terms in each padded head block
    (see ``pallas_ilt.nl_head_fused``). On CPU tensors this computes
    ``nl_forward_plain``.
    """
    if obs.device.type == "cpu":
        return nl_forward_plain(obs, acts_flat, packed, state_dim, in_dim)
    w_hh1, w2, s_re = packed[1], packed[13], packed[20]
    B, n = obs.shape
    if acts_flat.shape[0] != B or acts_flat.shape[1] % in_dim:
        raise ValueError(f"acts_flat {tuple(acts_flat.shape)} does not match obs rows {B} x in_dim {in_dim}")
    A = acts_flat.shape[1] // in_dim
    N, Dp = s_re.shape
    Tp = N // state_dim
    out = torch.empty((B, state_dim), dtype=torch.float32, device=obs.device)
    nl_cuda.launch(
        "nl_forward_launch", (obs, acts_flat, *packed, out),
        (B, n, A, in_dim, w_hh1.shape[0], w2.shape[0], state_dim, terms, Tp, N, Dp),
    )
    nl_forward_fused.launches += 1
    return out


nl_forward_fused.launches = 0  # kernel launches since the last reset

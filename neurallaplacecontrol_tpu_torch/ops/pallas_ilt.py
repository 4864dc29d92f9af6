"""The fused NL head: hidden [B, H] -> state difference [B, D] (port of ``ops/pallas_ilt.py``).

    G_theta = x @ W_theta + b_theta;   G_phi = x @ W_phi + b_phi
    theta   = tanh(G_theta) * pi;      phi   = clip(tanh(G_phi) * pi/2)
    F       = r(phi) e^{i theta}       (per-hemisphere radius, ops.sphere)
    out     = F_re @ S_re - F_im @ S_im

``pack_head_weights`` lays the final linear layer out in padded theta/phi
blocks (column d*Tp + t) and builds the selection matrices S_re/S_im that
carry the per-term fourier weights and the e^{sigma t}/T prefactor; it is
the JAX module's host code, unchanged. ``nl_head_fused`` launches the CUDA
kernel ``nl_head_kernel`` (``csrc/nl_kernels.cu``) on a CUDA tensor and
computes ``nl_head_plain``, the same function in plain PyTorch, on a CPU
tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import nl_cuda
from .ilt import _FOURIER_ALPHA, _FOURIER_EPS, _FOURIER_SCALE
from .sphere import _PHI_MARGIN

_LANE = 128
_T_PAD = 32  # terms padded to a divisor of the lane count


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _host(x) -> np.ndarray:
    """float32 numpy copy of a tensor or array, wherever it lives."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def fourier_weights(t: float, terms: int, dtype=np.float32):
    """Per-term combine weights and prefactor for a scalar query time."""
    T = _FOURIER_SCALE * t
    sigma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / T
    k = np.arange(terms)
    phase = np.pi * k * (t / T)
    half = np.where(k == 0, 0.5, 1.0)
    w_re = (half * np.cos(phase)).astype(dtype)
    w_im = (half * np.sin(phase)).astype(dtype)
    prefac = dtype(math.exp(sigma * t) / T)
    return w_re, w_im, prefac


def pack_head_weights(w, b, state_dim: int, terms: int, t: float):
    """Re-layout the final linear layer [H, 2*D*terms] (+bias) into padded
    theta/phi blocks and build the fourier selection matrices for query time
    ``t``. Returns float32 numpy (w_theta, w_phi, b_theta, b_phi, s_re, s_im).

    Original column layout (models/nl.py rep_fn reshape): col = d*terms + t
    for theta rows d < D, and (D + d)*terms + t for phi.
    """
    w = _host(w)
    b = _host(b)
    H = w.shape[0]
    D = state_dim
    Tp = _T_PAD if terms <= _T_PAD else _round_up(terms, _T_PAD)
    Dp = _LANE
    N = D * Tp

    w_theta = np.zeros((H, N), np.float32)
    w_phi = np.zeros((H, N), np.float32)
    b_theta = np.zeros((N,), np.float32)
    b_phi = np.zeros((N,), np.float32)
    for d in range(D):
        src_t = slice(d * terms, (d + 1) * terms)
        src_p = slice((D + d) * terms, (D + d + 1) * terms)
        dst = slice(d * Tp, d * Tp + terms)
        w_theta[:, dst] = w[:, src_t]
        w_phi[:, dst] = w[:, src_p]
        b_theta[dst] = b[src_t]
        b_phi[dst] = b[src_p]

    w_re, w_im, prefac = fourier_weights(float(t), terms)
    s_re = np.zeros((N, Dp), np.float32)
    s_im = np.zeros((N, Dp), np.float32)
    for d in range(D):
        s_re[d * Tp : d * Tp + terms, d] = w_re * prefac
        s_im[d * Tp : d * Tp + terms, d] = w_im * prefac
    return w_theta, w_phi, b_theta, b_phi, s_re, s_im


def to_device(packed, device) -> tuple:
    """Packed numpy operands -> contiguous float32 tensors on ``device``."""
    return tuple(torch.as_tensor(x, dtype=torch.float32, device=device).contiguous() for x in packed)


def nl_head_plain(x, packed, state_dim: int):
    """The head kernel's function in plain PyTorch, on the same packed operands."""
    w_theta, w_phi, b_theta, b_phi, s_re, s_im = packed
    g_theta = x @ w_theta + b_theta
    g_phi = x @ w_phi + b_phi
    theta = torch.tanh(g_theta) * math.pi
    half_pi = math.pi / 2.0
    phi = torch.clamp(torch.tanh(g_phi) * half_pi, -half_pi + _PHI_MARGIN, half_pi - _PHI_MARGIN)
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    north = phi >= 0.0
    r = torch.where(north, 1.0 + sin_phi, cos_phi) / torch.where(north, cos_phi, 1.0 - sin_phi)
    f_re = r * torch.cos(theta)
    f_im = r * torch.sin(theta)
    return (f_re @ s_re - f_im @ s_im)[:, :state_dim]


def nl_head_fused(x, packed, state_dim: int, *, terms: int):
    """x [B, H] -> state difference [B, state_dim] through the head kernel.

    ``terms`` is the count of live fourier terms in each padded block of
    ``packed``: the kernel skips the zero padding. On a CPU tensor this
    computes ``nl_head_plain``.
    """
    if x.device.type == "cpu":
        return nl_head_plain(x, packed, state_dim)
    w_theta, _, _, _, s_re, _ = packed
    B, Hx = x.shape
    N, Dp = s_re.shape
    Tp = N // state_dim
    out = torch.empty((B, state_dim), dtype=torch.float32, device=x.device)
    nl_cuda.launch(
        "nl_head_launch", (x, *packed, out),
        (B, Hx, state_dim, terms, Tp, N, Dp),
    )
    nl_head_fused.launches += 1
    return out


nl_head_fused.launches = 0  # kernel launches since the last reset

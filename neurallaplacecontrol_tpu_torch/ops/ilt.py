"""The fourier inverse Laplace transform (port of the fourier subset of ``ops/ilt.py``).

For query time t, with T = 2t and sigma = alpha - ln(eps)/T:

    s_k  = sigma + i*k*pi/T,                       k = 0..N-1
    f(t) = e^{sigma t}/T * [ Re F(s_0)/2
            + sum_{k>=1} Re F(s_k) cos(k pi t/T) - Im F(s_k) sin(k pi t/T) ]

The other five algorithms of the JAX module are later slices of the port:
naming one raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from .sphere import complex_to_spherical, spherical_to_complex

# contour constants (standard choices for the damped Fourier-series ILT)
_FOURIER_ALPHA = 1e-3
_FOURIER_EPS = 1e-6
_FOURIER_SCALE = 2.0
_T_FLOOR = 1e-6  # guards t -> 0; the reference would emit inf there


def _tsafe(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(t, _T_FLOOR)


def _fourier_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    t = _tsafe(t)
    T = _FOURIER_SCALE * t
    sigma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / T
    k = torch.arange(terms, dtype=t.dtype, device=t.device)
    omega = math.pi * k / T[..., None]
    return torch.complex(sigma[..., None].expand_as(omega), omega)


def fourier_spherical_host(t_model: float, terms: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-numpy fourier contour at a shared query time, in spherical coords.

    Returns (theta_s, phi_s) float32 [terms]: the values of
    ``complex_to_spherical(_fourier_nodes(t, terms))`` for a scalar ``t``,
    computed at pack time for ``ops.pallas_nl.pack_nl_forward``.
    """
    T = _FOURIER_SCALE * float(t_model)
    sigma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / T
    omega = np.pi * np.arange(terms) / T
    theta_s = np.arctan2(omega, sigma).astype(np.float32)
    mag2 = sigma * sigma + omega * omega
    phi_s = np.arcsin(np.clip((mag2 - 1.0) / (mag2 + 1.0), -1.0, 1.0)).astype(np.float32)
    return theta_s, phi_s


def _fourier_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    """F: [..., terms] complex at the fourier nodes -> f(t): [...] real."""
    t = _tsafe(t)
    T = _FOURIER_SCALE * t
    sigma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / T
    k = torch.arange(terms, dtype=t.dtype, device=t.device)
    phase = math.pi * k * (t / T)[..., None]
    w_re = torch.cos(phase)
    w_im = torch.sin(phase)
    half = torch.where(k == 0, 0.5, 1.0).to(t.dtype)
    series = torch.sum(half * (F.real * w_re - F.imag * w_im), dim=-1)
    return torch.exp(sigma * t) / T * series


def _require_fourier(algorithm: str) -> None:
    if algorithm != "fourier":
        raise NotImplementedError(
            f"ILT algorithm {algorithm!r} is not ported yet; only 'fourier' is"
        )


def effective_terms(terms: int, algorithm: str = "fourier") -> int:
    """The node count an algorithm actually uses for a requested ``terms``."""
    if algorithm == "stehfest":
        return max(2, terms - (terms % 2))
    if algorithm in ("euler", "dehoog", "cme"):
        return 2 * max(1, (terms - 1) // 2) + 1
    if algorithm in ("fourier", "fixed_talbot", "fixed_tablot"):
        return terms
    raise KeyError(algorithm)


def ilt_query_points(t: torch.Tensor, terms: int, algorithm: str = "fourier") -> torch.Tensor:
    """Complex query nodes, shape ``t.shape + (terms,)``."""
    _require_fourier(algorithm)
    return _fourier_nodes(t, terms)


def ilt_combine(F: torch.Tensor, t: torch.Tensor, terms: int, algorithm: str = "fourier") -> torch.Tensor:
    """Combine F at the query nodes into f(t); ``F`` may be ``[..., D, terms]``
    against ``t`` of shape ``[...]``."""
    _require_fourier(algorithm)
    if F.dim() == t.dim() + 2:
        return _fourier_combine(F, t[..., None].expand(F.shape[:-1]), terms)
    return _fourier_combine(F, t, terms)


def inverse_laplace(
    F_fn: Callable[[torch.Tensor], torch.Tensor],
    t: torch.Tensor,
    terms: int = 33,
    algorithm: str = "fourier",
) -> torch.Tensor:
    """Numerically invert a known Laplace transform ``F_fn`` at times ``t``."""
    s = ilt_query_points(t, terms, algorithm)
    return ilt_combine(F_fn(s), t, terms, algorithm)


def laplace_reconstruct(
    rep_fn: Callable,
    p: torch.Tensor,
    t: torch.Tensor,
    recon_dim: int,
    algorithm: str = "fourier",
    terms: int = 33,
) -> torch.Tensor:
    """Reconstruct f(t) [B, recon_dim] from a sphere-parameterized Laplace rep.

    ``rep_fn(theta_s, phi_s, p) -> (theta, phi)`` maps the query nodes on the
    sphere ``[B, terms]`` and the latent ``p [B, L]`` to output angles
    ``[B, recon_dim, terms]``; ``t`` is ``[B]`` or ``[B, 1]``.
    """
    if t.dim() == 2 and t.shape[-1] == 1:
        t = t[..., 0]
    s = ilt_query_points(t, terms, algorithm)
    theta_s, phi_s = complex_to_spherical(s)
    theta, phi = rep_fn(theta_s, phi_s, p)
    F = spherical_to_complex(theta, phi)
    return ilt_combine(F, t, terms, algorithm)

"""Differentiable inverse Laplace transform (ILT) operators (port of ``ops/ilt.py``).

Every algorithm is a pair of functions

    s      = ilt_query_points(t, terms, algorithm)   # complex query nodes
    f(t)   = ilt_combine(F_at_s, t, terms, algorithm) # linear/rational combine

batched over the leading dims of ``t`` and differentiable by autograd. The
nodes are complex128 for a float64 ``t`` and complex64 for a float32 one.

- ``fourier``      Fourier-series / expanded De Hoog contour (default).
- ``dehoog``       De Hoog-Knight-Stokes quotient-difference accelerated
                   Fourier series with Pade remainder.
- ``stehfest``     Gaver-Stehfest, real nodes.
- ``fixed_talbot`` Fixed-Talbot deformed Bromwich contour
                   (alias ``fixed_tablot`` kept for reference-CLI parity).
- ``euler``        Euler binomial-averaged Fourier series.
- ``cme``          Concentrated matrix exponential (multi-phase table in
                   ``_cme_table.py``, built on the host).

For ``fourier``, with T = 2t and sigma = alpha - ln(eps)/T:

    s_k  = sigma + i*k*pi/T,                       k = 0..N-1
    f(t) = e^{sigma t}/T * [ Re F(s_0)/2
            + sum_{k>=1} Re F(s_k) cos(k pi t/T) - Im F(s_k) sin(k pi t/T) ]

Where the JAX module takes a value through ``stop_gradient``, this one
takes it through ``detach()``.
"""

from __future__ import annotations

import functools
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


def _complex_dtype(real_dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64


def _tsafe(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(t, _T_FLOOR)


def _const(values, t: torch.Tensor, dtype=None) -> torch.Tensor:
    """A host array as a tensor beside ``t`` (its dtype unless ``dtype`` is given)."""
    return torch.as_tensor(np.asarray(values), dtype=dtype or t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# Fourier series (default)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Gaver-Stehfest (real nodes)
# ---------------------------------------------------------------------------


def _stehfest_even_terms(terms: int) -> int:
    return max(2, terms - (terms % 2))


@functools.lru_cache(maxsize=None)
def _stehfest_weights(n: int) -> np.ndarray:
    """Closed-form Gaver-Stehfest weights V_k for even n."""
    half = n // 2
    V = np.zeros(n, dtype=np.float64)
    for k in range(1, n + 1):
        total = 0.0
        for j in range((k + 1) // 2, min(k, half) + 1):
            total += (
                j**half
                * math.factorial(2 * j)
                / (
                    math.factorial(half - j)
                    * math.factorial(j)
                    * math.factorial(j - 1)
                    * math.factorial(k - j)
                    * math.factorial(2 * j - k)
                )
            )
        V[k - 1] = (-1.0) ** (k + half) * total
    return V


def _stehfest_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    n = _stehfest_even_terms(terms)
    t = _tsafe(t)
    k = torch.arange(1, n + 1, dtype=t.dtype, device=t.device)
    s = math.log(2.0) * k / t[..., None]
    return s.to(_complex_dtype(t.dtype))


def _stehfest_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    n = _stehfest_even_terms(terms)
    t = _tsafe(t)
    V = _const(_stehfest_weights(n), t)
    return math.log(2.0) / t * torch.sum(V * F[..., :n].real, dim=-1)


# ---------------------------------------------------------------------------
# Fixed Talbot
# ---------------------------------------------------------------------------


def _talbot_angles(M: int, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """theta_j = j pi / M for j = 1..M-1 and cot(theta_j), in t's dtype."""
    theta = _const(np.arange(1, M) * math.pi / M, t)
    return theta, torch.cos(theta) / torch.sin(theta)


def _talbot_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    M = terms
    t = _tsafe(t)
    r = 2.0 * M / (5.0 * t)
    theta, cot = _talbot_angles(M, t)
    cdtype = _complex_dtype(t.dtype)
    s_j = r[..., None].to(cdtype) * torch.complex(theta * cot, theta)
    s_0 = r[..., None].to(cdtype)
    return torch.cat([s_0, s_j], dim=-1)  # [..., M]


def _talbot_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    M = terms
    t = _tsafe(t)
    r = 2.0 * M / (5.0 * t)
    theta, cot = _talbot_angles(M, t)
    sig = theta + (theta * cot - 1.0) * cot  # [M-1]
    s_j = r[..., None] * torch.complex(theta * cot, theta)  # [..., M-1]
    term0 = 0.5 * torch.exp(r * t) * F[..., 0].real
    ones = torch.ones_like(sig)
    terms_j = (torch.exp(t[..., None] * s_j) * F[..., 1:] * torch.complex(ones, sig)).real
    return r / M * (term0 + torch.sum(terms_j, dim=-1))


# ---------------------------------------------------------------------------
# Euler (binomial-averaged Fourier series, Abate-Whitt 2006)
# ---------------------------------------------------------------------------


def _euler_m(terms: int) -> int:
    return max(1, (terms - 1) // 2)


@functools.lru_cache(maxsize=None)
def _euler_weights(M: int) -> np.ndarray:
    xi = np.zeros(2 * M + 1, dtype=np.float64)
    xi[0] = 0.5
    xi[1 : M + 1] = 1.0
    xi[2 * M] = 2.0**-M
    for k in range(1, M):
        xi[2 * M - k] = xi[2 * M - k + 1] + 2.0**-M * math.comb(M, k)
    k = np.arange(2 * M + 1)
    return (-1.0) ** k * xi


def _euler_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    M = _euler_m(terms)
    t = _tsafe(t)
    cdtype = _complex_dtype(t.dtype)
    k = torch.arange(2 * M + 1, dtype=t.dtype, device=t.device)
    beta = M * math.log(10.0) / 3.0 + 1j * math.pi * k.to(cdtype)
    return beta / t[..., None].to(cdtype)


def _euler_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    M = _euler_m(terms)
    t = _tsafe(t)
    eta = _const(_euler_weights(M), t)
    scale = 10.0 ** (M / 3.0) / t
    return scale * torch.sum(eta * F[..., : 2 * M + 1].real, dim=-1)


# ---------------------------------------------------------------------------
# De Hoog (quotient-difference accelerated Fourier with Pade remainder)
# ---------------------------------------------------------------------------


def _dehoog_M(terms: int) -> int:
    return max(1, (terms - 1) // 2)


def _dehoog_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    M = _dehoog_M(terms)
    t = _tsafe(t)
    T = _FOURIER_SCALE * t
    gamma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / (2.0 * T)
    k = torch.arange(2 * M + 1, dtype=t.dtype, device=t.device)
    omega = math.pi * k / T[..., None]
    return torch.complex(gamma[..., None].expand_as(omega), omega)


def _qd_limits(cdtype) -> Tuple[float, float]:
    """(tiny, big) magnitude rails for the QD recursion at this precision.

    A true transform's QD table never touches them; a raw network output
    mid-training can make the q and e ratios singular. Gradients of a railed
    division reach |num|/|den|^2 <= big/tiny^2, which stays below the dtype's
    max: (1e-8, 1e12) gives 1e28 for complex64, (1e-100, 1e100) gives 1e300
    for complex128.
    """
    if cdtype == torch.complex128:
        return 1e-100, 1e100
    return 1e-8, 1e12


def _qd_safe_div(num: torch.Tensor, den: torch.Tensor, tiny: float) -> torch.Tensor:
    """num/den with |den| floored at ``tiny`` (phase preserved).

    The predicate's magnitude is detached: |den| has a NaN derivative at
    den == 0, and the rail's location is nothing to differentiate through.
    """
    mag = torch.abs(den.detach())
    den = torch.where(mag < tiny, den + tiny, den)
    return num / den


def _qd_clamp(x: torch.Tensor, big: float) -> torch.Tensor:
    """Rescale |x| down to ``big`` where it exceeds it (phase preserved).

    The scale is a detached constant (straight-through): |x| at x == 0 has a
    NaN derivative, and big/|x| in the untaken branch would poison the
    gradient with inf * 0.
    """
    mag = torch.abs(x.detach())
    scale = torch.where(mag > big, big / torch.clamp_min(mag, 1.0), torch.ones_like(mag))
    return x * scale.to(x.dtype)


def _dehoog_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    """De Hoog-Knight-Stokes 1982 QD algorithm, unrolled for static M.

    QD ratios are floored and magnitude-clamped (``_qd_limits``), and the
    continued-fraction convergents are jointly renormalized by 1/|B_n|
    whenever they leave the representable band: A/B is invariant under that
    rescaling, so the guard is exact for well-conditioned tables and only
    alters outputs that were headed for inf/NaN.
    """
    M = _dehoog_M(terms)
    t = _tsafe(t)
    T = _FOURIER_SCALE * t
    gamma = _FOURIER_ALPHA - math.log(_FOURIER_EPS) / (2.0 * T)
    cdtype = _complex_dtype(t.dtype)
    tiny, big = _qd_limits(cdtype)

    a = [F[..., k] for k in range(2 * M + 1)]
    a[0] = a[0] * 0.5

    # QD table
    e_prev = [torch.zeros_like(a[0]) for _ in range(2 * M + 1)]
    q_prev = [_qd_clamp(_qd_safe_div(a[r + 1], a[r], tiny), big) for r in range(2 * M)]
    d = [None] * (2 * M + 1)
    d[0] = a[0]
    for r in range(1, M + 1):
        e_cur = [
            _qd_clamp(q_prev[k + 1] - q_prev[k] + e_prev[k + 1], big)
            for k in range(2 * (M - r) + 1)
        ]
        d[2 * r - 1] = -q_prev[0]
        d[2 * r] = -e_cur[0]
        if r < M:
            # ratio first, multiply after: q * (e/e) keeps every division's
            # numerator railed at big
            q_cur = [
                _qd_clamp(
                    q_prev[k + 1] * _qd_clamp(_qd_safe_div(e_cur[k + 1], e_cur[k], tiny), big),
                    big,
                )
                for k in range(2 * (M - r))
            ]
            q_prev = q_cur
        e_prev = e_cur

    z = torch.exp(1j * (math.pi * t / T).to(cdtype))
    A_nm1, B_nm1 = torch.zeros_like(a[0]), torch.ones_like(a[0])
    A_n, B_n = d[0], torch.ones_like(a[0])
    for n in range(1, 2 * M + 1):
        if n == 2 * M:
            # Pade remainder improves the last convergent
            h2m = 0.5 * (1.0 + z * (d[2 * M - 1] - d[2 * M]))
            r2m = -h2m * (1.0 - torch.sqrt(1.0 + _qd_safe_div(z * d[2 * M], h2m * h2m, tiny)))
            dz = r2m
        else:
            dz = d[n] * z
        A_n, A_nm1 = A_n + dz * A_nm1, A_n
        B_n, B_nm1 = B_n + dz * B_nm1, B_n
        # joint renormalization: A/B is invariant, so detaching the common
        # scale is exact, not straight-through
        mag = torch.maximum(torch.abs(A_n.detach()), torch.abs(B_n.detach()))
        s = torch.where(mag > big, 1.0 / torch.clamp_min(mag, tiny), torch.ones_like(mag)).to(cdtype)
        A_n, A_nm1, B_n, B_nm1 = A_n * s, A_nm1 * s, B_n * s, B_nm1 * s
    return torch.exp(gamma * t) / T * _qd_safe_div(A_n, B_n, tiny).real


# ---------------------------------------------------------------------------
# CME (concentrated matrix exponential)
# ---------------------------------------------------------------------------


def _cme_order(terms: int) -> int:
    """Number of cosine harmonics n for a 2n+1-node CME."""
    return max(1, (terms - 1) // 2)


def _cme_raw(n: int, a: float, omega: float):
    """Mean-1-normalized exponential mixture for the phased cosine kernel
    g(x) = e^{-a x} cos^{2n}((omega x - omega)/2)  (peak at x = 1):
    beta_j = a - i (j-n) omega, w_j = 4^{-n} C(2n, j) e^{-i (j-n) omega}.
    Returns (beta, w) of the density Sum_j w_j e^{-beta_j x} with unit mass
    and unit mean, or None where the normalization degenerates."""
    jj = np.arange(2 * n + 1)
    beta = a - 1j * (jj - n) * omega
    logw = np.array(
        [math.lgamma(2 * n + 1) - math.lgamma(j + 1) - math.lgamma(2 * n - j + 1) for j in jj]
    ) - 2 * n * math.log(2.0)
    w = np.exp(logw) * np.exp(-1j * (jj - n) * omega)
    mass = float(np.real(np.sum(w / beta)))
    m1 = float(np.real(np.sum(w / beta**2)))
    if mass <= 1e-12 or m1 <= 1e-12:
        return None
    m1 = m1 / mass
    return beta * m1, w * m1 / mass


def _cme_multiphase(n: int):
    """The SCV-minimal CME of Horvath, Horvath & Telek 2020 for order n from
    the calibrated table (``_cme_table.py``): the density
    c e^{-lambda x} prod_{j=1..n} cos^2(omega (x - a_j)/2), expanded in the
    e^{ik omega x} basis into a 2n+1-term mixture and normalized to unit mass
    and unit mean like ``_cme_raw``. None for orders outside the table."""
    from ._cme_table import CME_PARAMS

    if n not in CME_PARAMS:
        return None
    _scv, lam, omega, phases = CME_PARAMS[n]
    d = np.array([1.0 + 0j])
    for a in phases:
        f = np.array([0.25 * np.exp(1j * omega * a), 0.5, 0.25 * np.exp(-1j * omega * a)])
        d = np.convolve(d, f)
    k = np.arange(-n, n + 1)
    beta = lam - 1j * k * omega
    mass = float(np.real(np.sum(d / beta)))
    mean = float(np.real(np.sum(d / beta**2))) / mass
    return beta * mean, d * mean / mass


@functools.lru_cache(maxsize=None)
def _cme_nodes_weights(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """CME nodes and weights of order 2n+1, on the host.

    The multi-phase table where it has the order; otherwise the single-phase
    kernel e^{-a x} cos^{2n}((omega(x-1))/2), with (a, omega) from a coarse
    then refined grid search on two analytic pairs. Either way the
    Abate-Whitt form is f(t) ~ Re(sum_j w_j F(beta_j/t))/t.
    """
    mp = _cme_multiphase(n)
    if mp is not None:
        return mp
    ts = np.linspace(0.1, 3.0, 48)
    targets = (
        (lambda s: 1.0 / (s + 1.0), np.exp(-ts)),
        (lambda s: 1.0 / (s * s + 1.0), np.sin(ts)),
    )

    def score(a, omega):
        r = _cme_raw(n, a, omega)
        if r is None:
            return np.inf
        beta, w = r
        err = 0.0
        for F, y in targets:
            rec = np.real((w[None] * F(beta[None] / ts[:, None])).sum(1)) / ts
            err += float(np.mean((rec - y) ** 2))
        return err if np.isfinite(err) else np.inf

    # coarse grid, then one refinement around the winner
    a_grid = np.linspace(0.5, 2.5 * n, 24)
    o_grid = np.linspace(0.5, 2.0 * n, 28)
    best, best_err = (float(n), float(n)), np.inf
    for a in a_grid:
        for om in o_grid:
            e = score(a, om)
            if e < best_err:
                best, best_err = (float(a), float(om)), e
    da = max(2.5 * n / 23.0, 1e-2)
    do = max(2.0 * n / 27.0, 1e-2)
    for a in np.linspace(best[0] - da, best[0] + da, 9):
        for om in np.linspace(max(best[1] - do, 1e-2), best[1] + do, 9):
            e = score(a, om)
            if e < best_err:
                best, best_err = (float(a), float(om)), e
    return _cme_raw(n, *best)


def _cme_nodes(t: torch.Tensor, terms: int) -> torch.Tensor:
    beta, _ = _cme_nodes_weights(_cme_order(terms))
    t = _tsafe(t)
    cdtype = _complex_dtype(t.dtype)
    return _const(beta, t, cdtype) / t[..., None].to(cdtype)


def _cme_combine(F: torch.Tensor, t: torch.Tensor, terms: int) -> torch.Tensor:
    n = _cme_order(terms)
    _, w = _cme_nodes_weights(n)
    t = _tsafe(t)
    # E[f(tX)] for the mean-1 mixture density: f(t) ~ Re(sum w_j F(b_j/t))/t
    eta = _const(w, t, _complex_dtype(t.dtype))
    return torch.sum(eta * F[..., : 2 * n + 1], dim=-1).real / t


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

ILT_ALGORITHMS = {
    "fourier": (_fourier_nodes, _fourier_combine),
    "dehoog": (_dehoog_nodes, _dehoog_combine),
    "stehfest": (_stehfest_nodes, _stehfest_combine),
    "fixed_talbot": (_talbot_nodes, _talbot_combine),
    "fixed_tablot": (_talbot_nodes, _talbot_combine),  # reference spelling
    "euler": (_euler_nodes, _euler_combine),
    "cme": (_cme_nodes, _cme_combine),
}


def effective_terms(terms: int, algorithm: str = "fourier") -> int:
    """The node count an algorithm actually uses for a requested ``terms``.

    Stehfest needs an even count; euler, dehoog and cme are 2M+1 structured.
    The NL model sizes its head with this value.
    """
    if algorithm == "stehfest":
        return _stehfest_even_terms(terms)
    if algorithm == "euler":
        return 2 * _euler_m(terms) + 1
    if algorithm == "dehoog":
        return 2 * _dehoog_M(terms) + 1
    if algorithm == "cme":
        return 2 * _cme_order(terms) + 1
    return terms  # fourier / fixed_talbot use the count as requested


def ilt_query_points(t: torch.Tensor, terms: int, algorithm: str = "fourier") -> torch.Tensor:
    """Complex query nodes, shape ``t.shape + (effective_terms(terms, algorithm),)``."""
    nodes, _ = ILT_ALGORITHMS[algorithm]
    return nodes(t, terms)


def ilt_combine(F: torch.Tensor, t: torch.Tensor, terms: int, algorithm: str = "fourier") -> torch.Tensor:
    """Combine F at the query nodes into f(t); ``F`` may be ``[..., D, terms]``
    against ``t`` of shape ``[...]``."""
    _, combine = ILT_ALGORITHMS[algorithm]
    if F.dim() == t.dim() + 2:
        return combine(F, t[..., None].expand(F.shape[:-1]), terms)
    return combine(F, t, terms)


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

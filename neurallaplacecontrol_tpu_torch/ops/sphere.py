"""Riemann-sphere stereographic coordinate maps (port of ``ops/sphere.py``).

Forward map (complex plane -> sphere):
    theta = atan2(Im s, Re s)                     in (-pi, pi]
    phi   = arcsin((|s|^2 - 1) / (|s|^2 + 1))     in (-pi/2, pi/2)

Inverse map (sphere -> complex plane):
    s = cos(phi) / (1 - sin(phi)) * exp(i theta)

The inverse clips phi ``_PHI_MARGIN`` inside the pole and takes the radius
per hemisphere, so that f32 never cancels ``1 - sin(phi)`` to zero: see the
JAX module's docstring for the derivation.
"""

from __future__ import annotations

import math

import torch

_PHI_MARGIN = 1e-4


def complex_to_spherical(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex tensor -> (theta, phi) Riemann-sphere angles."""
    s_real = s.real
    s_imag = s.imag
    theta = torch.atan2(s_imag, s_real)
    mag2 = s_real * s_real + s_imag * s_imag
    ratio = torch.clamp((mag2 - 1.0) / (mag2 + 1.0), -1.0, 1.0)
    return theta, torch.asin(ratio)


def spherical_to_complex(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """(theta, phi) Riemann-sphere angles -> complex tensor.

    phi -> pi/2 is the point at infinity; phi is clipped a hair inside the
    pole, bounding |s| <= ~2e4. Each hemisphere uses the radius form that is
    free of cancellation there:

        phi >= 0:  r = (1 + sin(phi)) / cos(phi)
        phi <  0:  r = cos(phi) / (1 - sin(phi))
    """
    half_pi = math.pi / 2.0
    phi = torch.clamp(phi, -half_pi + _PHI_MARGIN, half_pi - _PHI_MARGIN)
    sin_phi = torch.sin(phi)
    cos_phi = torch.cos(phi)
    north = phi >= 0.0
    num = torch.where(north, 1.0 + sin_phi, cos_phi)
    den = torch.where(north, cos_phi, 1.0 - sin_phi)
    r = num / den
    return torch.complex(r * torch.cos(theta), r * torch.sin(theta))

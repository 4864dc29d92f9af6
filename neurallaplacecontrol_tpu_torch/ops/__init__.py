"""Numerical operators: Riemann-sphere maps, the fourier ILT and the NL kernels."""

from .ilt import (  # noqa: F401
    effective_terms,
    ilt_combine,
    ilt_query_points,
    inverse_laplace,
    laplace_reconstruct,
)
from .sphere import complex_to_spherical, spherical_to_complex  # noqa: F401

"""Port sphere maps and fourier ILT (neurallaplacecontrol_tpu_torch.ops)
against the JAX package's ops.sphere / ops.ilt."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.ops import ilt as jilt
from neurallaplacecontrol_tpu.ops import sphere as jsphere
from neurallaplacecontrol_tpu_torch.ops import ilt as tilt
from neurallaplacecontrol_tpu_torch.ops import sphere as tsphere

torch.set_num_threads(1)

TS = np.linspace(0.05, 4.0, 64)
# analytic transform pairs F(s) (of e^-t, sin t, e^-t/2 cos 2t); the same
# expression serves jax and torch arrays
PAIRS = {
    "exp_decay": lambda s: 1.0 / (s + 1.0),
    "sin": lambda s: 1.0 / (s * s + 1.0),
    "damped_cos": lambda s: (s + 0.5) / ((s + 0.5) ** 2 + 4.0),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("terms", [17, 33])
def test_inverse_laplace_matches_jax_f64(pair, terms):
    F = PAIRS[pair]
    exp = np.asarray(jilt.inverse_laplace(F, jnp.asarray(TS), terms, "fourier"))
    got = tilt.inverse_laplace(F, torch.tensor(TS), terms, "fourier").numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-13)


def test_sphere_maps_match_jax_f64():
    rng = np.random.default_rng(0)
    s = rng.standard_normal(256) * 3.0 + 1j * rng.standard_normal(256) * 3.0
    jt, jp = jsphere.complex_to_spherical(jnp.asarray(s))
    tt, tp = tsphere.complex_to_spherical(torch.tensor(s))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-12, atol=1e-14)

    theta = rng.uniform(-np.pi, np.pi, 256)
    phi = rng.uniform(-np.pi / 2, np.pi / 2, 256)
    exp = np.asarray(jsphere.spherical_to_complex(jnp.asarray(theta), jnp.asarray(phi)))
    got = tsphere.spherical_to_complex(torch.tensor(theta), torch.tensor(phi)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-13)


def test_laplace_reconstruct_matches_jax_f64():
    rng = np.random.default_rng(1)
    B, L, D, terms = 16, 4, 3, 17
    w = rng.standard_normal((2 * terms + L, 2 * D * terms)) * 0.1
    p = rng.standard_normal((B, L))
    t = rng.exponential(0.4, (B, 1))

    def make_rep(xp, cat, tanh, w_):
        def rep(theta_s, phi_s, p_):
            out = cat([theta_s, phi_s, p_]) @ w_
            out = out.reshape(out.shape[:-1] + (2 * D, terms))
            return tanh(out[..., :D, :]) * math.pi, tanh(out[..., D:, :]) * (math.pi / 2)
        return rep

    jrep = make_rep(jnp, lambda xs: jnp.concatenate(xs, -1), jnp.tanh, jnp.asarray(w))
    trep = make_rep(torch, lambda xs: torch.cat(xs, -1), torch.tanh, torch.tensor(w))
    exp = np.asarray(jilt.laplace_reconstruct(jrep, jnp.asarray(p), jnp.asarray(t), D, "fourier", terms))
    got = tilt.laplace_reconstruct(trep, torch.tensor(p), torch.tensor(t), D, "fourier", terms).numpy()
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-12)


def test_sphere_near_pole_f32_finite_value_and_gradient():
    """The f32 pole case of tests/test_ilt.py: phi = pi/2 - 2.4e-4 rounds
    sin(phi) to 1.0 in f32; the per-hemisphere radius keeps the value AND
    its gradient finite."""
    half_pi = np.float32(np.pi / 2)
    phi_np = np.asarray([half_pi - 2.4e-4, half_pi - 1.2e-4, -(half_pi - 2.4e-4), 0.0], np.float32)
    theta_np = np.asarray([0.3, 2.0, -1.0, half_pi], np.float32)
    phi = torch.tensor(phi_np, requires_grad=True)
    theta = torch.tensor(theta_np, requires_grad=True)
    s = tsphere.spherical_to_complex(theta, phi)
    assert s.dtype == torch.complex64
    assert bool(torch.isfinite(s.real).all() and torch.isfinite(s.imag).all())
    assert float(s.detach().abs().max()) <= 2.1e4
    exp = np.asarray(jsphere.spherical_to_complex(jnp.asarray(theta_np), jnp.asarray(phi_np)))
    np.testing.assert_allclose(s.detach().numpy(), exp, rtol=1e-5)
    (s.real.sum() + s.imag.sum()).backward()
    assert bool(torch.isfinite(phi.grad).all() and torch.isfinite(theta.grad).all())


def test_fourier_spherical_host_matches_jax():
    for t in (0.125, 2.5e-3, 1.7):
        for got, exp in zip(tilt.fourier_spherical_host(t, 17), jilt.fourier_spherical_host(t, 17)):
            np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("algorithm", ["fourier", "dehoog", "stehfest", "fixed_talbot", "euler", "cme"])
def test_effective_terms_matches_jax(algorithm):
    for terms in (2, 3, 16, 17, 33):
        assert tilt.effective_terms(terms, algorithm) == jilt.effective_terms(terms, algorithm)


def test_unported_algorithm_raises():
    t = torch.tensor([0.5])
    with pytest.raises(NotImplementedError):
        tilt.inverse_laplace(lambda s: 1.0 / s, t, 17, "dehoog")

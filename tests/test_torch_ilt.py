"""Port sphere maps and the six ILT algorithms (neurallaplacecontrol_tpu_torch.ops)
against the JAX package's ops.sphere / ops.ilt, and against the closed forms
at the limits of tests/test_ilt.py."""

import math

import jax
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


OTHER_ALGORITHMS = ["dehoog", "stehfest", "fixed_talbot", "fixed_tablot", "euler", "cme"]


def stehfest_scale(F, t, terms):
    """log 2 / t * sum_k |V_k Re F(s_k)|: the size of the terms Stehfest's
    alternating sum cancels (|V_k| reaches 3.6e9 at 16 terms), which sets
    the rounding that any order of summation leaves in f64."""
    n = tilt.effective_terms(terms, "stehfest")
    s = tilt.ilt_query_points(torch.tensor(t), terms, "stehfest")
    V = torch.tensor(tilt._stehfest_weights(n))
    return (math.log(2.0) / torch.tensor(t) * torch.sum(V.abs() * F(s).real.abs(), dim=-1)).numpy()


@pytest.mark.parametrize("algorithm", OTHER_ALGORITHMS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("terms", [17, 33])
def test_other_algorithms_match_jax_f64(algorithm, pair, terms):
    """rtol 1e-10, and atol 1e-10 on these O(1) values: both sides round
    sums of terms much larger than the result (e^{t s} factors, QD ratios).
    Stehfest's atol is 1e-10 of the size of the terms it sums
    (``stehfest_scale``): XLA adds them in another order than torch does."""
    F = PAIRS[pair]
    exp = np.asarray(jilt.inverse_laplace(F, jnp.asarray(TS), terms, algorithm))
    got = tilt.inverse_laplace(F, torch.tensor(TS), terms, algorithm).numpy()
    atol = 1e-10 * stehfest_scale(F, TS, terms) if algorithm == "stehfest" else 1e-10
    assert got.shape == exp.shape == TS.shape
    err = np.abs(got - exp)
    assert np.all(err <= atol + 1e-10 * np.abs(exp)), err.max()


CLOSED_FORM = {  # tests/test_ilt.py's pairs with their closed forms
    "exp": (lambda s: 1.0 / (s + 1.0), lambda t: np.exp(-t)),
    "sin": (lambda s: 1.0 / (s**2 + 1.0), np.sin),
    "ramp": (lambda s: 1.0 / s**2, lambda t: t),
    "damped_cos": (lambda s: (s + 1.0) / ((s + 1.0) ** 2 + 4.0), lambda t: np.cos(2.0 * t) * np.exp(-t)),
}


@pytest.mark.parametrize("alg,terms,tol", [
    ("dehoog", 17, 1e-8),
    ("dehoog", 33, 1e-8),
    ("fixed_talbot", 17, 1e-5),
    ("fixed_talbot", 33, 1e-5),
    ("euler", 33, 1e-8),
    ("stehfest", 16, 1e-2),
])
@pytest.mark.parametrize("pair", list(CLOSED_FORM))
def test_analytic_pairs_closed_form_f64(alg, terms, tol, pair):
    """The table of tests/test_ilt.py::test_analytic_pairs: MSE against the
    closed form on linspace(0.05, 4, 40)."""
    F, f_true = CLOSED_FORM[pair]
    t = np.linspace(0.05, 4.0, 40)
    f = tilt.inverse_laplace(F, torch.tensor(t), terms, alg).numpy()
    mse = float(np.mean((f - f_true(t)) ** 2))
    assert mse <= tol, f"{alg}({terms}) on {pair}: mse={mse}"


def test_cme_bounds_and_convergence_f64():
    """tests/test_ilt.py's CME bounds: held-out pairs at 17 and 41 terms,
    <=1e-5 from 33 terms, dehoog < 1e-10 at 17 on the same pairs, and the
    monotone convergence on 0.5 e^{-0.2t} sin 2t."""
    t = np.linspace(0.1, 3.0, 200)
    tt = torch.tensor(t)
    pairs = [
        (lambda s: 1 / (s + 1) ** 2, t * np.exp(-t), 3e-6, 1e-7),
        (lambda s: s / (s * s + 1), np.cos(t), 4e-4, 1e-5),
        (lambda s: 1 / torch.sqrt(s), 1 / np.sqrt(np.pi * t), 3e-5, 5e-7),
    ]
    for F, true, bound17, bound41 in pairs:
        mse = {n: float(np.mean((tilt.inverse_laplace(F, tt, n, "cme").numpy() - true) ** 2))
               for n in (17, 33, 41)}
        assert mse[17] < bound17 and mse[33] < 1e-5 and mse[41] < bound41, mse
        ed = float(np.mean((tilt.inverse_laplace(F, tt, 17, "dehoog").numpy() - true) ** 2))
        assert ed < 1e-10, ed

    t = np.linspace(0.05, 4.0, 100)
    true = 0.5 * np.exp(-0.2 * t) * np.sin(2 * t)
    errs = [float(np.mean((tilt.inverse_laplace(lambda s: 1.0 / ((s + 0.2) ** 2 + 4.0), torch.tensor(t),
                                                 n, "cme").numpy() - true) ** 2)) for n in (9, 17, 33, 101)]
    assert errs == sorted(errs, reverse=True), errs
    assert errs[1] < 7e-4 and errs[-1] < 5e-6, errs


@pytest.mark.parametrize("algorithm", ["fourier"] + OTHER_ALGORITHMS)
def test_reconstruct_gradients_match_jax_f64(algorithm):
    """d/dw and d/dp of a real loss through laplace_reconstruct (complex128
    autograd) against jax.grad: rtol 1e-9, atol 1e-9 of the largest
    gradient (stehfest: 1e-5 of it, the rounding of its cancelling sum)."""
    rng = np.random.default_rng(2)
    B, L, D, terms = 8, 4, 3, 17
    n = tilt.effective_terms(terms, algorithm)
    w = rng.standard_normal((2 * n + L, 2 * D * n)) * 0.1
    p = rng.standard_normal((B, L))
    t = rng.uniform(0.05, 2.0, (B, 1))
    c = rng.standard_normal((B, D))

    def make_rep(cat, tanh):
        def rep(w_, theta_s, phi_s, p_):
            out = cat([theta_s, phi_s, p_]) @ w_
            out = out.reshape(out.shape[:-1] + (2 * D, n))
            return tanh(out[..., :D, :]) * math.pi, tanh(out[..., D:, :]) * (math.pi / 2)
        return rep

    jrep = make_rep(lambda xs: jnp.concatenate(xs, -1), jnp.tanh)
    trep = make_rep(lambda xs: torch.cat(xs, -1), torch.tanh)

    def jloss(w_, p_):
        out = jilt.laplace_reconstruct(lambda a, b, q: jrep(w_, a, b, q), p_, jnp.asarray(t), D, algorithm, terms)
        return jnp.sum(out * c)

    jw, jp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(p))
    tw = torch.tensor(w, requires_grad=True)
    tp = torch.tensor(p, requires_grad=True)
    out = tilt.laplace_reconstruct(lambda a, b, q: trep(tw, a, b, q), tp, torch.tensor(t), D, algorithm, terms)
    torch.sum(out * torch.tensor(c)).backward()
    rel = 1e-5 if algorithm == "stehfest" else 1e-9
    for got, exp in ((tw.grad.numpy(), np.asarray(jw)), (tp.grad.numpy(), np.asarray(jp))):
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, exp, rtol=rel, atol=rel * np.abs(exp).max())


def test_dehoog_degenerate_inputs_finite():
    """tests/test_ilt.py's degenerate QD inputs in f32 (an exact zero, a
    denormal-range row, a wild magnitude alternation): the railed
    recursion's values and gradients stay finite in the port too."""
    terms = 17
    n = tilt.effective_terms(terms, "dehoog")
    rng = np.random.default_rng(3)
    F = (rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))).astype(np.complex64)
    F[0, 3] = 0.0
    F[1] = 1e-30
    F[2, ::2] = 1e6
    t = torch.tensor(rng.uniform(0.05, 2.0, (8,)), dtype=torch.float32)
    Fr = torch.tensor(F.real, requires_grad=True)
    Fi = torch.tensor(F.imag, requires_grad=True)
    out = tilt.ilt_combine(torch.complex(Fr, Fi), t, terms, "dehoog")
    assert bool(torch.isfinite(out).all())
    torch.sum(out**2).backward()
    assert bool(torch.isfinite(Fr.grad).all()) and bool(torch.isfinite(Fi.grad).all())
    exp = np.asarray(jilt.ilt_combine(jnp.asarray(F), jnp.asarray(t.numpy()), terms, "dehoog"))
    assert np.all(np.isfinite(exp))


@pytest.mark.parametrize("algorithm", ["fourier"] + OTHER_ALGORITHMS)
def test_query_points_count_matches_jax(algorithm):
    t = np.asarray([0.3, 1.0])
    for req in (16, 17):
        exp = np.asarray(jilt.ilt_query_points(jnp.asarray(t), req, algorithm))
        got = tilt.ilt_query_points(torch.tensor(t), req, algorithm).numpy()
        assert got.shape == exp.shape == (2, tilt.effective_terms(req, algorithm))
        np.testing.assert_allclose(got, exp, rtol=1e-12)

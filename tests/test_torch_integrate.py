"""The port's integrators (neurallaplacecontrol_tpu_torch.ops.integrate)
against the JAX package's ops/integrate.py at f64.

The JAX latent ODE maps dopri5 over rows with jax.vmap; the port solves the
rows as one batch whose step-size control is per row. The adaptive cases
hold every row to JAX's vmapped solve at 1e-10 and its accepted-step counts
exactly, on horizons from 1e-4 to 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.ops import integrate as jint
from neurallaplacecontrol_tpu_torch.ops import integrate as tint

torch.set_num_threads(1)

TOL = 1e-10
D, HIDDEN = 6, 32


def mlp(seed=0):
    rng = np.random.default_rng(seed)
    w1 = rng.standard_normal((D, HIDDEN)) / np.sqrt(D)
    b1 = rng.standard_normal(HIDDEN) * 0.1
    w2 = rng.standard_normal((HIDDEN, D)) * 2.0 / np.sqrt(HIDDEN)
    return w1, b1, w2


def rhs_pair(seed=0):
    w1, b1, w2 = mlp(seed)
    jw = [jnp.asarray(x) for x in (w1, b1, w2)]
    tw = [torch.tensor(x) for x in (w1, b1, w2)]

    def jrhs(y, t):
        return jnp.tanh(y @ jw[0] + jw[1]) @ jw[2] - 0.3 * y

    def trhs(y, t):
        return torch.tanh(y @ tw[0] + tw[1]) @ tw[2] - 0.3 * y

    return jrhs, trhs


def horizons(B, seed=1):
    """Horizons spanning 1e-4 to 10, log-uniform."""
    return 10.0 ** np.random.default_rng(seed).uniform(-4.0, 1.0, B)


@pytest.mark.parametrize("max_steps", [8, 24, 64])
def test_dopri5_per_row_matches_vmapped_jax(max_steps):
    jrhs, trhs = rhs_pair()
    B = 40
    rng = np.random.default_rng(2)
    y0 = rng.standard_normal((B, D)) * 2.0
    t1 = horizons(B)

    def one(y, t):
        return jint.odeint_dopri5_with_stats(jrhs, y[None], jnp.stack([jnp.zeros_like(t), t]),
                                             max_steps=max_steps)

    jys, jn = jax.jit(jax.vmap(one))(jnp.asarray(y0), jnp.asarray(t1))
    ts = torch.stack([torch.zeros(B, dtype=torch.float64), torch.tensor(t1)], dim=1)
    tys, tn = tint.odeint_dopri5_with_stats(trhs, torch.tensor(y0), ts, max_steps=max_steps)
    exp = np.asarray(jys)[:, :, 0]  # [B, T, 1, D] -> [B, T, D]
    got = tys.numpy().transpose(1, 0, 2)
    assert got.shape == exp.shape == (B, 2, D)
    np.testing.assert_allclose(got, exp, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tn.numpy()[0], np.asarray(jn)[:, 0])
    # the horizons need from 1 to max_steps steps: the per-row control matters
    assert tn.min() >= 1 and len(np.unique(tn.numpy())) > 3


def test_dopri5_row_norm_is_not_batch_norm():
    """One row that needs small steps must not slow the others: a solve of
    all rows together equals each row solved alone."""
    jrhs, trhs = rhs_pair(3)
    rng = np.random.default_rng(4)
    y0 = torch.tensor(rng.standard_normal((5, D)))
    y0[0] *= 30.0  # a stiff-looking row
    ts = torch.tensor([0.0, 2.0], dtype=torch.float64)
    ys, n = tint.odeint_dopri5_with_stats(trhs, y0, ts, max_steps=32)
    for i in range(5):
        yi, ni = tint.odeint_dopri5_with_stats(trhs, y0[i : i + 1], ts, max_steps=32)
        assert torch.equal(ys[:, i], yi[:, 0]) and int(n[0, i]) == int(ni[0, 0])


def test_dopri5_multi_interval_grid_matches_jax():
    """A shared grid of several intervals, y0 of a single trajectory, as the
    JAX function takes it: the port's rows of one [1, ...] batch."""
    jrhs, trhs = rhs_pair(5)
    y0 = np.random.default_rng(6).standard_normal((3, D))
    ts = np.array([0.0, 0.01, 0.3, 1.0, 4.0])
    jys, jn = jint.odeint_dopri5_with_stats(jrhs, jnp.asarray(y0), jnp.asarray(ts), max_steps=40)
    tys, tn = tint.odeint_dopri5_with_stats(trhs, torch.tensor(y0)[None], torch.tensor(ts), max_steps=40)
    np.testing.assert_allclose(tys[:, 0].numpy(), np.asarray(jys), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tn[:, 0].numpy(), np.asarray(jn))
    np.testing.assert_allclose(tint.odeint_dopri5(trhs, torch.tensor(y0)[None], torch.tensor(ts),
                                                  max_steps=40)[:, 0].numpy(),
                               np.asarray(jint.odeint_dopri5(jrhs, jnp.asarray(y0), jnp.asarray(ts),
                                                             max_steps=40)), rtol=TOL, atol=TOL)


def test_dopri5_gradient_matches_jax():
    """Gradients through the masked loop, the control frozen as in JAX."""
    w1, b1, w2 = mlp(7)
    B = 12
    y0 = np.random.default_rng(8).standard_normal((B, D))
    t1 = horizons(B, 9)

    def jloss(w2_, y):
        def rhs(z, t):
            return jnp.tanh(z @ w1 + b1) @ w2_

        def one(yi, ti):
            return jint.odeint_dopri5(rhs, yi[None], jnp.stack([0.0, ti]), max_steps=24)[-1, 0]

        return jnp.sum(jnp.sin(jax.vmap(one)(y, jnp.asarray(t1))))

    jg_w, jg_y = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w2), jnp.asarray(y0))
    tw2 = torch.tensor(w2, requires_grad=True)
    ty0 = torch.tensor(y0, requires_grad=True)
    ts = torch.stack([torch.zeros(B, dtype=torch.float64), torch.tensor(t1)], dim=1)
    out = tint.odeint_dopri5(lambda z, t: torch.tanh(z @ torch.tensor(w1) + torch.tensor(b1)) @ tw2, ty0, ts,
                             max_steps=24)
    torch.sum(torch.sin(out[-1])).backward()
    assert torch.isfinite(tw2.grad).all() and torch.isfinite(ty0.grad).all()
    np.testing.assert_allclose(tw2.grad.numpy(), np.asarray(jg_w), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(ty0.grad.numpy(), np.asarray(jg_y), rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("method,num_steps", [("euler", 1), ("euler", 5), ("rk4", 3)])
def test_fixed_step_matches_jax(method, num_steps):
    jrhs, trhs = rhs_pair(10)
    y0 = np.random.default_rng(11).standard_normal((7, D))
    exp = jint.odeint_fixed(lambda y: jrhs(y, 0.0), jnp.asarray(y0), 0.0, 0.7, method=method,
                            num_steps=num_steps)
    got = tint.odeint_fixed(lambda y: trhs(y, 0.0), torch.tensor(y0), 0.0, 0.7, method=method,
                            num_steps=num_steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-12, atol=1e-12)

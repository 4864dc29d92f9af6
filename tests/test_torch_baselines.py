"""The port's baseline families (rnn, delta_t_rnn, node, latent_ode) against
the JAX package's models at f64: forward and gradient at a random init and
on the tracked pendulum-d1 checkpoints, the config variants, the latent
ODE's entry points on JAX's draws of z0's noise, and its carried planner
dynamics. Tolerances are stated in each test."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.latent_ode import make_carried_dynamics as jax_carried
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves
from neurallaplacecontrol_tpu_torch.models.latent_ode import make_carried_dynamics, make_latent_ode_model, tile_rows
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.utils.checkpoint import (
    from_jax_params,
    load_pytree,
    model_checkpoint_name,
    resolve_checkpoint,
)
from jax_replay_draws import fixed_z0_draw, z0_draws

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("rnn", "delta_t_rnn", "node", "latent_ode")
ENV, N, M, HIGH = "oderl-pendulum", 3, 1, 2.0
LATENTS = N + 2
F64_TOL = 1e-9  # relative, |got - exp| / (1 + |exp|)


def rel(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (1.0 + np.abs(exp))).max())


def inputs(B=48, seed=0, in_extra=0):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, N))
    abuf = rng.uniform(-HIGH, HIGH, (B, 4, M + in_extra))
    if in_extra:
        abuf[..., -1] = np.abs(abuf[..., -1]) * 0.05
    ts = rng.exponential(0.05, (B, 1))  # the exp grid
    return obs, abuf, ts


def checkpoint(family):
    return load_pytree(resolve_checkpoint(model_checkpoint_name(family, ENV, 1, "exp", 0, True)), device="cpu")


def both(family, dtype="f64", B=48, cfg_kw=None, jax_params=None):
    """(JAX model, its params, port model, the same params as torch) at the
    dtype; the params are the tracked checkpoint or, with ``jax_params="init"``,
    JAX's init from PRNGKey(0). The latent ODE's fixed z0 draw is JAX's."""
    cfg_kw = cfg_kw or {}
    jd, td = (jnp.float64, torch.float64) if dtype == "f64" else (jnp.float32, torch.float32)
    jmodel = jax_make_model(family, ENV, N, M, HIGH, JConfig(**cfg_kw), dtype=jd)
    if family == "latent_ode":
        norm = norm_stats_for(ENV, HIGH, M)
        tmodel = make_latent_ode_model(N, M, norm, dtype=td, device="cpu",
                                       z0_noise=torch.tensor(fixed_z0_draw(B, LATENTS, np.float64 if dtype == "f64"
                                                                           else np.float32)))
    else:
        tmodel = torch_make_model(family, ENV, N, M, HIGH, TConfig(**cfg_kw), dtype=td, device="cpu")
    if jax_params == "init":
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jparams = jax.tree_util.tree_map(lambda x: np.asarray(x), jparams)
    else:
        jparams = jax.tree_util.tree_map(lambda x: x.numpy(), checkpoint(family))
    jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jd), jparams)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu", dtype=td)
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("weights", ["init", "checkpoint"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax_f64(family, weights):
    """Each family's apply at f64 on 48 rows of exp-grid horizons, at JAX's
    init and on the tracked pendulum-d1 checkpoint: within 1e-9."""
    jmodel, jparams, tmodel, tparams = both(family, jax_params="init" if weights == "init" else None)
    obs, abuf, ts = inputs()
    exp = np.asarray(jax.jit(jmodel.apply)(jparams, *(jnp.asarray(x) for x in (obs, abuf, ts))))
    got = tmodel.apply(tparams, *(torch.tensor(x) for x in (obs, abuf, ts)))
    assert got.shape == (48, N) and got.dtype == torch.float64
    assert rel(got, exp) < F64_TOL


@pytest.mark.parametrize("family", FAMILIES)
def test_gradient_matches_jax_f64(family):
    """d sum(sin(apply)) / d params on the checkpoint: within 1e-8 of JAX's,
    relative to each leaf's largest entry."""
    jmodel, jparams, tmodel, tparams = both(family, B=16)
    obs, abuf, ts = inputs(16, seed=1)
    jargs = [jnp.asarray(x) for x in (obs, abuf, ts)]
    jg = jax.grad(lambda p: jnp.sum(jnp.sin(jmodel.apply(p, *jargs))))(jparams)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tparams)]
    from neurallaplacecontrol_tpu_torch.models.common import tree_unflatten

    out = tmodel.apply(tree_unflatten(tparams, leaves), *(torch.tensor(x) for x in (obs, abuf, ts)))
    grads = torch.autograd.grad(torch.sum(torch.sin(out)), leaves)
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    assert len(jleaves) == len(grads)
    for g, e in zip(grads, jleaves):
        assert g.shape == e.shape
        assert float(np.abs(g.numpy() - e).max()) <= 1e-8 * (1.0 + float(np.abs(e).max()))


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax_f32(family):
    """At f32 on the checkpoint (JAX's f32 z0 draw for the latent ODE): within
    1e-4; a row whose dopri5 accept decision flips under f32 rounding would
    show as more."""
    jmodel, jparams, tmodel, tparams = both(family, dtype="f32", B=200)
    obs, abuf, ts = inputs(200, seed=2)
    exp = np.asarray(jax.jit(jmodel.apply)(jparams, *(jnp.asarray(x, jnp.float32) for x in (obs, abuf, ts))))
    got = tmodel.apply(tparams, *(torch.tensor(x, dtype=torch.float32) for x in (obs, abuf, ts)))
    assert got.dtype == torch.float32 and rel(got, exp) < 1e-4


@pytest.mark.parametrize("cfg_kw", [{"normalize": False}, {"normalize_time": False}, {"encode_obs_time": True}],
                         ids=["no_normalize", "no_normalize_time", "encode_obs_time"])
@pytest.mark.parametrize("family", ("rnn", "delta_t_rnn", "node"))
def test_config_variants_match_jax_f64(family, cfg_kw):
    """normalize=False (actions / 3), normalize_time=False and the age
    channel (into the GRU raw; sliced off for node) at JAX's init: 1e-9."""
    jmodel, jparams, tmodel, tparams = both(family, cfg_kw=cfg_kw, jax_params="init")
    obs, abuf, ts = inputs(in_extra=int(cfg_kw.get("encode_obs_time", False)), seed=3)
    exp = np.asarray(jmodel.apply(jparams, *(jnp.asarray(x) for x in (obs, abuf, ts))))
    got = tmodel.apply(tparams, *(torch.tensor(x) for x in (obs, abuf, ts)))
    assert rel(got, exp) < F64_TOL


def test_node_takes_sixteen_substeps_of_clipped_length():
    """NODE's horizon beyond 16 x 0.05 (normalized) is cut off, and at a
    horizon of zero it returns its normalized input state, as in JAX."""
    jmodel, jparams, tmodel, tparams = both("node", jax_params="init")
    obs, abuf, _ = inputs(1, seed=4)
    obs, abuf = np.repeat(obs, 4, axis=0), np.repeat(abuf, 4, axis=0)
    ts = np.array([[0.0], [0.05 * 8 * 0.8], [0.05 * 8 * 0.9], [5.0]])
    exp = np.asarray(jmodel.apply(jparams, *(jnp.asarray(x) for x in (obs, abuf, ts))))
    got = tmodel.apply(tparams, *(torch.tensor(x) for x in (obs, abuf, ts))).numpy()
    assert rel(got, exp) < F64_TOL
    np.testing.assert_array_equal(got[0], obs[0] / norm_stats_for(ENV, HIGH, M).state_std)
    np.testing.assert_allclose(got[1], got[2], rtol=1e-12)
    np.testing.assert_allclose(got[1], got[3], rtol=1e-12)


@pytest.mark.parametrize("family", FAMILIES)
def test_init_tree_and_checkpoint_load(family):
    """The port's init has the JAX tree's keys and shapes, so the tracked
    checkpoint loads into it with ``like`` at the init's dtype."""
    jmodel = jax_make_model(family, ENV, N, M, HIGH, JConfig(), dtype=jnp.float32)
    tmodel = torch_make_model(family, ENV, N, M, HIGH, TConfig(), device="cpu")
    tparams = tmodel.init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves(jmodel.init(jax.random.PRNGKey(0)))
    assert [tuple(x.shape) for x in tree_leaves(tparams)] == [tuple(x.shape) for x in jleaves]
    path = resolve_checkpoint(model_checkpoint_name(family, ENV, 1, "exp", 0, True))
    loaded = load_pytree(path, like=tparams)
    assert all(a.dtype == torch.float32 for a in tree_leaves(loaded))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), tree_leaves(checkpoint(family))))


def test_latent_ode_entry_points_match_jax_f64():
    """encode_history, predict_diff on JAX's draws from a key (3 samples) at
    each row's own horizon, train_step's IWAE loss and its gradient, and
    decoder_nfes: 1e-9, the nfes equal."""
    jmodel, jparams, tmodel, tparams = both("latent_ode", B=32)
    rng = np.random.default_rng(5)
    hist_s = rng.standard_normal((32, 4, N))
    hist_a = rng.uniform(-HIGH, HIGH, (32, 4, M))
    ts = rng.exponential(0.05, (32, 1))
    target = rng.standard_normal((32, N)) * 0.1
    key = jax.random.PRNGKey(11)
    eps = torch.tensor(z0_draws(key, 32, LATENTS, n_samples=3))
    j = [jnp.asarray(x) for x in (hist_s, hist_a, ts, target)]
    t = [torch.tensor(x) for x in (hist_s, hist_a, ts, target)]

    jm, js = jmodel.encode_history(jparams, j[0], j[1])
    tm, tsd = tmodel.encode_history(tparams, t[0], t[1])
    assert rel(tm, jm) < F64_TOL and rel(tsd, js) < F64_TOL
    assert float(tsd.min()) >= 1e-6  # |y_std| + 1e-6

    jout, _ = jmodel.predict_diff(jparams, key, j[0], j[1], j[2], n_samples=3)
    tout, _ = tmodel.predict_diff(tparams, eps, t[0], t[1], t[2])
    assert tout.shape == (3, 32, N + M) and rel(tout, jout) < F64_TOL

    jloss, jg = jax.value_and_grad(lambda p: jmodel.train_step(p, key, *j))(jparams)
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(tparams)]
    from neurallaplacecontrol_tpu_torch.models.common import tree_unflatten

    tloss = tmodel.train_step(tree_unflatten(tparams, leaves), eps, *t)
    grads = torch.autograd.grad(tloss, leaves)
    assert abs(float(tloss.detach()) / float(jloss) - 1.0) < 1e-10
    for g, e in zip(grads, jax.tree_util.tree_leaves(jg)):
        e = np.asarray(e)
        assert float(np.abs(g.numpy() - e).max()) <= 1e-8 * (1.0 + float(np.abs(e).max()))

    obs, abuf, _ = inputs(32, seed=6)
    for horizon in (0.05, 0.3, 2.0):
        tsq = np.full((32, 1), horizon)
        exp = np.asarray(jmodel.decoder_nfes(jparams, jnp.asarray(obs), jnp.asarray(abuf), jnp.asarray(tsq)))
        got = tmodel.decoder_nfes(tparams, torch.tensor(obs), torch.tensor(abuf), torch.tensor(tsq)).numpy()
        np.testing.assert_array_equal(got, exp)


def test_latent_ode_carried_dynamics_matches_jax_f64():
    """The carried planner dynamics over 6 steps from a tiled start state:
    the history carry and the next states within 1e-9 of JAX's."""
    B = 40
    jmodel, jparams, tmodel, tparams = both("latent_ode", B=B)
    j_init, j_dyn = jax_carried(jmodel, jparams, 0.05, N, M)
    t_init, t_dyn = make_carried_dynamics(tmodel, tparams, 0.05, N, M)
    rng = np.random.default_rng(7)
    state0 = rng.standard_normal((B, N))
    jc, js = j_init(jnp.asarray(state0)), jnp.asarray(state0)
    tc, tst = t_init(torch.tensor(state0)), torch.tensor(state0)
    for step in range(6):
        window = rng.uniform(-HIGH, HIGH, (B, 4, M))
        jc, js = jax.jit(j_dyn)(jc, js, jnp.asarray(window))
        tc, tst = t_dyn(tc, tst, torch.tensor(window))
        assert rel(tc, jc) < F64_TOL and rel(tst, js) < F64_TOL, step


def test_latent_ode_fixed_draw_tiles_over_seeds():
    """The fixed z0 draw is K rows; a call with S x K rows gives each seed's
    K rows the same draw, as JAX's vmap over seeds does, and a latent ODE
    from make_model draws it from a seeded generator, K = mppi_roll_outs."""
    draw = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    tiled = tile_rows(draw, 12)
    assert torch.equal(tiled, torch.cat([draw] * 3))
    assert torch.equal(tile_rows(draw, 6), torch.cat([draw, draw[:2]]))
    model = torch_make_model("latent_ode", ENV, N, M, HIGH, TConfig(mppi_roll_outs=7), device="cpu")
    again = torch_make_model("latent_ode", ENV, N, M, HIGH, TConfig(mppi_roll_outs=7), device="cpu")
    assert model.z0_noise.shape == (7, LATENTS) and torch.equal(model.z0_noise, again.z0_noise)
    params = model.init(torch.Generator().manual_seed(1))
    obs, abuf, _ = inputs(14, seed=8, in_extra=0)
    obs[7:] = obs[:7]
    abuf[7:] = abuf[:7]
    out = model.apply(params, torch.tensor(obs, dtype=torch.float32), torch.tensor(abuf, dtype=torch.float32),
                      torch.full((14, 1), 0.05))
    # equal to rounding: a row's products may round differently at another place in the batch
    torch.testing.assert_close(out[:7], out[7:], rtol=1e-5, atol=1e-6)


def test_latent_ode_ref_not_ported():
    """``make_model("latent_ode_ref")`` (refused before the reference-layout
    twin was ported) builds JAX's tree (keys, shapes) and, on JAX's init,
    JAX's forward at f64 within F64_TOL."""
    jmodel = jax_make_model("latent_ode_ref", ENV, N, M, HIGH, JConfig(), dtype=jnp.float64)
    tmodel = torch_make_model("latent_ode_ref", ENV, N, M, HIGH, TConfig(), dtype=torch.float64, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    own = tmodel.init(torch.Generator().manual_seed(0))
    assert [tuple(x.shape) for x in tree_leaves(own)] == [x.shape for x in jax.tree_util.tree_leaves(jparams)]
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    obs, abuf, ts = inputs(16, seed=4)
    exp = np.asarray(jmodel.apply(jparams, *(jnp.asarray(x) for x in (obs, abuf, ts))))
    assert rel(tmodel.apply(tparams, *(torch.tensor(x) for x in (obs, abuf, ts))), exp) < F64_TOL

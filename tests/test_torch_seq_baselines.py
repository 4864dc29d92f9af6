"""The port's sequence baselines (models.seq_baselines) and toy data
(data.toy) against the JAX package's at f64 on the CPU: the toy grids
within two ulps (XLA's CPU linspace rounds a third of its points up to two
ulps away from every evaluation order of jnp.linspace's formula tried, and
from torch.linspace),
the sampled subsets on JAX's index draws exactly, each model's encode and
reconstruct on JAX's init, and a few Adam updates on the sine toy."""

import jax
import numpy as np
import optax
import pytest
import torch

from neurallaplacecontrol_tpu.data import toy as jtoy
from neurallaplacecontrol_tpu.models import seq_baselines as jseq
from neurallaplacecontrol_tpu_torch.data import toy as ttoy
from neurallaplacecontrol_tpu_torch.models import seq_baselines as tseq
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.training.train import make_adam

torch.set_num_threads(1)

F64 = torch.float64


@pytest.mark.parametrize("name", sorted(jtoy.TOY_DATASETS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_toy_data_equals_jax(name, dtype):
    """The toy grids within two ulps of JAX's, and the trajectories within
four of their scale (a sine moves by at most |cos| <= 1 times its
argument's error), at f64 and at f32; the ramp exactly zero before t = 5."""
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        traj_j, t_j = jtoy.TOY_DATASETS[name](3, t_nsamples=57)
        traj_j, t_j = np.asarray(traj_j), np.asarray(t_j)
    finally:
        jax.config.update("jax_enable_x64", True)
    traj_t, t_t = ttoy.TOY_DATASETS[name](3, t_nsamples=57, dtype=torch.from_numpy(np.zeros(1, dtype)).dtype,
                                          device="cpu")
    assert traj_t.shape == traj_j.shape and t_j.dtype == dtype
    np.testing.assert_array_max_ulp(t_t.numpy(), t_j, maxulp=2)
    scale = np.maximum(np.abs(traj_j), np.abs(t_j)[None, :, None] * (1 if name == "sine" else 0.1))
    assert np.all(np.abs(traj_t.numpy() - traj_j) <= 4 * np.spacing(scale.astype(dtype)))
    assert np.all(traj_t.numpy()[:, t_j < 4.9] == 0.0) or name == "sine"


def test_subsample_irregular_on_jax_draws():
    traj_j, t_j = jtoy.sine(2, t_nsamples=40)
    key = jax.random.PRNGKey(4)
    sub_j, ts_j = jtoy.subsample_irregular(key, traj_j, t_j, 12)
    idx = np.asarray(jax.random.choice(key, 40, (12,), replace=False))
    traj_t, t_t = torch.tensor(np.asarray(traj_j)), torch.tensor(np.asarray(t_j))
    sub_t, ts_t = ttoy.subsample_irregular(None, traj_t, t_t, 12, idx=torch.tensor(idx))
    np.testing.assert_array_equal(sub_t.numpy(), np.asarray(sub_j))
    np.testing.assert_array_equal(ts_t.numpy(), np.asarray(ts_j))
    own, ts_own = ttoy.subsample_irregular(torch.Generator().manual_seed(0), traj_t, t_t, 12)
    assert own.shape == (2, 12, 1) and bool((torch.diff(ts_own) > 0).all())


MODELS = {  # name: (maker, its arguments beyond the input width)
    "ode_rnn": ("make_ode_rnn", dict(latent_dim=6, n_gru_units=6, n_units=12, rhs_units=12, substeps=3)),
    "gru": ("make_classic_rnn", dict(latent_dim=8, cell="gru", n_units=12)),
    "expdecay": ("make_classic_rnn", dict(latent_dim=8, cell="expdecay", n_units=12)),
}


def pair(name):
    """(JAX model, port model, JAX init, the same init in the port) at f64."""
    maker, kw = MODELS[name]
    jm, tm = getattr(jseq, maker)(1, **kw), getattr(tseq, maker)(1, device="cpu", **kw)
    jp = jm.init(jax.random.PRNGKey(9))
    return jm, tm, jp, tseq.sequence_params_from_jax(tm, jp)


def irregular_sine():
    traj, t = jtoy.sine(3, t_nsamples=50)
    sub, ts = jtoy.subsample_irregular(jax.random.PRNGKey(1), traj, t, 15)
    return np.asarray(sub) * np.array([1.0, 0.5, -0.7])[:, None, None], np.asarray(ts)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_encode_and_reconstruct_match_jax(name):
    """encode and reconstruct on JAX's init and an irregular sine, < 1e-12."""
    jm, tm, jp, tp = pair(name)
    x, ts = irregular_sine()
    assert tm.name == jm.name
    for fn in ("encode", "reconstruct"):
        got = getattr(tm, fn)(tp, torch.tensor(x), torch.tensor(ts))
        exp = np.asarray(getattr(jm, fn)(jp, x, ts))
        assert got.shape == exp.shape
        assert float(np.max(np.abs(got.numpy() - exp))) < 1e-12, fn
    own = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(v.shape) for v in tree_leaves(own)] == [tuple(v.shape) for v in tree_leaves(tp)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_sine_fit_updates_match_jax(name):
    """Five Adam updates of the reconstruction MSE, the JAX package's
    optax.adam against the port's make_adam, < 1e-12 relative per loss."""
    jm, tm, jp, tp = pair(name)
    x, ts = irregular_sine()
    opt = optax.adam(1e-2)
    state = opt.init(jp)
    jlosses = []
    grad = jax.value_and_grad(lambda p: ((jm.reconstruct(p, x, ts) - x) ** 2).mean())
    for _ in range(5):
        loss, g = grad(jp)
        u, state = opt.update(g, state)
        jp = optax.apply_updates(jp, u)
        jlosses.append(float(loss))
    topt = make_adam(1e-2)
    tstate = topt.init(tp)
    xt, tst = torch.tensor(x), torch.tensor(ts)
    for i in range(5):
        leaves = [v.detach().requires_grad_(True) for v in tree_leaves(tp)]
        loss = ((tm.reconstruct(tree_unflatten(tp, leaves), xt, tst) - xt) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
        u, tstate = topt.update(tree_unflatten(tp, list(grads)), tstate)
        tp = tree_unflatten(tp, [(a + b).detach() for a, b in zip(tree_leaves(tp), tree_leaves(u))])
        loss = float(loss.detach())
        assert abs(loss - jlosses[i]) / jlosses[i] < 1e-12, (i, loss, jlosses[i])


def test_classic_rnn_refuses_unknown_cell():
    with pytest.raises(ValueError, match="cell"):
        tseq.make_classic_rnn(1, cell="lstm", device="cpu")

"""Port delay-ensemble training (neurallaplacecontrol_tpu_torch.training.ensemble)
against the JAX package's training.ensemble: the stacked segment at f64 from
the same stacked parameters, data and batch indices as JAX's vmapped segment;
members that do not interact (each clips by its own gradient norm); a
1-delay ensemble that is the port's train_model; and the checkpoints a
multi-delay ensemble writes."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax_replay_draws import z0_draws

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.training import ensemble as jens
from neurallaplacecontrol_tpu.training import train as jtrain
from neurallaplacecontrol_tpu.training.train_latent_ode import build_history_windows as jax_windows
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.envs import make_env
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.training import ensemble as tens
from neurallaplacecontrol_tpu_torch.training import train as ttrain
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params, model_checkpoint_name

torch.set_num_threads(1)

ENV = "oderl-pendulum"
NARROW = dict(nl_hidden_units=16, rnn_hidden_units=32, node_hidden_units=16, latent_ode_hidden_units=32)
UPDATES = 20


def to_torch(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def adam_state(opt_state):
    """The ScaleByAdamState inside the JAX chain's (nested) state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        found = [adam_state(s) for s in opt_state]
        return next((s for s in found if s is not None), None)
    return None


def assert_tree_close(got, exp, rtol, atol=0.0):
    exp_leaves = jax.tree_util.tree_leaves(exp)
    got_leaves = tree_leaves(got)
    assert len(got_leaves) == len(exp_leaves)
    for g, e in zip(got_leaves, exp_leaves):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(e), rtol=rtol, atol=atol)


def member_data(n, bs, seed=0, members=2):
    """Per-member (s0, a0, sn, ts) [D, n, ...]: member 1's targets are 30x
    member 0's, so the members' losses and gradient norms differ widely;
    shared batch indices [UPDATES, bs]."""
    rng = np.random.default_rng(seed)
    s0 = rng.standard_normal((members, n, 3))
    a0 = rng.uniform(-2.0, 2.0, (members, n, 4, 1))
    ts = rng.exponential(0.05, (members, n, 1))
    sn = s0 + 0.1 * rng.standard_normal((members, n, 3))
    sn[1:] *= 30.0
    return s0, a0, sn, ts, rng.permutation(n)[: UPDATES * bs].reshape(UPDATES, bs)


def check_against_jax(tp, tstate, tl, jp, jstate, jl):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-9)
    assert_tree_close(tp, jp, rtol=1e-9, atol=1e-14)
    jadam = adam_state(jstate)
    assert_tree_close(tstate.mu, jadam.mu, rtol=1e-9, atol=1e-12)
    assert_tree_close(tstate.nu, jadam.nu, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(tstate.count.numpy(), np.asarray(jadam.count))


@pytest.mark.parametrize("family", ["nl", "rnn", "delta_t_rnn", "node", "nl_nan_member"])
def test_ensemble_segment_matches_jax_f64(family):
    """20 updates of a 2-delay ensemble from JAX's two inits (PRNGKey 3 and
    4), on the same per-member data and shared [20, 4] batch indices as
    JAX's ``_make_ensemble_segment_fn``: losses [2, 20], params, Adam moments
    and counts at rtol 1e-9. ``node`` trains at batch 4 here, as the
    ensemble runs it. ``nl_nan_member`` plants a NaN target in one of member
    1's batches: the ensemble has no guard, so that update is applied with
    its gradients zeroed, as in JAX."""
    name = "nl" if family == "nl_nan_member" else family
    s0, a0, sn, ts, idx = member_data(80, 4)
    if family == "nl_nan_member":
        sn[1, idx[6][0]] = np.nan
    jcfg, tcfg = JConfig(**NARROW), TConfig(**NARROW)
    jmodel = jax_make_model(name, ENV, 3, 1, 2.0, jcfg, dtype=jnp.float64)
    tmodel = torch_make_model(name, ENV, 3, 1, 2.0, tcfg, dtype=torch.float64, device="cpu")
    jparams = jens._stack_trees([jmodel.init(jax.random.PRNGKey(k)) for k in (3, 4)])
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    tparams = to_torch(jparams)  # before JAX's segment, which donates its params
    tstate0 = tens.stack_states([topt.init(tens.slice_tree(tparams, i)) for i in range(2)])
    jp, jstate, jl = jens._make_ensemble_segment_fn(jmodel.apply, jopt)(
        jparams, jax.vmap(jopt.init)(jparams), *(jnp.asarray(x) for x in (s0, a0, sn, ts)), jnp.asarray(idx))
    tp, tstate, tl = tens.make_ensemble_segment_fn(tmodel.apply, topt)(
        tparams, tstate0, *(torch.tensor(x) for x in (s0, a0, sn, ts)), torch.tensor(idx))
    assert tl.shape == (2, UPDATES)
    if family == "nl_nan_member":
        assert math.isnan(float(tl[1, 6])) and int(tstate.count[1]) == UPDATES
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], rtol=1e-9)
    check_against_jax(tp, tstate, tl, jp, jstate, jl)


def test_latent_ode_ensemble_segment_matches_jax_f64():
    """20 latent-ODE updates of a 2-delay ensemble on history windows, each
    member on its own key (``fold_in(k_seg, i)`` in JAX): the port takes
    JAX's IWAE draws of each member's update, made from that member's split
    key. Losses, params and Adam moments at rtol 1e-9 against JAX's
    ``_make_latent_ode_segment_fn`` run one member at a time: jitted over two
    members on the CPU, JAX's segment parts from its own eager run of the
    same two members by up to 14% in a loss, while its one-member runs equal
    that eager run to 4e-16 (scripts/port_jax_ensemble_probe.py)."""
    rng = np.random.default_rng(5)
    n = 83
    windows = []
    for member in range(2):
        s0, a0 = rng.standard_normal((n, 3)), rng.uniform(-2.0, 2.0, (n, 4, 1))
        ts, sn = rng.exponential(0.05, (n, 1)), rng.standard_normal((n, 3)) * (1.0 + 9.0 * member)
        windows.append([np.asarray(x) for x in jax_windows(*(jnp.asarray(x) for x in (s0, a0, sn, ts)), 4)])
    data = [np.stack([w[i] for w in windows]) for i in range(4)]
    idx = rng.permutation(data[0].shape[1])[:80].reshape(UPDATES, 4)
    jcfg, tcfg = JConfig(**NARROW), TConfig(**NARROW)
    jmodel = jax_make_model("latent_ode", ENV, 3, 1, 2.0, jcfg, dtype=jnp.float64)
    tmodel = torch_make_model("latent_ode", ENV, 3, 1, 2.0, tcfg, dtype=torch.float64, device="cpu")
    inits = [jmodel.init(jax.random.PRNGKey(k)) for k in (6, 7)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(8), i) for i in range(2)]
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    tparams = to_torch(jens._stack_trees(inits))
    jsegment = jens._make_latent_ode_segment_fn(jmodel.train_step, jopt)
    runs = []
    for member in range(2):
        p1 = jens._stack_trees([inits[member]])
        runs.append(jsegment(p1, jax.vmap(jopt.init)(p1), keys[member][None],
                             *(jnp.asarray(x[member:member + 1]) for x in data), jnp.asarray(idx)))
    jp, jstate, jl = (jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *parts) for parts in zip(*runs))
    eps = []
    for member in range(2):
        k, draws = keys[member], []
        for _ in range(UPDATES):
            k, ku = jax.random.split(k)
            draws.append(z0_draws(ku, 4, 5, n_samples=3))
        eps.append(np.stack(draws))
    tstate0 = tens.stack_states([topt.init(tens.slice_tree(tparams, i)) for i in range(2)])
    tp, tstate, tl = tens.make_latent_ode_ensemble_segment_fn(tmodel, topt)(
        tparams, tstate0, torch.tensor(np.stack(eps)), *(torch.tensor(x) for x in data), torch.tensor(idx))
    check_against_jax(tp, tstate, tl, jp, jstate, jl)


def test_members_clip_by_their_own_norm():
    """Member 0's gradients stay below the clip's 0.1 and member 1's are far
    above it. The stacked segment equals each member's own train_model
    segment (loss_cap inf, every loss finite) to 1e-12: a norm taken over
    the stacked gradients would have clipped member 0 as well and coupled
    the members."""
    cfg = TConfig(**NARROW)
    model = torch_make_model("rnn", ENV, 3, 1, 2.0, cfg, dtype=torch.float64, device="cpu")
    s0, a0, sn, ts, idx = (torch.tensor(x) for x in member_data(80, 4, seed=1))
    params = [model.init(torch.Generator().manual_seed(k)) for k in (0, 1)]
    with torch.no_grad():  # member 0's targets: its own init's predictions, slightly off
        sn[0] = s0[0] + model.apply(params[0], s0[0], a0[0], ts[0]) + 1e-3 * (sn[0] - s0[0])
    norms = []
    for i, p in enumerate(params):
        leaves = [x.clone().requires_grad_(True) for x in tree_leaves(p)]
        pred = model.apply(tree_unflatten(p, leaves), s0[i][idx[0]], a0[i][idx[0]], ts[i][idx[0]])
        loss = torch.mean((pred - (sn[i][idx[0]] - s0[i][idx[0]])) ** 2)
        norms.append(float(torch.sqrt(sum(torch.sum(g * g) for g in torch.autograd.grad(loss, leaves)))))
    assert norms[0] < 0.1 < norms[1] and math.hypot(*norms) > 0.1, norms
    opt = ttrain.make_optimizer(cfg)
    ep, es, el = tens.make_ensemble_segment_fn(model.apply, opt)(
        tens.stack_trees(params), tens.stack_states([opt.init(p) for p in params]), s0, a0, sn, ts, idx)
    segment = ttrain.make_train_segment_fn(model, opt)
    for i, p in enumerate(params):
        pp, ps, pl = segment(p, opt.init(p), s0[i], a0[i], sn[i], ts[i], idx)
        np.testing.assert_allclose(el[i].numpy(), pl.numpy(), rtol=1e-12)
        for a, b in zip(tree_leaves(tens.slice_tree(ep, i)), tree_leaves(pp)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-15)
        assert int(es.count[i]) == int(ps.count) == UPDATES


def small_config(path, **kw):
    base = dict(train_with_expert_trajectories=False, train_samples_per_dim=4, iters_per_log=50,
                saved_models_path=str(path) + "/", training_epochs=3, learning_rate=1e-3,
                end_training_after_seconds=None, **NARROW)
    base.update(kw)
    return TConfig(**base)


@pytest.mark.parametrize("family", ["rnn", "delta_t_rnn", "latent_ode"])
def test_single_delay_ensemble_matches_train_model(family, tmp_path):
    """The port's counterpart of tests/test_ensemble.py::
    test_single_delay_ensemble_matches_train_model: a 1-delay ensemble draws
    train_model's streams (the latent ODE's: train_latent_ode's), so its
    params and epoch losses equal train_model's at f64 (the guard of
    train_model does not fire on this data)."""
    kw = {}
    if family == "latent_ode":
        kw = dict(training_batch_size=4, iters_per_log=5, training_epochs=1, train_samples_per_dim=2)
    _, params_ref, res_ref = ttrain.train_model(family, ENV, small_config(tmp_path / "a", **kw), delay=1,
                                                retrain=True, force_retrain=True, dtype=torch.float64,
                                                device="cpu")
    out = tens.train_model_ensemble(family, ENV, small_config(tmp_path / "b", **kw), delays=[1],
                                    force_retrain=True, dtype=torch.float64, device="cpu")
    _, params_ens, res_ens = out[1]
    for a, b in zip(tree_leaves(params_ref), tree_leaves(params_ens)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(res_ref["epoch_losses"], res_ens["epoch_losses"], rtol=1e-10)
    assert len(res_ens["epoch_losses"]) == len(res_ref["epoch_losses"]) > 0


@pytest.mark.parametrize("family", ["delta_t_rnn", "node"])
def test_multi_delay_ensemble_trains_and_checkpoints(family, tmp_path):
    """The port's counterpart of tests/test_ensemble.py::
    test_multi_delay_ensemble_trains_and_checkpoints: both delays train (each
    member's final params fit a fixed dataset of its delay better than the
    init), the members differ, and each checkpoint loads back through
    train_model(retrain=False)."""
    cfg = small_config(tmp_path, training_epochs=2, train_samples_per_dim=3)
    out = tens.train_model_ensemble(family, ENV, cfg, delays=[0, 2], force_retrain=True, dtype=torch.float64,
                                    device="cpu")
    assert set(out) == {0, 2}
    env = make_env(ENV, ts_grid=cfg.ts_grid, dt=cfg.dt)
    model = out[0][0]
    init = model.init(torch.Generator().manual_seed(0))
    for d, (_, params, res) in out.items():
        assert (tmp_path / model_checkpoint_name(family, ENV, d, "exp", 0, False, training_epochs=2)).is_file()
        assert len(res["epoch_losses"]) == 2 and math.isfinite(res["best_val_loss"])
        assert res["ensemble_delays"] == [0, 2]
        s0, a0, sn, ts = ttrain.get_epoch_data(env, ENV, d, cfg, 123, torch.float64, "cpu")
        with torch.no_grad():
            mse = [float(torch.mean((model.apply(p, s0, a0, ts) - (sn - s0)) ** 2)) for p in (init, params)]
        assert mse[1] < mse[0], mse
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[2][1])))
    _, loaded, _ = ttrain.train_model(family, ENV, cfg, delay=2, retrain=False, dtype=torch.float64,
                                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), tree_leaves(out[2][1])))

"""The port's ODE-RL stack (neurallaplacecontrol_tpu_torch.oderl) against the
JAX package's (neurallaplacecontrol_tpu.oderl) at f64 on the CPU, on JAX's
parameters and JAX's random draws (tests/jax_oderl_draws.py): every net
family's apply and KL, the three simulators, the data helpers, the first
updates of each trainer, the CTRL checkpoint across the packages, and two
planted faults the comparisons must catch. Small widths: nets 2x16,
ensembles of 3, a handful of rows."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_oderl_draws as jd
from neurallaplacecontrol_tpu import oderl as jo
from neurallaplacecontrol_tpu.envs import make_env as jax_make_env
from neurallaplacecontrol_tpu.oderl import nets as jnets
from neurallaplacecontrol_tpu_torch import oderl as to
from neurallaplacecontrol_tpu_torch.envs import make_env as torch_make_env
from neurallaplacecontrol_tpu_torch.oderl import dynamics as tdyn
from neurallaplacecontrol_tpu_torch.oderl import nets as tnets
from neurallaplacecontrol_tpu_torch.utils.checkpoint import from_jax_params

torch.set_num_threads(1)

ENV = "oderl-pendulum"
SMALL = dict(n_ens=3, nl_f=2, nn_f=16, nn_g=16, nn_V=16)
F64 = torch.float64


def rel(got, exp) -> float:
    """max |got - exp| / (1 + |exp|)."""
    g = got.detach().double().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    e = np.asarray(exp, np.float64)
    assert g.shape == e.shape, (g.shape, e.shape)
    return float(np.max(np.abs(g - e) / (1.0 + np.abs(e)))) if g.size else 0.0


def t(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def pair(dynamics, **kw):
    """(JAX ctrl, port ctrl, JAX params, the same params in the port) at f64."""
    opts = {**SMALL, **kw}
    jctrl = jo.make_ctrl(jax_make_env(ENV), dynamics, **opts)
    tctrl = to.make_ctrl(torch_make_env(ENV), dynamics, dtype=F64, device="cpu", **opts)
    jparams = jctrl.init(jax.random.PRNGKey(3))
    return jctrl, tctrl, jparams, to.ctrl_params_from_jax(tctrl, jparams)


# ---------------------------------------------------------------- nets

N_IN, N_OUT, L, N = 4, 3, 3, 5
MAKERS = {  # name: (JAX maker, port maker, args)
    "mlp": (jnets.make_mlp, tnets.make_mlp, (N_IN, N_OUT)),
    "bnn": (jnets.make_bnn, tnets.make_bnn, (N_IN, N_OUT)),
    "enn": (jnets.make_enn, tnets.make_enn, (L, N_IN, N_OUT)),
    "epnn": (jnets.make_epnn, tnets.make_epnn, (L, N_IN, N_OUT)),
    "benn": (jnets.make_benn, tnets.make_benn, (L, N_IN, N_OUT)),
    "ibnn": (jnets.make_ibnn, tnets.make_ibnn, (L, N_IN, N_OUT)),
    "dropout_bnn": (jnets.make_dropout_bnn, tnets.make_dropout_bnn, (N_IN, N_OUT)),
}


@pytest.mark.parametrize("family", sorted(MAKERS))
def test_net_matches_jax(family):
    """apply, kl and shuffle on JAX's params and noise, < 1e-12 at f64; the
    port's own init and draw_noise have JAX's shapes (and dtypes, the
    dropout masks' float32 included)."""
    jmake, tmake, args = MAKERS[family]
    kw = dict(n_hidden=16, act="elu" if family != "dropout_bnn" else "relu")
    if family == "dropout_bnn":
        kw["dropout_rate"] = 0.3
    jnet, tnet = jmake(*args, **kw), tmake(*args, dtype=F64, **kw)
    key = jax.random.PRNGKey(11)
    jp = jnet.init(key)
    tp = from_jax_params(jp, device="cpu")
    x = jax.random.normal(jax.random.fold_in(key, 1), (L, N, N_IN))
    k_noise = jax.random.fold_in(key, 2)
    noise = jd.f_noise(jnet, jp, k_noise, L, (L, N, N_OUT))
    exp = jnet.apply(jp, x, jnet.draw_noise(jp, k_noise, L))
    got = tnet.apply(tp, t(x), jd.to_torch(noise))
    assert got.dtype == F64 and rel(got, exp) < 1e-12
    assert rel(tnet.kl(tp), jnet.kl(jp)) < 1e-12
    gen = torch.Generator().manual_seed(0)
    mine = tnet.init(gen)
    assert [(k, tuple(v.shape), v.dtype) for k, v in _leaves(mine)] == [
        (k, tuple(np.shape(v)), F64) for k, v in _leaves(jp)]
    tn = tnet.draw_noise(mine, gen, L)
    if family == "epnn":
        assert tn is gen and tuple(jnet.draw_noise(jp, k_noise, L).shape) == (2,)
    else:
        jn = jnet.draw_noise(jp, k_noise, L)
        assert [(k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in _leaves(tn)] == [
            (k, tuple(np.shape(v)), str(np.asarray(v).dtype)) for k, v in _leaves(jn)]
    if tnet.n_ens > 1:
        perm = jax.random.permutation(jax.random.fold_in(key, 3), L)
        shuffled = tnet.shuffle(tp, torch.as_tensor(np.array(perm)))
        for (k, a), (_, b) in zip(_leaves(shuffled), _leaves(jnet.shuffle(jp, jax.random.fold_in(key, 3)))):
            assert rel(a, b) == 0.0, k


def _leaves(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("act", sorted(jnets._ACTS))
def test_activations_match_jax(act):
    """Each activation against jax.nn's, softplus above torch's threshold too."""
    x = np.linspace(-30.0, 30.0, 601)
    assert rel(tnets.get_act(act)(t(x)), jnets.get_act(act)(jnp.asarray(x))) < 1e-15


def test_epnn_probs_and_bounds_match_jax():
    jnet, tnet = jnets.make_epnn(L, N_IN, N_OUT, n_hidden=16), tnets.make_epnn(L, N_IN, N_OUT, n_hidden=16, dtype=F64)
    jp = jnet.init(jax.random.PRNGKey(5))
    x = 40.0 * jax.random.normal(jax.random.PRNGKey(6), (L, N, N_IN))  # drive logvar to its bounds
    for g, e in zip(tnet.extras["get_probs"](from_jax_params(jp, device="cpu"), t(x)), jnet.extras["get_probs"](jp, x)):
        assert rel(g, e) < 1e-12
    assert rel(tnet.apply(from_jax_params(jp, device="cpu"), t(x), None), jnet.extras["get_probs"](jp, x)[0]) < 1e-12


# ---------------------------------------------------------------- simulators

S0 = np.array([[np.cos(0.3), np.sin(0.3), 0.1], [np.cos(2.0), np.sin(2.0), -0.4], [-1.0, 0.0, 0.0]])


@pytest.mark.parametrize("dynamics", list(to.DYNAMICS_FAMILIES))
def test_forward_simulate_matches_jax(dynamics):
    """forward_simulate of every family with the reward and the discount, on
    JAX's draws, < 1e-10 at f64 (states, rewards and the grid)."""
    jctrl, tctrl, jp, tp = pair(dynamics)
    key = jax.random.PRNGKey(21)
    H, T, L_ = 0.25, 5, 4
    kw = dict(L=L_, tau=2.0, compute_rew=True)
    exp = jctrl.forward_simulate(jp, key, H, jnp.asarray(S0), substeps=2, **kw)
    draws = jd.ReplayDraws(jd.sim_draws(jctrl, jp["f"], key, L_, len(S0), T))
    got = tctrl.forward_simulate(tp, draws, H, t(S0), substeps=2, **kw)
    assert draws.done()
    for name, g, e in zip(("st", "rt", "ts"), got, exp):
        assert rel(g, e) < 1e-10, (dynamics, name, rel(g, e))


def test_simulate_enode_euler_and_shared_grid_match_jax():
    """simulate_enode with Euler substeps on an explicit irregular grid."""
    jctrl, tctrl, jp, tp = pair("ibnode")
    key, ts = jax.random.PRNGKey(4), np.array([0.0, 0.03, 0.1, 0.12, 0.2])
    g_j, g_t = jctrl.make_policy(jp), tctrl.make_policy(tp)
    exp = jo.simulate_enode(jctrl.f_net, jp["f"], jctrl.env, g_j, jnp.asarray(S0), key, ts=jnp.asarray(ts), L=6,
                            substeps=3, method="euler")
    draws = jd.ReplayDraws(jd.sim_draws(jctrl, jp["f"], key, 6, len(S0), 4))
    got = to.simulate_enode(tctrl.f_net, tp["f"], tctrl.env, g_t, t(S0), draws, ts=t(ts), L=6, substeps=3,
                            method="euler")
    for g, e in zip(got, exp):
        assert rel(g, e) < 1e-10


def test_planted_population_std_fault_is_caught(monkeypatch):
    """DeepPILCO's moment matching with torch.std's default ddof=1 in place
    of jnp.std's ddof=0 misses the simulator's 1e-10 limit."""
    jctrl, tctrl, jp, tp = pair("deep_pilco")
    key = jax.random.PRNGKey(21)
    exp = jctrl.forward_simulate(jp, key, 0.25, jnp.asarray(S0), L=4)
    real_std = torch.std
    monkeypatch.setattr(tdyn.torch, "std", lambda x, dim, correction: real_std(x, dim=dim))
    draws = jd.ReplayDraws(jd.sim_draws(jctrl, jp["f"], key, 4, len(S0), 5))
    got = tctrl.forward_simulate(tp, draws, 0.25, t(S0), L=4)
    assert rel(got[0], exp[0]) > 1e-3


# ---------------------------------------------------------------- data helpers

def test_collect_data_matches_jax():
    """collect_data on JAX's reset states and GP normals, < 1e-12."""
    key, H, Nt = jax.random.PRNGKey(8), 0.5, 3
    jenv, tenv = jax_make_env(ENV), torch_make_env(ENV)
    T = int(H / jenv.spec.dt)
    ts = jenv.spec.dt * jnp.arange(T)
    exp = jo.collect_data(key, jenv, H=H, N=Nt)
    s0, normals = [], []
    for k in jax.random.split(key, Nt):
        k_reset, k_gp = jax.random.split(k)
        s0.append(np.asarray(jenv.reset(k_reset)))
        normals.append(np.asarray(jax.random.normal(k_gp, (T, jenv.spec.m))))
    assert ts.shape == (T,)
    got = to.collect_data(tenv, H, Nt, s0=np.stack(s0), normals=np.stack(normals), dtype=F64, device="cpu")
    for name, g, e in zip(exp._fields, got, exp):
        assert rel(g, e) < 1e-12, name
    both = got.add_experience(got)
    assert both.N == 2 * Nt and both.T == T


def test_kernel_helpers_match_jax():
    """kernel_interpolate, the per-trajectory interpolating policy and a GP
    draw on JAX's normals, < 1e-12; a kernel the factorization rejects gives
    NaN in both packages."""
    ts = 0.05 * np.arange(12.0)
    ys = np.sin(3 * ts)[:, None] * np.array([[1.0, -0.5]])
    q = np.array([0.0, 0.07, 0.31, 0.55])
    assert rel(to.kernel_interpolate(t(ts), t(ys), t(q)), jo.kernel_interpolate(ts, ys, q)) < 1e-12
    tss = np.stack([ts, ts * 1.3])
    at = np.stack([ys, -ys])
    g_j, g_t = jo.make_kernel_interpolate_policy(tss, at), to.make_kernel_interpolate_policy(t(tss), t(at))
    for tq in (0.0, 0.21, 0.4):
        assert rel(g_t(None, tq), g_j(None, tq)) < 1e-12
    key = jax.random.PRNGKey(2)
    normals = np.asarray(jax.random.normal(key, (12, 2)))
    assert rel(to.draw_from_gp(t(ts), 2, normals=t(normals)), jo.draw_from_gp(key, jnp.asarray(ts), 2)) < 1e-12
    bad_j = jo.draw_from_gp(key, jnp.asarray(ts), 2, eps=-1.5)
    bad_t = to.draw_from_gp(t(ts), 2, eps=-1.5, normals=t(normals))
    assert np.isnan(np.asarray(bad_j)).all() and torch.isnan(bad_t).all()
    jenv = jax_make_env(ENV)
    g_j = jo.dataset.make_exploration_policy(key, jenv, 12, sf=0.1)
    g_t = to.dataset.make_exploration_policy(torch_make_env(ENV), 12, sf=0.1, normals=t(jax.random.normal(key, (12, 1))),
                                             dtype=F64, device="cpu")
    for tq in (0.0, 0.13, 0.5):
        assert rel(g_t(None, tq), g_j(None, tq)) < 1e-12
    K = to.dataset.rbf_kernel(t(q)[:, None], t(q)[:, None])  # no jitter unless asked
    assert rel(K, jo.dataset.rbf_kernel(jnp.asarray(q)[:, None], jnp.asarray(q)[:, None])) < 1e-15


# ---------------------------------------------------------------- trainers

def dataset_pair(n_traj=4, H=0.6):
    jD = jo.collect_data(jax.random.PRNGKey(30), jax_make_env(ENV), H=H, N=n_traj)
    return jD, to.Dataset(*(t(x) for x in jD))


def run_trainer(case, lr_scale=1.0):
    """(port losses, JAX losses, port params, JAX params) of 5 updates."""
    name, dynamics = case
    jctrl, tctrl, jp, tp = pair(dynamics)
    jD, tD = dataset_pair()
    key, n = jax.random.PRNGKey(40), 5
    if name == "gradient_match":
        jout = jo.gradient_match(jctrl, jp, jD, key, n_iter=n, L=4, lr=1e-2)
        draws = jd.gradient_match_draws(jctrl, jp["f"], key, n, 4, jD.N * (jD.T - 1))
        tout = to.gradient_match(tctrl, tp, tD, jd.ReplayDraws(draws), n_iter=n, L=4, lr=1e-2 * lr_scale)
    elif name == "train_pets":
        jout = jo.train_pets(jctrl, jp, jD, key, n_iter=n, lr=1e-2)
        tout = to.train_pets(tctrl, tp, tD, None, n_iter=n, lr=1e-2 * lr_scale)
    elif name == "train_deep_pilco":
        jout = jo.train_deep_pilco(jctrl, jp, jD, key, n_iter=n, L=6, lr=1e-2)
        draws = jd.gradient_match_draws(jctrl, jp["f"], key, n, 6, jD.N * (jD.T - 1))
        tout = to.train_deep_pilco(tctrl, tp, tD, jd.ReplayDraws(draws), n_iter=n, L=6, lr=1e-2 * lr_scale)
    elif name == "train_dynamics":
        kw = dict(n_iter=n, n_seg=4, H=0.15, substeps=2, L=2, lr=1e-2)
        jout = jo.train_dynamics(jctrl, jp, jD, key, log_every=0, **kw)
        draws = jd.train_dynamics_draws(jctrl, jp["f"], key, n, jD.N, jD.T, 3, 4, 2)
        tout = to.train_dynamics(tctrl, tp, tD, jd.ReplayDraws(draws), log_every=0, **{**kw, "lr": 1e-2 * lr_scale})
    else:  # train_policy
        kw = dict(n_iter=n, H=0.2, N=4, L=2, substeps=2, value_inner_iters=3, target_update_every=2, lr=1e-2)
        jout = jo.train_policy(jctrl, jp, jD, key, log_every=0, **kw)
        draws = jd.train_policy_draws(jctrl, jp["f"], key, n, jD.N * jD.T, 4, 2, 4)
        tout = to.train_policy(tctrl, tp, tD, jd.ReplayDraws(draws), log_every=0, **{**kw, "lr": 1e-2 * lr_scale})
    return tout[1], jout[1], tout[0], jout[0]


TRAINER_CASES = [("gradient_match", "enode"), ("gradient_match", "ibnode"), ("gradient_match", "pets"),
                 ("train_pets", "pets"), ("train_deep_pilco", "deep_pilco"), ("train_dynamics", "enode"),
                 ("train_dynamics", "ibnode"), ("train_dynamics", "deep_pilco"), ("train_policy", "enode"),
                 ("train_policy", "pets")]


def rel_losses(got, exp) -> float:
    g, e = np.asarray(got), np.asarray(exp)
    return float(np.max(np.abs(g - e) / np.abs(e)))


@pytest.mark.parametrize("case", TRAINER_CASES, ids=["-".join(c) for c in TRAINER_CASES])
def test_trainer_first_updates_match_jax(case):
    """The first 5 updates' losses within 1e-9 relative of JAX's, on JAX's
    init, data and draws at f64; the params after them too (1e-9 in
    units of 1 + |p|)."""
    got, exp, tparams, jparams = run_trainer(case)
    assert len(got) == len(exp) == 5
    assert rel_losses(got, exp) < 1e-9, (case, got, exp)
    for (k, a), (_, b) in zip(_leaves(tparams), _leaves(jparams)):
        assert rel(a, b) < 1e-9, (case, k)


def test_planted_learning_rate_fault_is_caught():
    """train_policy with its learning rate 10% off misses the 1e-9 limit."""
    got, exp, _, _ = run_trainer(("train_policy", "enode"), lr_scale=1.1)
    assert rel_losses(got, exp) > 1e-6


# ---------------------------------------------------------------- CTRL

def test_ctrl_checkpoint_crosses_both_ways(tmp_path):
    """A CTRL saved by the JAX package loads in the port, and one saved by
    the port loads in the JAX package, value for value."""
    jctrl, tctrl, jp, tp = pair("pets")
    jctrl.save(jp, str(tmp_path / "jax.npz"))
    for (k, a), (_, b) in zip(_leaves(tctrl.load(str(tmp_path / "jax.npz"))), _leaves(jp)):
        assert rel(a, b) == 0.0, k
    mine = tctrl.init(torch.Generator().manual_seed(1))
    tctrl.save(mine, str(tmp_path / "port.npz"))
    back = jctrl.load(str(tmp_path / "port.npz"))
    for (k, a), (_, b) in zip(_leaves(mine), _leaves(back)):
        assert rel(a, b) == 0.0, k
    with pytest.raises(ValueError):
        to.make_ctrl(torch_make_env(ENV), "enode", dtype=F64, device="cpu", **{**SMALL, "nn_f": 8}).load(
            str(tmp_path / "port.npz"))


def test_ctrl_surface_matches_jax():
    assert to.DEFAULTS == jo.ctrl.DEFAULTS and to.DYNAMICS_FAMILIES == jo.ctrl.DYNAMICS_FAMILIES
    env = torch_make_env(ENV)
    with pytest.raises(TypeError, match="unknown options"):
        to.make_ctrl(env, "enode", device="cpu", nn_x=3)
    jctrl, tctrl, jp, tp = pair("enode")
    assert (tctrl.name, tctrl.is_cont, tctrl.get_L(7)) == (jctrl.name, jctrl.is_cont, jctrl.get_L(7))
    s = np.array([[0.3, 0.9, -1.2]])
    assert rel(tctrl.policy_apply(tp, t(s)), jctrl.policy_apply(jp, jnp.asarray(s))) < 1e-13
    assert rel(tctrl.value_apply(tp, t(s)), jctrl.value_apply(jp, jnp.asarray(s))) < 1e-13
    full = to.make_ctrl(env, "enode", device="cpu")
    assert sum(x.numel() for _, x in _leaves(full.init())) == sum(
        int(np.size(x)) for _, x in _leaves(jo.make_ctrl(jax_make_env(ENV), "enode").init(jax.random.PRNGKey(0))))


def test_entry_points_need_a_device(monkeypatch):
    """make_ctrl and collect_data default to CUDA and never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = torch_make_env(ENV)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.make_ctrl(env, "enode")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to.collect_data(env, 0.5)
    assert math.isfinite(float(to.collect_data(env, 0.2, 2, torch.Generator().manual_seed(0), device="cpu").r.sum()))


def test_oderl_demo_runs_on_the_cpu(tmp_path):
    """scripts/oderl_demo_torch.py's flow at a few updates: the drift fit's
    loss falls, the CTRL file loads in the JAX package, the rollout is
    finite."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from scripts import oderl_demo_torch

    out = oderl_demo_torch.main(device="cpu", out=str(tmp_path), sizes=SMALL, gm=dict(n_iter=40, lr=3e-3),
                                dyn=dict(n_iter=3, n_seg=4), pol=dict(n_iter=2, H=0.3, N=4, L=3))
    gm = out["gradient_match"]["losses"]
    assert len(gm) == 40 and gm[-1] < 0.8 * gm[0]
    assert len(out["train_dynamics"]["losses"]) == 3 and len(out["train_policy"]["losses"]) == 2
    back = jo.make_ctrl(jax_make_env(ENV), "enode", **SMALL).load(out["checkpoint"])
    assert np.asarray(back["g"][0]["W"]).shape == (3, 16)
    assert bool(torch.isfinite(out["rollout"]["learned"]).all()) and out["rollout"]["true"].shape == (40, 3)

"""JAX reference for the PyTorch port's research modules on the card.

    JAX_PLATFORMS=cpu python scripts/port_jax_research_reference.py

Runs the JAX package at f64 on the CPU and writes
``artifacts/port/jax_research_pendulum.npz``, which ``chip_smoke.py`` phase
``research`` reads, since the GPU machine has no JAX:

- ``enode/init/*``: ``oderl.make_ctrl(pendulum, "enode")`` at ``DEFAULTS``
  (an ensemble of 10 nets 3x200 ELU; policy and value nets 2x200),
  ``init(PRNGKey(0))`` stored as float32; both packages run it upcast to f64;
- ``data/*``: ``collect_data(PRNGKey(1), pendulum, H=2.0, N=8)`` at f64;
- ``sim/*``: ``forward_simulate`` from 100 states of the data (``sim/s0``),
  H = 2 s, L = 10, tau 5, with rewards: every member's final state and reward
  integral for all 100 rows, and the full trajectories of the first 16;
- ``gm/losses``, ``dyn/losses``, ``pol/rewards``: the first 20 updates of
  ``gradient_match``, ``train_dynamics`` and ``train_policy``, each from the
  init at its default arguments (``train_policy``: N=100, H=2.0, L forced to
  n_ens), with the keys ``PRNGKey(2)``, ``(3)``, ``(4)``; ``dyn/traj`` and
  ``dyn/start`` [20, 32], ``pol/idx`` [20, 100] their draws (ENODE draws no
  function noise); ``*/probe_*``: the trained nets on 64 probe inputs;
- ``seq/*``: ODE-RNN, GRU and GRU-D (expdecay) at their default widths on
  an irregular sine (``data.toy``, the index draw stored), each init stored
  as float32 and upcast, and 60 f64 Adam updates (lr 1e-2) of the
  reconstruction MSE;
- ``latent/*``: ``generate_irregular_data_delay_latent`` on cartpole with
  ``latent=True``, ``delay=2``, ``rand=True``, 3 samples per dimension (its
  draws and outputs), and both two-frame oracles on 256 seeded frames;
- ``meta``: commit, command, JAX version, seconds, and the sha256 of every
  JAX source file the run executed, which the phase checks against the
  checkout's.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neurallaplacecontrol_tpu import oderl  # noqa: E402
from neurallaplacecontrol_tpu.data import synthetic  # noqa: E402
from neurallaplacecontrol_tpu.data import toy  # noqa: E402
from neurallaplacecontrol_tpu.envs import make_env, oracle, sample_dt  # noqa: E402
from neurallaplacecontrol_tpu.models import seq_baselines  # noqa: E402

OUT = ROOT / "artifacts" / "port" / "jax_research_pendulum.npz"
SOURCES = [f"neurallaplacecontrol_tpu/oderl/{f}.py" for f in ("nets", "dataset", "dynamics", "ctrl", "train")] + [
    "neurallaplacecontrol_tpu/models/seq_baselines.py", "neurallaplacecontrol_tpu/models/common.py",
    "neurallaplacecontrol_tpu/data/toy.py", "neurallaplacecontrol_tpu/data/synthetic.py",
    "neurallaplacecontrol_tpu/envs/oracle.py", "neurallaplacecontrol_tpu/envs/pendulum.py",
    "neurallaplacecontrol_tpu/envs/cartpole.py", "neurallaplacecontrol_tpu/envs/base.py"]
N_UPDATES, SEQ_UPDATES, SIM_ROWS, SIM_FULL_ROWS, PROBE = 20, 60, 100, 16, 64


def flat(prefix, tree, out, dtype=None):
    """``out[prefix/path] = leaf`` over a tree of arrays (lists numbered)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat(f"{prefix}/{k}", v, out, dtype)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat(f"{prefix}/{i}", v, out, dtype)
    else:
        out[prefix] = np.asarray(tree, dtype=dtype)


def upcast(tree):
    """The tree's float32 values as f64 (what both runs start from)."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x, np.float32), jnp.float64), tree)


def main():
    t0 = time.time()
    out = {}
    env = make_env("oderl-pendulum")
    ctrl = oderl.make_ctrl(env, "enode")
    params = upcast(ctrl.init(jax.random.PRNGKey(0)))
    flat("enode/init", params, out, np.float32)

    D = oderl.collect_data(jax.random.PRNGKey(1), env, H=2.0, N=8)
    for k, v in zip(D._fields, D):
        out[f"data/{k}"] = np.asarray(v)
    pool = D.s.reshape(-1, D.s.shape[-1])
    probe_s = pool[::5][:PROBE]
    probe_x = jnp.concatenate([probe_s, jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (PROBE, 1)))], -1)
    out["probe/s"], out["probe/x"] = np.asarray(probe_s), np.asarray(probe_x)

    s0 = pool[:SIM_ROWS]
    st, rt, ts = ctrl.forward_simulate(params, jax.random.PRNGKey(5), 2.0, s0, L=10, tau=5.0, compute_rew=True)
    out["sim/s0"], out["sim/ts"] = np.asarray(s0), np.asarray(ts)
    out["sim/st_last"], out["sim/rt_last"] = np.asarray(st[:, :, -1]), np.asarray(rt[:, :, -1])
    out["sim/st_head"], out["sim/rt_head"] = np.asarray(st[:, :SIM_FULL_ROWS]), np.asarray(rt[:, :SIM_FULL_ROWS])
    print(f"simulate {time.time() - t0:.1f} s", flush=True)

    def f_probe(p):
        return np.asarray(ctrl.f_net.apply(p["f"], jnp.broadcast_to(probe_x[None], (10,) + probe_x.shape)))

    p_gm, losses = oderl.gradient_match(ctrl, params, D, jax.random.PRNGKey(2), n_iter=N_UPDATES)
    out["gm/losses"], out["gm/probe_f"] = np.asarray(losses), f_probe(p_gm)
    print(f"gradient_match {time.time() - t0:.1f} s", flush=True)

    key, W, n_seg = jax.random.PRNGKey(3), 5, 32
    traj, start = [], []
    for i in range(N_UPDATES):
        k1, k2 = jax.random.split(jax.random.split(jax.random.fold_in(key, i))[0])
        traj.append(np.asarray(jax.random.randint(k1, (n_seg,), 0, D.N)))
        start.append(np.asarray(jax.random.randint(k2, (n_seg,), 0, D.T - W)))
    p_dyn, mses = oderl.train_dynamics(ctrl, params, D, key, n_iter=N_UPDATES, log_every=0)
    out["dyn/traj"], out["dyn/start"] = np.stack(traj), np.stack(start)
    out["dyn/losses"], out["dyn/probe_f"] = np.asarray(mses), f_probe(p_dyn)
    out["dyn/logsn"] = np.asarray(p_dyn["logsn"])
    print(f"train_dynamics {time.time() - t0:.1f} s", flush=True)

    key, N = jax.random.PRNGKey(4), 100
    out["pol/idx"] = np.stack([np.asarray(jax.random.randint(jax.random.split(jax.random.fold_in(key, i), 3)[0],
                                                             (N,), 0, pool.shape[0])) for i in range(N_UPDATES)])
    p_pol, rewards = oderl.train_policy(ctrl, params, D, key, n_iter=N_UPDATES, log_every=0)
    out["pol/rewards"] = np.asarray(rewards)
    out["pol/probe_g"] = np.asarray(ctrl.policy_apply(p_pol, probe_s))
    out["pol/probe_V"] = np.asarray(ctrl.value_apply(p_pol, probe_s))
    print(f"train_policy {time.time() - t0:.1f} s", flush=True)

    traj_s, t_s = toy.sine(6, t_nsamples=100)
    amp = jnp.asarray([1.0, 0.5, -0.7, 1.3, -0.2, 0.9])[:, None, None]
    idx = np.sort(np.asarray(jax.random.choice(jax.random.PRNGKey(6), 100, (40,), replace=False)))
    x, tq = (traj_s * amp)[:, idx], t_s[idx]
    out["seq/x"], out["seq/ts"], out["seq/idx"] = np.asarray(x), np.asarray(tq), idx
    models = {"ode_rnn": seq_baselines.make_ode_rnn(1), "gru": seq_baselines.make_classic_rnn(1, cell="gru"),
              "expdecay": seq_baselines.make_classic_rnn(1, cell="expdecay")}
    for j, (name, model) in enumerate(models.items()):
        p = upcast(model.init(jax.random.PRNGKey(10 + j)))
        flat(f"seq/{name}/init", p, out, np.float32)
        opt = optax.adam(1e-2)
        state = opt.init(p)
        grad = jax.jit(jax.value_and_grad(lambda q, model=model: jnp.mean((model.reconstruct(q, x, tq) - x) ** 2)))
        losses = []
        for _ in range(SEQ_UPDATES):
            loss, g = grad(p)
            u, state = opt.update(g, state)
            p = optax.apply_updates(p, u)
            losses.append(float(loss))
        out[f"seq/{name}/losses"] = np.asarray(losses)
        out[f"seq/{name}/encode"] = np.asarray(model.encode(p, x, tq))
    print(f"sequence models {time.time() - t0:.1f} s", flush=True)

    cenv = make_env("oderl-cartpole", ts_grid="exp")
    key, spd, delay = jax.random.PRNGKey(7), 3, 2
    S = spd ** cenv.spec.n_state
    u_s, u_a, dts = [], [], []
    for k in jax.random.split(key, spd):
        k_s, k_a, k_t = jax.random.split(k, 3)
        u_s.append(np.asarray(jax.random.uniform(k_s, (S, cenv.spec.n_state))))
        u_a.append(np.asarray(jax.random.uniform(k_a, (spd, cenv.spec.m))))
        dts.append(np.asarray(sample_dt(k_t, cenv.spec.ts_grid, cenv.spec.dt, (3,))))
    gen = synthetic.generate_irregular_data_delay_latent(cenv, key, delay, samples_per_dim=spd, rand=True,
                                                         latent=True)
    out["latent/u_states"], out["latent/u_actions"], out["latent/grid_dts"] = map(np.stack, (u_s, u_a, dts))
    out["latent/u_buffer"] = np.asarray(jax.random.uniform(jax.random.fold_in(key, 7),
                                                           (gen[0].shape[0], delay, cenv.spec.m)))
    for name, v in zip(("s0", "a0", "sb", "sn", "ts"), gen):
        out[f"latent/{name}"] = np.asarray(v)
    rng = np.random.default_rng(8)
    raw = rng.uniform(-3.0, 3.0, (256, 4))
    prev = raw - 0.05 * rng.uniform(-1.0, 1.0, raw.shape)
    act, tq = rng.uniform(-4.0, 4.0, (256, 1)), rng.uniform(0.02, 0.1, (256, 1))
    trig, trig_prev = np.asarray(cenv.observe(jnp.asarray(raw))), np.asarray(cenv.observe(jnp.asarray(prev)))
    out["oracle/trig"], out["oracle/trig_prev"], out["oracle/action"], out["oracle/ts"] = trig, trig_prev, act, tq
    out["oracle/latent"] = np.asarray(oracle.cartpole_dynamics_dt_latent(trig, trig_prev, act, tq))
    out["oracle/latent_reduced"] = np.asarray(oracle.cartpole_dynamics_dt_latent_reduced(
        trig[:, [0, 2, 3]], trig_prev[:, [0, 2, 3]], act, tq))

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True).stdout.strip()
    out["meta"] = np.asarray(json.dumps({
        "commit": commit, "command": "JAX_PLATFORMS=cpu python scripts/port_jax_research_reference.py",
        "jax": jax.__version__, "seconds": time.time() - t0,
        "sources": {f: hashlib.sha256((ROOT / f).read_bytes()).hexdigest() for f in SOURCES}}))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e6:.2f} MB) in {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()

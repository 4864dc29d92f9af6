"""JAX reference for the PyTorch port's baseline families on the card.

    JAX_PLATFORMS=cpu python scripts/port_jax_baselines_reference.py

Runs the JAX package at f64 on the CPU on the tracked pendulum-d1 checkpoint
of each baseline family (rnn, delta_t_rnn, node, latent_ode; full width: GRU
160, ODE MLP 5-270-270-4, latent ODE 128 units and 5 latents) and writes
``artifacts/port/jax_baselines_pendulum_d1.npz``, which ``chip_smoke.py``
phase ``baselines`` reads, since the GPU machine has no JAX:

- ``inputs/*``: 1,000 seeded planner queries in f32, obs [1000, 3] ~ N(0, 1),
  action buffers [1000, 4, 1] ~ U(-2, 2), horizon ``ts`` [1000, 1] = dt;
  ``out/<family>``: each family's f64 ``apply`` on them;
- ``latent_ode/z0``: the draw ``PRNGKey(0)`` gives the latent ODE's ``apply``
  at 1,000 rows (f64), on which ``out/latent_ode`` was computed;
  ``latent_ode/n_acc``: each row's accepted dopri5 steps in that forward;
  ``latent_ode/nfes``: ``decoder_nfes`` on the same queries;
- ``carried/*``: the latent ODE's carried planner dynamics over one 40-step
  horizon from 1,000 seeded states (``state0``), the windows sliced from one
  seeded action sequence ``full`` [1000, 43, 1] (history then horizon), on
  the same draw ``latent_ode/z0`` (1,000 rows a call): ``final`` the f64 states
  after the 40 steps, ``states`` the states of the first 100 rows at every
  step (f32);
- ``train/*``: 20 updates of a training segment at f64 from each family's
  checkpoint at the default ``Config`` on the first transitions of the
  tracked pendulum-d1 buffer (``artifacts/port/jax_train_pendulum_d1.npz``
  holds them): ``train/<family>/batch_idx`` (batch 16; 1 for node, as
  ``train_model`` trains it) and ``train/<family>/losses`` [20]; the latent
  ODE's segment runs on ``build_history_windows`` of those rows and draws its
  IWAE noise as ``train_latent_ode`` does, one split of the key per update
  (``train/latent_ode/eps`` [20, 3, 16, 5]);
- ``jax_returns``: the JAX package's 20-seed returns on this cell, as recorded
  in ``artifacts/results_full_r5.jsonl`` and ``artifacts/results_rnn_20seeds.jsonl``
  (taken on a TPU), and ``meta``: commit, command, JAX version, seconds.

    JAX_PLATFORMS=cpu python scripts/port_jax_baselines_reference.py --table

writes ``artifacts/port/jax_baselines_table.npz`` instead, the forward
reference of every tracked family checkpoint (``TABLE_CHECKPOINTS``: rnn on
pendulum d0 and d1, delta_t_rnn, node and latent_ode on the three envs at
delays 0-3; 38 files), which phase ``baselines`` holds the card's f32
forwards to:

- ``inputs/<env>/{obs,abuf,ts}``: 256 seeded queries on the env's shapes in
  f32, obs ~ N(0, 1), action buffers ~ U(-high, high) [256, 4, m], ``ts`` =
  dt; ``latent_ode/<env>/z0``: the latent ODE's apply draw at 256 rows (f64);
- ``out/<family>/<env>/<delay>``: the f64 ``apply`` of the checkpoint;
  ``n_acc/<env>/<delay>``: each row's accepted dopri5 steps in the latent
  ODE's forward;
- ``meta``: commit, command, JAX version, seconds, and each checkpoint's path
  and sha256, keyed ``"<env>/<delay>/<family>"``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neurallaplacecontrol_tpu.config import Config  # noqa: E402
from neurallaplacecontrol_tpu.models import make_model  # noqa: E402
from neurallaplacecontrol_tpu.models.common import mlp_apply_tanh  # noqa: E402
from neurallaplacecontrol_tpu.models.latent_ode import make_carried_dynamics  # noqa: E402
from neurallaplacecontrol_tpu.ops.integrate import odeint_dopri5_with_stats  # noqa: E402
from neurallaplacecontrol_tpu.training.train import make_optimizer, make_train_segment_fn  # noqa: E402
from neurallaplacecontrol_tpu.training.train_latent_ode import build_history_windows  # noqa: E402
from neurallaplacecontrol_tpu.utils.checkpoint import load_pytree, model_checkpoint_name  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "artifacts", "port", "jax_baselines_pendulum_d1.npz")
TABLE_OUT = os.path.join(ROOT, "artifacts", "port", "jax_baselines_table.npz")
ENVS = ("oderl-pendulum", "oderl-cartpole", "oderl-acrobot")
ENV_SHAPES = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
TRAIN_REFERENCE = os.path.join(ROOT, "artifacts", "port", "jax_train_pendulum_d1.npz")
ENV, DELAY, N_OBS, M, HIGH, DT = "oderl-pendulum", 1, 3, 1, 2.0, 0.05
FAMILIES = ("rnn", "delta_t_rnn", "node", "latent_ode")
ROWS, A, HORIZON, TRACE_ROWS = 1000, 4, 40, 100
UPDATES, BATCH = 20, 16
LATENTS = N_OBS + 2
TABLE_CHECKPOINTS = ([("rnn", ENV, d) for d in (0, 1)]
                     + [(f, e, d) for f in ("delta_t_rnn", "node", "latent_ode") for e in ENVS for d in range(4)])
TABLE_ROWS = 256
RESULTS = {  # the JAX package's recorded 20-seed runs of this cell
    "artifacts/results_full_r5.jsonl": ("delta_t_rnn", "node", "latent_ode", "oracle", "random", "nl"),
    "artifacts/results_rnn_20seeds.jsonl": ("rnn",),
}


def checkpoint_path(family, env=ENV, delay=DELAY):
    return os.path.join(ROOT, "artifacts", "checkpoints", model_checkpoint_name(family, env, delay, "exp", 0, True))


def checkpoint(model, family, env=ENV, delay=DELAY):
    return load_pytree(checkpoint_path(family, env, delay), model.init(jax.random.PRNGKey(0)))


def z0_draw(rows, latents=LATENTS):
    """The latent ODE's apply draw: ``predict_diff`` splits PRNGKey(0) once."""
    return np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(0), 1)[0], (rows, latents),
                                        dtype=jnp.float64))


def accepted_steps(model, params, q, z0, m):
    """Each row's accepted dopri5 steps in the latent ODE's forward from
    z0 = z_mean + z_std * draw, as ``predict_diff`` decodes it."""
    rows, a = q[1].shape[:2]
    z_mean, z_std = model.encode_history(params, jnp.broadcast_to(q[0][:, None], (rows, a, q[0].shape[1])),
                                         q[1][..., :m])

    def n_acc(z, t):
        _, n = odeint_dopri5_with_stats(lambda y, _t: mlp_apply_tanh(params["dec_ode"], y), z[None],
                                        jnp.stack([jnp.zeros_like(t), t]), rtol=1e-3, atol=1e-4, max_steps=24)
        return n[0]

    return np.asarray(jax.jit(jax.vmap(n_acc))(z_mean + z_std * z0, q[2][:, 0]))


def table() -> int:
    """The forward reference of every tracked family checkpoint (the module
    docstring's ``--table``)."""
    t0 = time.perf_counter()
    cfg = Config()
    rng = np.random.default_rng(20261018)
    rec, queries, checkpoints = {}, {}, {}
    for env in ENVS:
        n, m, high = ENV_SHAPES[env]
        obs = rng.standard_normal((TABLE_ROWS, n)).astype(np.float32)
        abuf = rng.uniform(-high, high, (TABLE_ROWS, A, m)).astype(np.float32)
        ts = np.full((TABLE_ROWS, 1), DT, np.float32)
        rec.update({f"inputs/{env}/obs": obs, f"inputs/{env}/abuf": abuf, f"inputs/{env}/ts": ts,
                    f"latent_ode/{env}/z0": z0_draw(TABLE_ROWS, n + 2)})
        queries[env] = [jnp.asarray(x, jnp.float64) for x in (obs, abuf, ts)]
    models = {}  # one model (and one compiled apply) per (family, env): the delays differ in weights only
    for family, env, delay in TABLE_CHECKPOINTS:
        n, m, high = ENV_SHAPES[env]
        if (family, env) not in models:
            model = make_model(family, env, n, m, high, cfg, dtype=jnp.float64)
            models[(family, env)] = model, jax.jit(model.apply)
        model, apply = models[(family, env)]
        params = checkpoint(model, family, env, delay)
        rec[f"out/{family}/{env}/{delay}"] = np.asarray(apply(params, *queries[env]))
        if family == "latent_ode":
            rec[f"n_acc/{env}/{delay}"] = accepted_steps(model, params, queries[env], rec[f"latent_ode/{env}/z0"], m)
        path = checkpoint_path(family, env, delay)
        with open(path, "rb") as f:
            checkpoints[f"{env}/{delay}/{family}"] = {"path": os.path.relpath(path, ROOT),
                                                      "sha256": hashlib.sha256(f.read()).hexdigest()}
        print(f"{family} {env} d{delay}: max |out| {np.abs(rec[f'out/{family}/{env}/{delay}']).max():.4g}",
              flush=True)
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True).stdout.strip()
    meta = {"commit": commit, "command": "JAX_PLATFORMS=cpu python scripts/port_jax_baselines_reference.py --table",
            "jax_version": jax.__version__, "dt": DT, "rows": TABLE_ROWS, "checkpoints": checkpoints,
            "seconds": time.perf_counter() - t0}
    rec["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(TABLE_OUT, **rec)
    print(f"wrote {TABLE_OUT} ({os.path.getsize(TABLE_OUT) / 1e6:.2f} MB) in {meta['seconds']:.1f} s", flush=True)
    return 0


def jax_returns() -> dict:
    out = {}
    for rel, models in RESULTS.items():
        with open(os.path.join(ROOT, rel)) as f:
            for line in f:
                r = json.loads(line)
                if (r["env_name"], r["delay"], r["model_name"]) in {(ENV, DELAY, m) for m in models}:
                    out[r["model_name"]] = {"total_rewards": r["total_rewards"], "seeds": r["seeds"], "file": rel}
    return out


def main() -> int:
    t0 = time.perf_counter()
    cfg = Config()
    rng = np.random.default_rng(20261017)
    rec = {}
    obs = rng.standard_normal((ROWS, N_OBS)).astype(np.float32)
    abuf = rng.uniform(-HIGH, HIGH, (ROWS, A, M)).astype(np.float32)
    ts = np.full((ROWS, 1), DT, np.float32)
    rec.update({"inputs/obs": obs, "inputs/abuf": abuf, "inputs/ts": ts})
    q = [jnp.asarray(x, jnp.float64) for x in (obs, abuf, ts)]
    models, params = {}, {}
    for family in FAMILIES:
        models[family] = make_model(family, ENV, N_OBS, M, HIGH, cfg, dtype=jnp.float64)
        params[family] = checkpoint(models[family], family)
        rec[f"out/{family}"] = np.asarray(jax.jit(models[family].apply)(params[family], *q))
        print(f"{family}: forward done, max |out| {np.abs(rec[f'out/{family}']).max():.4g}", flush=True)

    # the latent ODE: the forward's draw, each row's accepted steps, decoder_nfes
    lode, lp = models["latent_ode"], params["latent_ode"]
    z0 = z0_draw(ROWS)
    rec["latent_ode/z0"] = z0
    rec["latent_ode/n_acc"] = accepted_steps(lode, lp, q, z0, M)
    rec["latent_ode/nfes"] = np.asarray(lode.decoder_nfes(lp, *q))
    print(f"latent_ode: accepted steps {np.bincount(rec['latent_ode/n_acc'])}, nfes {rec['latent_ode/nfes']}",
          flush=True)

    # the carried dynamics over one horizon
    state0 = rng.standard_normal((ROWS, N_OBS)).astype(np.float32)
    full = rng.uniform(-HIGH, HIGH, (ROWS, A - 1 + HORIZON, M)).astype(np.float32)
    rec.update({"carried/state0": state0, "carried/full": full})
    carry_init, dyn = make_carried_dynamics(lode, lp, DT, N_OBS, M, action_buffer_size=A)
    step = jax.jit(dyn)
    state = jnp.asarray(state0, jnp.float64)
    carry = carry_init(state)
    states = []
    for t in range(HORIZON):
        carry, state = step(carry, state, jnp.asarray(full[:, t:t + A], jnp.float64))
        states.append(np.asarray(state[:TRACE_ROWS], np.float32))
    rec["carried/final"] = np.asarray(state)
    rec["carried/states"] = np.stack(states)
    print("carried horizon done", flush=True)

    # 20-update training segments from each checkpoint
    with np.load(TRAIN_REFERENCE) as z:
        data = {k: np.asarray(z[f"data/{k}"], np.float64) for k in ("s0", "a0", "sn", "ts")}
    n_data = data["s0"].shape[0]
    jdata = [jnp.asarray(data[k]) for k in ("s0", "a0", "sn", "ts")]
    optimizer = make_optimizer(cfg)
    for family in ("rnn", "delta_t_rnn", "node"):
        bs = 1 if family == "node" else BATCH
        idx = rng.permutation(n_data)[: UPDATES * bs].reshape(UPDATES, bs)
        segment = make_train_segment_fn(models[family], optimizer)
        _, _, losses = segment(params[family], optimizer.init(params[family]), *jdata, jnp.asarray(idx))
        rec[f"train/{family}/batch_idx"] = idx
        rec[f"train/{family}/losses"] = np.asarray(losses)
        print(f"{family}: segment losses {np.asarray(losses)[[0, -1]]}", flush=True)
    hs, ha, tgt, tsm = build_history_windows(*jdata, A)
    idx = rng.permutation(hs.shape[0])[: UPDATES * BATCH].reshape(UPDATES, BATCH)

    @jax.jit
    def update(p, opt_state, k, i):
        loss, grads = jax.value_and_grad(lambda p_: lode.train_step(p_, k, hs[i], ha[i], tsm[i], tgt[i]))(p)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    # train_latent_ode's update: split the key, draw from the split-off key
    p, opt_state, key = lp, optimizer.init(lp), jax.random.PRNGKey(1)
    losses, eps = [], []
    for i in idx:
        key, k = jax.random.split(key)
        eps.append(np.stack([np.asarray(jax.random.normal(kk, (BATCH, LATENTS), dtype=jnp.float64))
                             for kk in jax.random.split(k, 3)]))
        p, opt_state, loss = update(p, opt_state, k, jnp.asarray(i))
        losses.append(float(loss))
    rec.update({"train/latent_ode/batch_idx": idx, "train/latent_ode/losses": np.asarray(losses),
                "train/latent_ode/eps": np.stack(eps)})
    print(f"latent_ode: segment losses {losses[0]:.6g} .. {losses[-1]:.6g}", flush=True)

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True).stdout.strip()
    meta = {"commit": commit, "command": "JAX_PLATFORMS=cpu python scripts/port_jax_baselines_reference.py",
            "jax_version": jax.__version__, "env": ENV, "delay": DELAY, "dt": DT, "rows": ROWS,
            "horizon": HORIZON, "updates": UPDATES, "batch": BATCH, "seconds": time.perf_counter() - t0}
    rec["jax_returns"] = np.asarray(json.dumps(jax_returns()))
    rec["meta"] = np.asarray(json.dumps(meta))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **rec)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in {meta['seconds']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--table", action="store_true",
                        help="write the forward reference of every tracked family checkpoint instead")
    sys.exit(table() if parser.parse_args().table else main())

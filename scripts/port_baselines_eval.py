"""The port's baseline families on the card, beyond what ``chip_smoke.py`` runs.

    python3 scripts/port_baselines_eval.py eval              # GPU: the latent ODE's full evaluation
    python3 scripts/port_baselines_eval.py eval_ref [cpu]    # latent_ode_ref's, from the reference .pt
    python3 scripts/port_baselines_eval.py planted [cpu]     # the checks of phase baselines, planted faults

``eval`` runs ``training.evaluate_policy`` for the latent ODE on the tracked
pendulum-d1 checkpoint, handed in whole so that it plans with carried
history (the JAX package's evaluation of it), over seeds 0-19 with 200
steps, K=1000 and T=40: the full protocol that ``chip_smoke.py`` phase
``baselines`` cuts to its first steps. It holds the mean return against the
JAX package's recorded 20-seed returns of the cell
(``artifacts/port/jax_baselines_pendulum_d1.npz``) under the rule of phase
``baselines``, |mean_port - mean_jax| <= 3 sqrt(s_jax^2 / 20 + s_port^2 / 20),
traces one seed-batched tick, and prints one ``latent_ode_eval {...}`` line.

``eval_ref`` imports the tracked reference checkpoint
(``artifacts/baseline_parity/ref_latent_ode_cartpole_d1_r4.pt``) through
``interop`` and runs ``evaluate_policy("latent_ode_ref", ...)`` on cartpole
d1 twice: at the full protocol (seeds 0-19, 200 steps, K=1000, T=40), which
``chip_smoke.py`` phase ``precision`` cuts to its first steps and for which
no JAX run exists, and at the protocol of the JAX package's record of the
same file (seeds 0-4, K=200, T=20; the ``"harness": "ours"`` lines of
``artifacts/baseline_parity/ref_eval_results.jsonl``), held to that record by
the same 3-sigma rule. It prints one ``latent_ode_ref_eval {...}`` line per
run, one traced tick with the first.

``planted`` runs phase ``baselines``'s checks against JAX's f64 reference on
copies of the port with one fault planted per family (in a temporary
directory; the checkout is not touched), then the f64 training segments
with the learning rate 10% off, and prints one JSON line per run: the
readings that show the limits catch each fault.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# one fault per family, as text replaced in a copy of the port
FAULTS = {
    "sound": ("", "", ""),
    # rnn: the observation enters the head raw (delta_t_rnn's branch untouched)
    "rnn_obs_unnormalized": ("models/rnn.py", "torch.cat([h, obs_n], dim=-1))", "torch.cat([h, obs], dim=-1))"),
    # delta_t_rnn: the horizon not divided by dt * 8
    "delta_t_rnn_horizon_unnormalized": ("models/rnn.py", "            ts = ts / (dt * 8.0)\n", "            pass\n"),
    # node: Euler substeps of 0.049 where the reference takes 0.05
    "node_substep_0.049": ("models/node.py", "_STEP_SIZE = 0.05 ", "_STEP_SIZE = 0.049 "),
    # latent_ode: one dopri5 tableau entry 1% off (a_32)
    "dopri5_a32_1pct": ("ops/integrate.py", "    (3 / 40, 9 / 40),", "    (3 / 40, 9 / 40 * 1.01),"),
}

CHECK = """
import json, sys, torch
sys.path.insert(0, {port!r})
sys.path.insert(1, {root!r})
if {device!r} == "cpu":
    torch.cuda.synchronize = lambda *a, **k: None
import chip_smoke
import neurallaplacecontrol_tpu_torch as port
assert port.__file__.startswith({port!r}), port.__file__
torch.backends.cuda.matmul.allow_tf32 = False
ref = chip_smoke.read_jax_baselines_reference()
print(json.dumps(chip_smoke.baseline_forwards(ref, torch.device({device!r}))))
"""


def planted(device: str = "cuda") -> None:
    import torch

    import neurallaplacecontrol_tpu_torch as port

    card = chip_smoke.nvidia_smi() if device == "cuda" else "cpu"
    for fault, (rel, old, new) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            dst = os.path.join(tmp, "neurallaplacecontrol_tpu_torch")
            shutil.copytree(os.path.join(ROOT, "neurallaplacecontrol_tpu_torch"), dst,
                            ignore=shutil.ignore_patterns("__pycache__"))
            os.symlink(os.path.join(ROOT, "artifacts"), os.path.join(tmp, "artifacts"))  # the checkpoints
            if rel:
                path = os.path.join(dst, rel)
                text = open(path).read()
                if old not in text:
                    raise RuntimeError(f"fault {fault}: {old!r} is not in {rel}")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
            code = CHECK.format(port=tmp, root=ROOT, device=device)
            out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp)
            if out.returncode != 0:
                raise RuntimeError(f"fault {fault}: the check failed to run:\n{out.stderr[-3000:]}")
            forwards = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"mode": "planted", "fault": fault, "device": card, "limit": chip_smoke.BASELINE_FORWARD_TOL,
                          "rel_err": {f: r["rel_err"] for f, r in forwards.items()},
                          "latent_ode": {k: forwards["latent_ode"][k] for k in
                                         ("steps_differ_share", "rel_err_all_rows", "nfes", "jax_nfes",
                                          "carried_final_rel_err", "carried_steps_rel_err")}}), flush=True)
    if device == "cpu":
        torch.cuda.synchronize = lambda *a, **k: None
    ref = chip_smoke.read_jax_baselines_reference()
    dev = torch.device(device)
    for name, cfg in (("sound", port.Config()), ("learning_rate_1.1e-4", port.Config(learning_rate=1.1e-4))):
        segs = chip_smoke.baseline_segments(ref, dev, config=cfg)
        print(json.dumps({"mode": "segments_f64", "run": name, "device": card,
                          "limit": chip_smoke.BASELINE_SEGMENT_LIMIT,
                          "update_loss_rel_gap": {f: r["update_loss_rel_gap"] for f, r in segs.items()}}), flush=True)


def evaluate() -> None:
    import torch

    import neurallaplacecontrol_tpu_torch as port
    from neurallaplacecontrol_tpu_torch.training import EpisodeSettings, SeedDraws, evaluate_policy, make_episode_fn
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner

    device = torch.device("cuda")  # raises without a GPU
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi()
    ref = chip_smoke.read_jax_baselines_reference()
    model, params = chip_smoke.load_family("latent_ode", device)
    seeds = chip_smoke.EVAL_SEEDS
    t0 = time.perf_counter()
    r = evaluate_policy("latent_ode", chip_smoke.BASELINE_ENV, chip_smoke.DELAY, seeds, port.Config(),
                        model_apply=model, params=params, roll_outs=chip_smoke.K, time_steps=chip_smoke.T,
                        device=device)
    wall = time.perf_counter() - t0
    env, mppi_cfg, mppi_params, dynamics, carry_init, _ = build_planner(
        "latent_ode", chip_smoke.BASELINE_ENV, chip_smoke.DELAY, port.Config(), model_apply=model, params=params,
        roll_outs=chip_smoke.K, time_steps=chip_smoke.T, device=device)
    tick = make_episode_fn(env, dynamics, mppi_cfg, mppi_params,
                           EpisodeSettings(delay=chip_smoke.DELAY, n_steps=1), dynamics_carry_init=carry_init)
    trace = chip_smoke.trace_ticks(lambda: tick(SeedDraws(seeds, device=device))[0].cpu(), 1,
                                   1e3 * r["episode_elapsed_time"] / chip_smoke.EVAL_STEPS)
    got = np.asarray(r["total_rewards"])
    jax_ret = np.asarray(ref["jax_returns"]["latent_ode"]["total_rewards"])
    n = len(seeds)
    gap = abs(float(got.mean() - jax_ret.mean()))
    limit = 3.0 * math.sqrt(jax_ret.var(ddof=1) / n + got.var(ddof=1) / n)
    out = {"family": "latent_ode", "env": chip_smoke.BASELINE_ENV, "delay": chip_smoke.DELAY, "K": chip_smoke.K,
           "T": chip_smoke.T, "steps": chip_smoke.EVAL_STEPS, **chip_smoke.policy_stats(r),
           "total_rewards": r["total_rewards"], "jax_mean": float(jax_ret.mean()), "jax_std": float(jax_ret.std()),
           "gap_to_jax": gap, "limit": limit, "within_limit": gap <= limit, "wall_s": wall, "trace": trace,
           "card": card}
    print("latent_ode_eval " + json.dumps(out), flush=True)
    if not all(math.isfinite(x) for x in r["total_rewards"]):
        raise RuntimeError("non-finite return")
    if not gap <= limit:
        raise RuntimeError(f"latent_ode mean return is {gap:.3f} from the JAX package's, over {limit:.3f}")


def evaluate_ref(device: str = "cuda") -> None:
    import torch

    import neurallaplacecontrol_tpu_torch as port
    from neurallaplacecontrol_tpu_torch import interop
    from neurallaplacecontrol_tpu_torch.training import EpisodeSettings, SeedDraws, evaluate_policy, make_episode_fn
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.nvidia_smi() if device == "cuda" else "cpu"
    env_name, delay = chip_smoke.MAIN_ENV, chip_smoke.DELAY
    sd = interop.load_torch_state_dict(str(chip_smoke.REF_LATENT_ODE_PT))
    arch = interop.latent_ode_arch_from_state_dict(sd)
    cfg = port.Config(latent_ode_hidden_units=arch["hidden_units"])
    model = port.make_model("latent_ode_ref", env_name, arch["state_dim"], arch["action_dim"],
                            port.make_env(env_name).spec.action_high, cfg, device=device)
    params = interop.latent_ode_params_from_state_dict(sd, device=device, dtype=torch.float32)
    record = os.path.join(ROOT, "artifacts", "baseline_parity", "ref_eval_results.jsonl")
    with open(record) as f:
        jax_lines = [json.loads(line) for line in f if line.strip()]
    jax_lines = [r for r in jax_lines if r.get("harness") == "ours" and r["model_name"] == "latent_ode_ref"
                 and r["env_name"] == env_name and r["delay"] == delay]
    runs = [("full", chip_smoke.EVAL_SEEDS, chip_smoke.K, chip_smoke.T, None),
            ("jax_record", [r["seed"] for r in jax_lines], jax_lines[0]["roll_outs"], jax_lines[0]["time_steps"],
             np.asarray([r["total_reward"] for r in jax_lines]))]
    failures = []
    for name, seeds, k, t, jax_ret in runs:
        t0 = time.perf_counter()
        r = evaluate_policy("latent_ode_ref", env_name, delay, seeds, cfg, model_apply=model.apply, params=params,
                            roll_outs=k, time_steps=t, device=device)
        out = {"run": name, "env": env_name, "delay": delay, "K": k, "T": t, "seeds": seeds,
               "steps": chip_smoke.EVAL_STEPS, "mean": r["total_reward"], "std": r["total_reward_std"],
               "total_rewards": r["total_rewards"], "episode_batch_s": r["episode_elapsed_time"],
               "tick_ms": 1e3 * r["episode_elapsed_time"] / chip_smoke.EVAL_STEPS,
               "wall_s": time.perf_counter() - t0, "card": card}
        if name == "full":
            env, mppi_cfg, mppi_params, dynamics, _, _ = build_planner(
                "latent_ode_ref", env_name, delay, cfg, model_apply=model.apply, params=params, roll_outs=k,
                time_steps=t, device=device)
            tick = make_episode_fn(env, dynamics, mppi_cfg, mppi_params, EpisodeSettings(delay=delay, n_steps=1))
            out["trace"] = chip_smoke.trace_ticks(lambda: tick(SeedDraws(seeds, device=device))[0].cpu(), 1,
                                                  out["tick_ms"])
        else:
            gap, limit = chip_smoke.three_sigma(r["total_rewards"], jax_ret)
            out.update(jax_mean=float(jax_ret.mean()), jax_std=float(jax_ret.std()), gap_to_jax=gap, limit=limit)
            if not gap <= limit:
                failures.append(f"latent_ode_ref at the record's protocol: {gap:.1f} from JAX's, over {limit:.1f}")
        print("latent_ode_ref_eval " + json.dumps(out), flush=True)
        if not all(math.isfinite(x) for x in r["total_rewards"]):
            failures.append(f"latent_ode_ref {name}: non-finite return")
    if failures:
        raise RuntimeError("; ".join(failures))


if __name__ == "__main__":
    modes = {"eval": evaluate, "eval_ref": evaluate_ref, "planted": planted}
    if len(sys.argv) not in (2, 3) or sys.argv[1] not in modes:
        sys.exit(f"usage: {sys.argv[0]} {{eval|eval_ref|planted}} [device]")
    modes[sys.argv[1]](*sys.argv[2:])

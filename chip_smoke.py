#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``neurallaplacecontrol_tpu_torch``
from ``neurallaplacecontrol_tpu_torch/csrc`` with ``nvcc``, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives the
port's main path: the NL serving controller (``serving.make_controller``) for
cartpole with delay 1, K=1000 rollouts, horizon T=40 and the trained weights
of ``artifacts/checkpoints/``, in closed loop with the port's own plant.
Then it closes the main path: ``training.eval.evaluate_policy`` runs the
random policy, the oracle and the fused NL planner over seeds 0-19 of the
same cell (200 steps, the 20 seeds in lockstep, so each horizon step is one
forward launch of 20 x 1000 rows), scores NL against that run's own oracle
and random returns, and holds NL's mean return against the JAX package's
run of the same cell (``artifacts/port/jax_eval_cartpole_d1.json``, made by
``scripts/port_jax_reference.py``). Last, ``data.collector`` collects 20
oracle episodes with exploration noise on pendulum d1 into a temporary
directory and reads the buffer back.

Every phase prints ``phase <name> start`` and ``phase <name> done <seconds>``.
Any failure raises, and the script exits non-zero. The last three lines are
the kernels' record (one JSON object), the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``.

The script imports nothing of JAX; it needs the repository around it and
one CUDA device, and fails without either.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.data import collect_expert_data, load_replay_buffer, replay_buffer_filename
from neurallaplacecontrol_tpu_torch.envs import env_step, make_env
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.ops import nl_cuda, pallas_ilt, pallas_nl
from neurallaplacecontrol_tpu_torch.results import mean_confidence_interval, normalized_scores
from neurallaplacecontrol_tpu_torch.training import EpisodeSettings, SeedDraws, evaluate_policy, make_episode_fn
from neurallaplacecontrol_tpu_torch.training.eval import build_planner
from neurallaplacecontrol_tpu_torch.utils.checkpoint import (
    load_pytree,
    model_checkpoint_name,
    resolve_checkpoint,
)

ROOT = Path(__file__).resolve().parent
ENVS = ("oderl-pendulum", "oderl-cartpole", "oderl-acrobot")
MAIN_ENV = "oderl-cartpole"
DELAY = 1
K, T = 1000, 40  # rollouts and horizon of the main path (Config defaults)
TICKS = 200  # closed-loop controller ticks
REPLAY_TICKS = 10  # ticks replayed through the plain forward
# |got - exp| / (1 + |exp|), the metric of tests/test_pallas_nl.py:37-40, held
# ten times tighter than those tests' 1e-2: cartpole's state differences are
# ~0.03-0.5, so 1e-2 would pass a wrong kernel
KERNEL_TOL = 1e-3
ACTION_TOL = 0.05  # env units (cartpole acts in [-3, 3]): kernel vs plain controller
TIMED_LAUNCHES = 50
TRACE_TICKS = 5  # controller ticks under torch.profiler
EVAL_SEEDS = list(range(20))  # the paper's 20 seeds per cell
EVAL_STEPS = 200  # int(10 / dt): 10-second episodes
SEED_ROWS = len(EVAL_SEEDS) * K  # forward rows per launch in the evaluation
TRACE_EVAL_TICKS = 3  # seed-batched episode ticks under torch.profiler
JAX_REFERENCE = ROOT / "artifacts" / "port" / "jax_eval_cartpole_d1.json"
COLLECT_ENV, COLLECT_EPISODES = "oderl-pendulum", 20
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (NVIDIA data sheet)
SPLIT_PASSES = 3  # split TF32: hi*hi + hi*lo + lo*hi per product
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s


@contextmanager
def phase(name: str):
    print(f"phase {name} start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"phase {name} done {time.perf_counter() - t0:.3f}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rel_err(got: torch.Tensor, exp: torch.Tensor) -> float:
    return float(((got - exp).abs() / (1.0 + exp.abs())).max())


def time_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one call of ``fn``, by CUDA events over ``n`` calls."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one call of ``fn``, with ``n`` calls captured in one
    CUDA graph: the host's launch gaps between calls drop out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bounds(gemm_flops: float, other_flops: float, nbytes: float) -> dict:
    """The least time the card could take, each the larger of an operations
    time and the bytes time: the f32 bound (every FLOP at the f32 rate) and
    the tensor-core bound (every matrix product's FLOPs three times at the
    TF32 rate, as split TF32 needs, the rest at the f32 rate). Both count the
    function's work, whatever unit the kernel runs each product on."""
    t_bytes = nbytes / HBM_RATE
    t_f32 = (gemm_flops + other_flops) / F32_PEAK
    t_tc = SPLIT_PASSES * gemm_flops / TF32_PEAK + other_flops / F32_PEAK
    return {"bound_ms": 1e3 * max(t_f32, t_bytes), "bound_by": "operations" if t_f32 >= t_bytes else "bytes",
            "bound_tc_ms": 1e3 * max(t_tc, t_bytes), "bound_tc_by": "operations" if t_tc >= t_bytes else "bytes"}


def forward_cost(B, n, A, in_dim, H, hid, D, terms, packed) -> tuple[float, float, float]:
    """FLOPs of the forward's matrix products, its other FLOPs, and the bytes
    it needs (multiply-adds as 2 FLOPs; transcendentals and the gates'
    elementwise work not counted)."""
    gemm = (
        A * 3 * H * (in_dim + 3 * H)  # two GRU layers, input and hidden products
        + 2 * H  # encoder head
        + hid * (n + 2) + hid * hid  # trunk
        + 2 * hid * D * terms  # theta/phi head, live columns
    )
    other = 2 * D * terms  # fourier combine
    nbytes = 4 * (B * (n + A * in_dim + D) + sum(p.numel() for p in packed))
    return 2.0 * B * gemm, 2.0 * B * other, nbytes


def head_cost(B, Hx, D, terms, packed) -> tuple[float, float, float]:
    nbytes = 4 * (B * (Hx + D) + sum(p.numel() for p in packed))
    return 2.0 * B * 2 * Hx * D * terms, 2.0 * B * 2 * D * terms, nbytes


def load_nl(env_name: str, device):
    env = make_env(env_name)
    spec = env.spec
    params = load_pytree(
        resolve_checkpoint(model_checkpoint_name("nl", env_name, DELAY, "exp", 0, True)),
        device=device,
    )
    model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, port.Config(),
                       device=device)
    return env, params, model


def check_kernels(device) -> dict:
    """Each kernel against its plain version on all three envs at B=K."""
    records = {"nl_forward": [], "nl_head": []}
    terms = port.Config().nl_s_recon_terms
    for i, env_name in enumerate(ENVS):
        env, params, model = load_nl(env_name, device)
        spec = env.spec
        fused = model.make_fused_planner_apply(params, port.Config().dt)
        packed = fused.packed
        n, in_dim, A = spec.n_obs, spec.m, port.Config().action_buffer_size
        # seeded inputs drawn as tests/test_pallas_nl.py draws them; the head's
        # input is a hidden state in the trunk's tanh range
        rng = np.random.default_rng(3 + i)
        obs = torch.tensor(rng.standard_normal((K, n)), dtype=torch.float32, device=device)
        acts = torch.tensor(
            rng.uniform(-spec.action_high, spec.action_high, (K, A * in_dim)),
            dtype=torch.float32, device=device,
        )
        hid = packed[13].shape[0]
        x = torch.tensor(np.tanh(rng.standard_normal((K, hid))), dtype=torch.float32, device=device)
        head = packed[15:]
        head_hopper = torch.as_tensor(pallas_ilt.repack_head(head, n, terms), device=device)

        got = pallas_nl.nl_forward_fused(obs, acts, packed, n, in_dim, terms=terms, hopper=fused.hopper)
        exp = pallas_nl.nl_forward_plain(obs, acts, packed, n, in_dim)
        got_h = pallas_ilt.nl_head_fused(x, head, n, terms=terms, hopper=head_hopper)
        exp_h = pallas_ilt.nl_head_plain(x, head, n)
        torch.cuda.synchronize()
        for name, g, e in (("nl_forward", got, exp), ("nl_head", got_h, exp_h)):
            if g.shape != (K, n) or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{name} on {env_name}: shape {tuple(g.shape)} or non-finite output")
            rel = rel_err(g, e)
            if not rel < KERNEL_TOL:
                raise RuntimeError(f"{name} on {env_name}: relative error {rel:.3e} >= {KERNEL_TOL}")
            rec = {"env": env_name, "max_abs_err": float((g - e).abs().max()), "max_rel_err": rel,
                   "mean_abs_exp": float(e.abs().mean())}
            if env_name == MAIN_ENV:  # time at the main path's shapes
                if name == "nl_forward":
                    kernel = partial(pallas_nl.nl_forward_fused, obs, acts, packed, n, in_dim,
                                     terms=terms, hopper=fused.hopper)
                    plain = partial(pallas_nl.nl_forward_plain, obs, acts, packed, n, in_dim)
                    cost = forward_cost(K, n, A, in_dim, packed[1].shape[0], hid, n, terms, packed)
                else:
                    kernel = partial(pallas_ilt.nl_head_fused, x, head, n, terms=terms,
                                     hopper=head_hopper)
                    plain = partial(pallas_ilt.nl_head_plain, x, head, n)
                    cost = head_cost(K, hid, n, terms, head)
                rec["ms"], rec["plain_ms"] = graph_ms(kernel), graph_ms(plain)
                rec["eager_ms"], rec["plain_eager_ms"] = time_ms(kernel), time_ms(plain)
                rec.update(bounds(*cost))
                rec["smem_bytes"] = nl_cuda.smem_bytes(name, (
                    (K, n, A, in_dim, packed[1].shape[0], hid, n, terms, fused.hopper.numel())
                    if name == "nl_forward" else (K, hid, n, terms, head_hopper.numel())))
                # the kernel's share of the tighter of its bounds
                tight = min(("bound_ms", "bound_tc_ms"), key=rec.get)
                rec["bound_share"], rec["bound_share_of"] = rec[tight] / rec["ms"], tight
            records[name].append(rec)
            print(f"kernel {name} {env_name}: " + json.dumps(rec), flush=True)
    return records


def check_forward_seed_batch(device) -> dict:
    """The forward on cartpole at the evaluation's S*K = 20,000 rows against
    its plain version, with its graph-timed ms and bounds at that size."""
    env, params, model = load_nl(MAIN_ENV, device)
    spec = env.spec
    terms, A = port.Config().nl_s_recon_terms, port.Config().action_buffer_size
    fused = model.make_fused_planner_apply(params, port.Config().dt)
    packed, n, in_dim = fused.packed, spec.n_obs, spec.m
    rng = np.random.default_rng(20)
    obs = torch.tensor(rng.standard_normal((SEED_ROWS, n)), dtype=torch.float32, device=device)
    acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high, (SEED_ROWS, A * in_dim)),
                        dtype=torch.float32, device=device)
    kernel = partial(pallas_nl.nl_forward_fused, obs, acts, packed, n, in_dim, terms=terms, hopper=fused.hopper)
    plain = partial(pallas_nl.nl_forward_plain, obs, acts, packed, n, in_dim)
    got, exp = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != (SEED_ROWS, n) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"nl_forward at B={SEED_ROWS}: shape {tuple(got.shape)} or non-finite output")
    rel = rel_err(got, exp)
    if not rel < KERNEL_TOL:
        raise RuntimeError(f"nl_forward at B={SEED_ROWS}: relative error {rel:.3e} >= {KERNEL_TOL}")
    rec = {"env": MAIN_ENV, "B": SEED_ROWS, "max_abs_err": float((got - exp).abs().max()), "max_rel_err": rel,
           "ms": graph_ms(kernel, 20), "plain_ms": graph_ms(plain, 5)}
    hid = packed[13].shape[0]
    rec.update(bounds(*forward_cost(SEED_ROWS, n, A, in_dim, packed[1].shape[0], hid, n, terms, packed)))
    tight = min(("bound_ms", "bound_tc_ms"), key=rec.get)
    rec["bound_share"], rec["bound_share_of"] = rec[tight] / rec["ms"], tight
    print("kernel nl_forward seed batch: " + json.dumps(rec), flush=True)
    return rec


def trace_ticks(run, n_ticks: int, tick_ms: float) -> dict:
    """``run()`` (``n_ticks`` ticks that end on the host) under
    ``torch.profiler``: the device's busy time per tick, the forward kernel's
    share of it, and the device operations per tick. Busy time is the union
    of the traced device intervals; the idle share divides it by
    ``tick_ms``, the untraced tick, since the profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_ticks
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"ticks": n_ticks, "traced_tick_ms": wall_ms, "device_ops_per_tick": len(ops) / n_ticks}
    if not ops:  # the profiler saw no device activity: nothing to report
        return {**out, "device_busy_ms_per_tick": None, "idle_share": None}
    busy_us, end_us = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    fwd = [e for e in ops if "nl_forward_kernel" in e.name]
    busy_ms = busy_us / 1e3 / n_ticks
    return {
        **out,
        "device_busy_ms_per_tick": busy_ms,
        "idle_share": 1.0 - busy_ms / tick_ms,
        "nl_forward_launches_per_tick": len(fwd) / n_ticks,
        "nl_forward_ms_per_tick": sum(e.time_range.elapsed_us() for e in fwd) / 1e3 / n_ticks,
    }


def trace_controller(ctrl, state, obs, tick_ms: float) -> dict:
    """``TRACE_TICKS`` controller ticks under ``trace_ticks``."""

    def run():
        nonlocal state
        for _ in range(TRACE_TICKS):
            action, state = ctrl.step(state, obs)
            action.cpu()

    return trace_ticks(run, TRACE_TICKS, tick_ms)


def run_controller(device, smi: str) -> dict:
    """The main path: 200 closed-loop ticks through the fused kernel, then the
    first ticks replayed through the plain forward on the same noise."""
    env, params, model = load_nl(MAIN_ENV, device)
    spec = env.spec
    cfg = port.Config(fused_nl_planner=True)
    ctrl = port.make_controller("nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply,
                                params=params, roll_outs=K, time_steps=T, device=device)

    raw = env.reset(torch.Generator().manual_seed(0)).to(device)
    pending = [torch.zeros(spec.m, device=device) for _ in range(DELAY)]  # the plant's delay line
    total_reward = torch.zeros((), device=device)
    observations, actions, latencies = [], [], []

    pallas_nl.nl_forward_fused.launches = 0
    pallas_ilt.nl_head_fused.launches = 0
    state = ctrl.reset(seed=0)
    torch.cuda.synchronize()
    for tick in range(TICKS):
        t0 = time.perf_counter()
        obs = env.observe(raw)
        action, state = ctrl.step(state, obs)
        action_host = action.cpu()  # the plant's read of the action ends the tick
        latencies.append(time.perf_counter() - t0)
        if tick < REPLAY_TICKS:
            observations.append(obs.clone())
        actions.append(action_host)
        pending.append(action)
        executed = pending.pop(0)
        raw = env_step(env, raw, executed, spec.dt)
        total_reward = total_reward + env.reward_state(raw) + env.reward_action(executed)
    torch.cuda.synchronize()
    launches = {
        "nl_forward": pallas_nl.nl_forward_fused.launches,
        "nl_head": pallas_ilt.nl_head_fused.launches,
    }
    acts = torch.stack(actions)
    ret = float(total_reward)
    if not bool(torch.isfinite(acts).all()) or not math.isfinite(ret):
        raise RuntimeError(f"non-finite closed loop: return {ret}, actions finite "
                           f"{bool(torch.isfinite(acts).all())}")
    if float(acts.abs().max()) > spec.action_high + 1e-5:
        raise RuntimeError(f"action out of bounds: {float(acts.abs().max())}")
    if launches["nl_forward"] != TICKS * T:
        raise RuntimeError(f"nl_forward launched {launches['nl_forward']} times, expected {TICKS * T}")

    lat = np.asarray(latencies[1:])  # the first tick includes one-time set-up
    trace = trace_controller(ctrl, state, env.observe(raw), 1e3 * float(lat.mean()))
    print("trace " + json.dumps(trace), flush=True)

    # replay the first ticks through the plain forward on the same noise
    fused_apply = model.make_fused_planner_apply(params, cfg.dt)

    def plain_apply(_params, obs, window, _ts):
        return pallas_nl.nl_forward_plain(
            obs, window.reshape(window.shape[0], -1), fused_apply.packed, spec.n_obs, spec.m
        )

    ctrl_plain = port.make_controller("nl", MAIN_ENV, DELAY, cfg.replace(fused_nl_planner=False),
                                      model_apply=plain_apply, params=params, roll_outs=K,
                                      time_steps=T, device=device)
    state = ctrl_plain.reset(seed=0)
    replay, replay_latencies = [], []
    for obs in observations:
        t0 = time.perf_counter()
        action, state = ctrl_plain.step(state, obs)
        replay.append(action.cpu())
        replay_latencies.append(time.perf_counter() - t0)
    diff = float((torch.stack(replay) - acts[:REPLAY_TICKS]).abs().max())
    result = {
        "env": MAIN_ENV, "delay": DELAY, "K": K, "T": T, "ticks": TICKS, "return": ret,
        "tick_ms_mean": 1e3 * float(lat.mean()), "tick_ms_p50": 1e3 * float(np.median(lat)),
        "tick_ms_max": 1e3 * float(lat.max()), "ticks_per_s": float(1.0 / lat.mean()),
        "plain_tick_ms_mean": 1e3 * float(np.mean(replay_latencies[1:])),
        "replay_max_action_diff": diff, "launches": launches, "trace": trace, "card": smi,
    }
    print("controller " + json.dumps(result), flush=True)
    if not diff <= ACTION_TOL:
        raise RuntimeError(f"kernel and plain controllers differ by {diff} > {ACTION_TOL}")
    return result


def policy_stats(r: dict) -> dict:
    returns = np.asarray(r["total_rewards"])
    mean, ci = mean_confidence_interval(returns)
    return {"mean": mean, "std": float(returns.std()), "ci95": ci,
            "episode_batch_s": r["episode_elapsed_time"],
            "ticks_per_s": EVAL_STEPS / r["episode_elapsed_time"]}


def run_eval(device, smi: str) -> dict:
    """The main path's end: ``evaluate_policy`` for random, oracle and fused
    NL over 20 seeds in lockstep, the NL score against this run's baselines,
    and NL's mean return against the JAX package's run of the same cell."""
    ref = json.loads(JAX_REFERENCE.read_text())
    if (ref["env"], ref["delay"], ref["seeds"]) != (MAIN_ENV, DELAY, EVAL_SEEDS):
        raise RuntimeError(f"{JAX_REFERENCE} holds another cell: {ref['env']} d{ref['delay']}")
    env, params, model = load_nl(MAIN_ENV, device)
    cfg = port.Config(fused_nl_planner=True)

    pallas_nl.nl_forward_fused.launches = pallas_nl.nl_forward_fused.rows = 0
    pallas_ilt.nl_head_fused.launches = 0
    results = {name: evaluate_policy(name, MAIN_ENV, DELAY, EVAL_SEEDS, cfg, model_apply=model.apply,
                                     params=params, roll_outs=K, time_steps=T, device=device)
               for name in ("random", "oracle", "nl")}
    launches = {"nl_forward": pallas_nl.nl_forward_fused.launches,
                "nl_head": pallas_ilt.nl_head_fused.launches}
    rows_per_launch = pallas_nl.nl_forward_fused.rows / max(1, launches["nl_forward"])

    out = {"env": MAIN_ENV, "delay": DELAY, "K": K, "T": T, "steps": EVAL_STEPS, "seeds": len(EVAL_SEEDS),
           "launches": launches, "forward_rows_per_launch": rows_per_launch, "card": smi}
    for name, r in results.items():
        out[name] = policy_stats(r)
        jax_returns = np.asarray(ref["policies"][name]["total_rewards"])
        out[name]["jax_mean"], out[name]["jax_std"] = float(jax_returns.mean()), float(jax_returns.std())
    for agg in ("ci95", "std"):
        mean, spread, _ = normalized_scores(results.values(), agg=agg)[(DELAY, MAIN_ENV, "nl")]
        out[f"nl_normalized_{agg}"] = [mean, spread]
    # the acceptance check against the JAX package's run at HEAD on the CPU:
    # |mean_port - mean_jax| <= 3 sqrt(s_jax^2 / n + s_port^2 / n)
    port_nl = np.asarray(results["nl"]["total_rewards"])
    jax_nl = np.asarray(ref["policies"]["nl"]["total_rewards"])
    n = len(EVAL_SEEDS)
    gap = abs(float(port_nl.mean() - jax_nl.mean()))
    limit = 3.0 * math.sqrt(jax_nl.var(ddof=1) / n + port_nl.var(ddof=1) / n)
    _, jax_ci = mean_confidence_interval(jax_nl)
    out["nl_vs_jax"] = {"gap": gap, "limit": limit, "inside_jax_ci95": bool(gap <= jax_ci), "jax_ci95": float(jax_ci),
                        "jax_commit": ref["commit"]}

    # three seed-batched ticks of the same episode loop under torch.profiler
    env_t, mppi_cfg, mppi_params, dynamics = build_planner(
        "nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K, time_steps=T,
        device=device)
    ticks = make_episode_fn(env_t, dynamics, mppi_cfg, mppi_params,
                            EpisodeSettings(delay=DELAY, n_steps=TRACE_EVAL_TICKS))
    tick_ms = 1e3 * results["nl"]["episode_elapsed_time"] / EVAL_STEPS
    out["trace"] = trace_ticks(lambda: ticks(SeedDraws(EVAL_SEEDS, device=device))[0].cpu(),
                               TRACE_EVAL_TICKS, tick_ms)
    print("eval " + json.dumps(out), flush=True)

    returns = [x for r in results.values() for x in r["total_rewards"]]
    if not all(math.isfinite(x) for x in returns):
        raise RuntimeError("non-finite episode return in the evaluation")
    if not out["oracle"]["mean"] > out["random"]["mean"]:
        raise RuntimeError(f"oracle mean {out['oracle']['mean']} is not above random {out['random']['mean']}")
    # the episode's 200 ticks and evaluate_policy's one warm-up tick, T launches each
    expected = (EVAL_STEPS + 1) * T
    if launches["nl_forward"] != expected or rows_per_launch != SEED_ROWS:
        raise RuntimeError(f"nl_forward launched {launches['nl_forward']} times at {rows_per_launch} rows, "
                           f"expected {expected} at {SEED_ROWS}")
    if not gap <= limit:
        raise RuntimeError(f"NL mean return {port_nl.mean():.3f} is {gap:.3f} from the JAX run's "
                           f"{jax_nl.mean():.3f}, over the limit {limit:.3f}")
    return out


def run_collect(device) -> dict:
    """Expert collection: 20 oracle episodes with exploration noise on the
    exp grid, written under the cache key to a temporary directory and read
    back with ``load_replay_buffer``."""
    n = COLLECT_EPISODES * EVAL_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        cfg = port.Config(offline_datasets_path=tmp)
        t0 = time.perf_counter()
        collected = collect_expert_data(COLLECT_ENV, DELAY, cfg, collect_samples=n, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        path = Path(tmp) / replay_buffer_filename(COLLECT_ENV, DELAY)
        loaded = load_replay_buffer(path, device=device)
        nbytes = path.stat().st_size
    s0, a0, sn, ts = loaded
    out = {"env": COLLECT_ENV, "delay": DELAY, "episodes": COLLECT_EPISODES, "seconds": seconds,
           "file": path.name, "file_bytes": nbytes, "shapes": [list(x.shape) for x in loaded],
           "ts_mean": float(ts.mean()), "ts_std": float(ts.std())}
    print("collect " + json.dumps(out), flush=True)
    shapes = [(n, 3), (n, 4, 1), (n, 3), (n, 1)]
    if [tuple(x.shape) for x in loaded] != shapes:
        raise RuntimeError(f"collected shapes {out['shapes']}, expected {shapes}")
    if not all(torch.equal(a, b) for a, b in zip(loaded, collected)):
        raise RuntimeError("the buffer read back differs from the one collected")
    if not all(bool(torch.isfinite(x).all()) for x in loaded):
        raise RuntimeError("non-finite values in the collected buffer")
    if not float(ts.std()) > 0 or not float(ts.min()) > 0:
        raise RuntimeError("the collected step durations are not an irregular positive grid")
    return out


def kernels_line(records: dict, seed_batch: dict, launches: dict) -> dict:
    """One entry per kernel. The forward's times and bounds are at the
    evaluation's 20,000 rows, its launches the evaluation's; ``serving_tick``
    keeps its figures at the controller's 1,000 rows. The head is timed at
    1,000 rows, the shape of its check."""
    replaces = {
        "nl_forward": "neurallaplacecontrol_tpu/ops/pallas_nl.py:158",
        "nl_head": "neurallaplacecontrol_tpu/ops/pallas_ilt.py:113",
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "bound_tc_ms", "bound_tc_by", "bound_share",
             "bound_share_of")
    out = []
    for name, recs in records.items():
        small = next(r for r in recs if "ms" in r)  # the main env at B=1000
        main = small
        if name == "nl_forward":
            main, recs = seed_batch, recs + [seed_batch]
        serving = {"B": K, "launches": launches["controller"][name], "eager_ms": small["eager_ms"],
                   "plain_eager_ms": small["plain_eager_ms"], **{k: small[k] for k in timed}}
        out.append({
            "name": name,
            "route": "cuda",
            "source": "neurallaplacecontrol_tpu_torch/csrc/nl_kernels.cu",
            "replaces": replaces[name],
            "launches": launches["eval"][name],
            "B": SEED_ROWS if name == "nl_forward" else K,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "max_rel_err": max(r["max_rel_err"] for r in recs),
            **{k: main[k] for k in timed},
            "library_ms": None,
            "serving_tick": serving,
        })
    return {"kernels": out}


def main() -> int:
    t_start = time.perf_counter()
    pkg = Path(port.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"the port was imported from {pkg}, not from this checkout {ROOT}")

    with phase("device"):
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: this smoke run needs a GPU")
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        print(f"device {kind}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
              flush=True)

    with phase("build"):
        lib = nl_cuda.build()
        nl_cuda.library()
        log = (lib.parent / "build.log").read_text()
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) or "error" in line.lower():
                print("ptxas " + line.strip(), flush=True)

    with phase("kernels"):
        records = check_kernels(device)
        seed_batch = check_forward_seed_batch(device)

    with phase("controller"):
        result = run_controller(device, smi)

    with phase("eval"):
        evaluation = run_eval(device, smi)

    with phase("collect"):
        run_collect(device)

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    launches = {"controller": result["launches"], "eval": evaluation["launches"]}
    print(json.dumps(kernels_line(records, seed_batch, launches)), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

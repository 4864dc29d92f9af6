#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of ``neurallaplacecontrol_tpu_torch``
from ``neurallaplacecontrol_tpu_torch/csrc`` with ``nvcc``, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives the
port's main path: the NL serving controller (``serving.make_controller``) for
cartpole with delay 1, K=1000 rollouts, horizon T=40 and the trained weights
of ``artifacts/checkpoints/``, in closed loop with the port's own plant.

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
import time
from contextlib import contextmanager
from functools import partial
from pathlib import Path

import numpy as np
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.envs import env_step, make_env
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.ops import nl_cuda, pallas_ilt, pallas_nl
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
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet)
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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / F32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def forward_cost(B, n, A, in_dim, H, hid, D, terms, packed) -> tuple[float, float]:
    """f32 multiply-add FLOPs and bytes the forward needs (transcendentals not counted)."""
    per_row = (
        A * 3 * H * (in_dim + 3 * H)  # two GRU layers, input and hidden products
        + 2 * H  # encoder head
        + hid * (n + 2) + hid * hid  # trunk
        + 2 * hid * D * terms  # theta/phi head, live columns
        + 2 * D * terms  # fourier combine
    )
    nbytes = 4 * (B * (n + A * in_dim + D) + sum(p.numel() for p in packed))
    return 2.0 * B * per_row, nbytes


def head_cost(B, Hx, D, terms, packed) -> tuple[float, float]:
    per_row = 2 * Hx * D * terms + 2 * D * terms
    nbytes = 4 * (B * (Hx + D) + sum(p.numel() for p in packed))
    return 2.0 * B * per_row, nbytes


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

        got = pallas_nl.nl_forward_fused(obs, acts, packed, n, in_dim, terms=terms)
        exp = pallas_nl.nl_forward_plain(obs, acts, packed, n, in_dim)
        got_h = pallas_ilt.nl_head_fused(x, head, n, terms=terms)
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
                                     terms=terms)
                    plain = partial(pallas_nl.nl_forward_plain, obs, acts, packed, n, in_dim)
                    cost = forward_cost(K, n, A, in_dim, packed[1].shape[0], hid, n, terms, packed)
                else:
                    kernel = partial(pallas_ilt.nl_head_fused, x, head, n, terms=terms)
                    plain = partial(pallas_ilt.nl_head_plain, x, head, n)
                    cost = head_cost(K, hid, n, terms, head)
                rec["ms"], rec["plain_ms"] = graph_ms(kernel), graph_ms(plain)
                rec["eager_ms"], rec["plain_eager_ms"] = time_ms(kernel), time_ms(plain)
                rec["bound_ms"], rec["bound_by"] = bound_ms(*cost)
            records[name].append(rec)
            print(f"kernel {name} {env_name}: " + json.dumps(rec), flush=True)
    return records


def trace_ticks(ctrl, state, obs, tick_ms: float) -> dict:
    """Ticks under ``torch.profiler``: the device's busy time per tick, the
    forward kernel's share of it, and the device operations per tick. Busy
    time is the union of the traced device intervals; the idle share divides
    it by ``tick_ms``, the untraced tick, since the profiler slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACE_TICKS):
            action, state = ctrl.step(state, obs)
            action.cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / TRACE_TICKS
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"ticks": TRACE_TICKS, "traced_tick_ms": wall_ms, "device_ops_per_tick": len(ops) / TRACE_TICKS}
    if not ops:  # the profiler saw no device activity: nothing to report
        return {**out, "device_busy_ms_per_tick": None, "idle_share": None}
    busy_us, end_us = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in ops):
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
    fwd = [e for e in ops if "nl_forward_kernel" in e.name]
    busy_ms = busy_us / 1e3 / TRACE_TICKS
    return {
        **out,
        "device_busy_ms_per_tick": busy_ms,
        "idle_share": 1.0 - busy_ms / tick_ms,
        "nl_forward_launches_per_tick": len(fwd) / TRACE_TICKS,
        "nl_forward_ms_per_tick": sum(e.time_range.elapsed_us() for e in fwd) / 1e3 / TRACE_TICKS,
    }


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
    trace = trace_ticks(ctrl, state, env.observe(raw), 1e3 * float(lat.mean()))
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


def kernels_line(records: dict, launches: dict) -> dict:
    replaces = {
        "nl_forward": "neurallaplacecontrol_tpu/ops/pallas_nl.py:158",
        "nl_head": "neurallaplacecontrol_tpu/ops/pallas_ilt.py:113",
    }
    out = []
    for name, recs in records.items():
        main = next(r for r in recs if "ms" in r)
        out.append({
            "name": name,
            "route": "cuda",
            "source": "neurallaplacecontrol_tpu_torch/csrc/nl_kernels.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "max_rel_err": max(r["max_rel_err"] for r in recs),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "eager_ms": main["eager_ms"],
            "plain_eager_ms": main["plain_eager_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": None,
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
            if "registers" in line or "spill" in line or "error" in line.lower():
                print("ptxas " + line.strip(), flush=True)

    with phase("kernels"):
        records = check_kernels(device)

    with phase("controller"):
        result = run_controller(device, smi)

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(json.dumps(kernels_line(records, result["launches"])), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

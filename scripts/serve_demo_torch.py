"""Serving demo of the PyTorch port: per-tick controller latency, as a plant sees it.

    python scripts/serve_demo_torch.py [--ticks 300] [--model nl] [--env oderl-cartpole]
        [--delay 1] [--fused_nl_planner] [--export controller.pt2] [--cache_dir DIR]
        [--roll_outs 1000] [--time_steps 40] [--chained 100] [--ticklog PATH]
        [--device cuda|cpu]

Builds the serving controller (``neurallaplacecontrol_tpu_torch.serving``)
around the tracked checkpoint of ``artifacts/checkpoints/`` (a seeded init
where there is none), then runs the control loop: one observation in, one
action out, the action read back on the host each tick, the plant one Euler
step on the device. With ``--export`` the controller's step is exported to
that path (``serving.export_controller``), loaded back
(``serving.load_controller_step``) and the loop runs the loaded step: the
deployment path. ``--chained N`` issues N more ticks back to back with no
host wait between them and one synchronize at the end, the device-amortized
tick. ``--ticklog`` records ``[t_rel_s, tick_ms, action..., obs...]`` per
tick into the native ring log (``runtime.ticklog``; read it with ``python -m
neurallaplacecontrol_tpu_torch.runtime.ticklog PATH``), its epoch in a
``PATH.epoch`` file beside it. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ticks", type=int, default=300)
    p.add_argument("--model", default="nl")
    p.add_argument("--env", default="oderl-cartpole")
    p.add_argument("--delay", type=int, default=1)
    p.add_argument("--fused_nl_planner", action="store_true", help="plan NL through the forward kernel")
    p.add_argument("--export", default=None, help="export the step here and serve the loaded artifact")
    p.add_argument("--cache_dir", default=None, help="build the native libraries here (persistent_compile_cache)")
    p.add_argument("--roll_outs", type=int, default=None)
    p.add_argument("--time_steps", type=int, default=None)
    p.add_argument("--chained", type=int, default=100,
                   help="ticks issued back to back with one synchronize (device-amortized tick); 0 disables")
    p.add_argument("--ticklog", default=None, help="per-tick telemetry into this native ring log")
    p.add_argument("--ticklog_capacity", type=int, default=65536)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def open_ticklog(path: str, capacity: int, width: int):
    """(log, epoch_unix_s, base_s): the ring log, its epoch (kept in
    ``path.epoch`` so a restarted writer resuming the same ring keeps one
    timebase) and the seconds from the epoch to now."""
    from neurallaplacecontrol_tpu_torch.runtime.ticklog import TickLog

    log = TickLog.create(path, capacity, width)
    epoch_path = path + ".epoch"
    if os.path.exists(epoch_path) and log.count > 0:
        with open(epoch_path) as f:
            epoch = float(f.read())
    else:
        epoch = time.time()
        with open(epoch_path, "w") as f:
            f.write(repr(epoch))
    return log, epoch, time.time() - epoch


def control_loop(step, state, env, raw, ticks: int, delay: int, log=None, log_base_s: float = 0.0):
    """``ticks`` closed-loop ticks of ``step(state, obs) -> (action,
    state)``; returns (per-tick seconds, state, raw, the records appended to
    ``log``). A tick ends when its action is on the host; the executed
    action is the one planned ``delay`` ticks before, from the controller's
    buffer."""
    sync = torch.cuda.synchronize if raw.is_cuda else (lambda: None)
    lat, records = [], []
    t_log = time.perf_counter()
    for _ in range(ticks):
        obs = env.observe(raw)
        t0 = time.perf_counter()
        action, state = step(state, obs)
        action_host = action.cpu().numpy()
        tick_s = time.perf_counter() - t0
        lat.append(tick_s)
        if log is not None:
            records.append(np.concatenate([[log_base_s + time.perf_counter() - t_log, tick_s * 1e3], action_host,
                                           obs.cpu().numpy()]))
            log.append(records[-1])
        raw = raw + env.spec.dt * env.rhs(raw, state.action_buffer[-(delay + 1)])
    sync()
    return lat, state, raw, records


def chained_ms(step, state, obs, n: int) -> float:
    """Mean ms of ``n`` ticks issued back to back, one synchronize at the end."""
    sync = torch.cuda.synchronize if obs.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        _, state = step(state, obs)
    sync()
    return (time.perf_counter() - t0) * 1e3 / n


def build(args):
    """(controller, env, device): the demo's controller on the tracked checkpoint."""
    import neurallaplacecontrol_tpu_torch as port
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, tracked_checkpoint_path
    from neurallaplacecontrol_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = port.Config(fused_nl_planner=args.fused_nl_planner)
    env = port.make_env(args.env, dt=config.dt)
    spec = env.spec
    model_apply = params = None
    if args.model != "oracle":
        model = port.make_model(args.model, args.env, spec.n_obs, spec.m, spec.action_high, config, device=device)
        ckpt = tracked_checkpoint_path(model_checkpoint_name(args.model, args.env, args.delay, "exp", 0, True))
        if ckpt.is_file():
            params = load_pytree(ckpt, like=model.init(torch.Generator(device=device).manual_seed(0)))
            print(f"loaded checkpoint {ckpt}", file=sys.stderr)
        else:
            params = model.init(torch.Generator(device=device).manual_seed(0))
            print(f"WARNING: no checkpoint at {ckpt}; untrained params", file=sys.stderr)
        model_apply = model if args.model == "latent_ode" else model.apply
    ctrl = port.make_controller(args.model, args.env, args.delay, config, model_apply=model_apply, params=params,
                                roll_outs=args.roll_outs, time_steps=args.time_steps, device=device)
    return ctrl, env, device


def main(argv=None) -> dict:
    args = parse(argv)
    from neurallaplacecontrol_tpu_torch import serving

    if args.cache_dir:
        print(f"compile cache: {serving.persistent_compile_cache(args.cache_dir)}", file=sys.stderr)
    ctrl, env, device = build(args)
    spec = env.spec

    step, export_bytes, export_s = ctrl.step, None, None
    if args.export:
        t0 = time.perf_counter()
        blob = serving.export_controller(ctrl, path=args.export)
        export_s, export_bytes = time.perf_counter() - t0, len(blob)
        step = serving.load_controller_step(args.export, seed=42)
        print(f"exported {export_bytes} bytes to {args.export} in {export_s:.1f} s", file=sys.stderr)

    state = ctrl.reset(42)
    raw = env.reset(torch.Generator().manual_seed(7)).to(device)
    if spec.name == "pendulum":
        raw = torch.tensor([np.pi, 1.0], device=device)
    t0 = time.perf_counter()
    _, state, raw, _ = control_loop(step, state, env, raw, 1, args.delay)
    first_tick_s = time.perf_counter() - t0

    log, epoch = None, None
    if args.ticklog:
        log, epoch, base_s = open_ticklog(args.ticklog, args.ticklog_capacity, 2 + spec.m + spec.n_obs)
        print(f"tick log: {args.ticklog} (width {log.width}, epoch_unix_s {epoch:.3f})", file=sys.stderr)
    lat, state, raw, _ = control_loop(step, state, env, raw, args.ticks, args.delay, log, base_s if log else 0.0)
    lat_ms = np.asarray(lat) * 1e3
    log_count = None
    if log is not None:
        log.sync()
        log_count = log.count
        log.close()
    amortized = chained_ms(step, state, env.observe(raw), args.chained) if args.chained > 0 else None

    out = {
        "model": args.model, "env": args.env, "delay": args.delay,
        "roll_outs": ctrl.mppi_cfg.num_samples, "time_steps": ctrl.mppi_cfg.horizon,
        "fused_nl_planner": args.fused_nl_planner, "step": "exported" if args.export else "eager",
        "ticks": args.ticks, "first_tick_s": first_tick_s,
        "tick_ms_p50": float(np.percentile(lat_ms, 50)), "tick_ms_p90": float(np.percentile(lat_ms, 90)),
        "tick_ms_p99": float(np.percentile(lat_ms, 99)), "tick_ms_mean": float(lat_ms.mean()),
        "tick_ms_device_amortized": amortized, "chained": args.chained,
        "control_rate_hz": 1e3 / float(np.median(lat_ms)),
        "realtime_ok": bool(np.percentile(lat_ms, 99) < spec.dt * 1e3),
        "device": str(device), "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "export_bytes": export_bytes, "export_s": export_s,
        "ticklog": args.ticklog, "ticklog_epoch_unix_s": epoch, "ticklog_count": log_count,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

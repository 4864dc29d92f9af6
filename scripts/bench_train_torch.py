"""Training throughput on the GPU: updates/s of the NL flagship and the
latent ODE against the batch size (the port's counterpart of
``scripts/bench_train.py``, with its function names).

    python3 scripts/bench_train_torch.py [--models nl,latent_ode] [--batches 16,64,256]
        [--rows 1000000] [--segments 4] [--device cuda]

The measured unit is the training path the port runs: the segment functions
of ``training/train.py`` (``make_train_segment_fn``) and
``training/train_latent_ode.py`` (``make_latent_ode_segment_fn``), each a
loop of ``iters_per_log`` Adam updates, over a random table with the expert
replay's shapes (throughput depends on the shapes, not the values). The
first segment warms up and is not timed. Emits one JSON line per
measurement: ``model``, ``batch_size``, ``steps_per_sec``, ``sec_per_iter``,
``samples_per_sec``, ``table_rows``, ``seg_len``, ``segments_timed`` (the
JAX script's keys), ``device`` and ``power_limit_w``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def synth_table(generator, rows, n_obs, m, buf, device):
    """Random tensors with collect_expert_data's shapes: s0 [N, n], a0 [N,
    A, m], sn [N, n], ts [N, 1]."""
    kw = dict(generator=generator, device=device)
    return (torch.randn((rows, n_obs), **kw), torch.rand((rows, buf, m), **kw) * 2 - 1,
            torch.randn((rows, n_obs), **kw), 0.05 + 0.01 * torch.rand((rows, 1), **kw))


def _batches(generator, rows, segments, seg_len, batch_size, device):
    perm = torch.randperm(rows, generator=generator, device=device)
    return perm[: (segments + 1) * seg_len * batch_size].reshape(segments + 1, seg_len, batch_size)


def bench_nl(config, rows, batch_size, segments, env_name="oderl-cartpole", device="cuda"):
    """(updates/s, segment length) of NL training segments."""
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.training.train import make_optimizer, make_train_segment_fn

    spec = make_env(env_name, dt=config.dt).spec
    model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, config, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    params = model.init(g)
    optimizer = make_optimizer(config)
    state = optimizer.init(params)
    segment_fn = make_train_segment_fn(model, optimizer)
    table = synth_table(g, rows, spec.n_obs, spec.m, config.action_buffer_size, device)
    seg_len = config.iters_per_log
    batches = _batches(g, rows, segments, seg_len, batch_size, device)
    params, state, losses = segment_fn(params, state, *table, batches[0])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(1, segments + 1):
        params, state, losses = segment_fn(params, state, *table, batches[i])
    _sync(device)
    return seg_len * segments / (time.perf_counter() - t0), seg_len


def bench_latent_ode(config, rows, batch_size, segments, env_name="oderl-cartpole", device="cuda"):
    """(updates/s, segment length) of latent-ODE training segments on
    history windows, z0's noise drawn per update as train_latent_ode does."""
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.training.train import make_optimizer
    from neurallaplacecontrol_tpu_torch.training.train_latent_ode import make_latent_ode_segment_fn

    spec = make_env(env_name, dt=config.dt).spec
    model = make_model("latent_ode", env_name, spec.n_obs, spec.m, spec.action_high, config, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    params = model.init(g)
    optimizer = make_optimizer(config)
    state = optimizer.init(params)
    segment_fn = make_latent_ode_segment_fn(model, optimizer)
    A = config.action_buffer_size
    kw = dict(generator=g, device=device)
    hist_s, hist_a = torch.randn((rows, A, spec.n_obs), **kw), torch.rand((rows, A, spec.m), **kw) * 2 - 1
    target, ts = torch.randn((rows, spec.n_obs), **kw), torch.full((rows, 1), config.dt, device=device)
    seg_len = config.iters_per_log
    batches = _batches(g, rows, segments, seg_len, batch_size, device)
    latents = model.latents

    def eps():
        return torch.randn((seg_len, 3, batch_size, latents), **kw)

    params, state, losses = segment_fn(params, state, eps(), hist_s, hist_a, target, ts, batches[0])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(1, segments + 1):
        params, state, losses = segment_fn(params, state, eps(), hist_s, hist_a, target, ts, batches[i])
    _sync(device)
    return seg_len * segments / (time.perf_counter() - t0), seg_len


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", type=str, default="nl,latent_ode")
    ap.add_argument("--batches", type=str, default="16,64,256")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--iters_per_log", type=int, default=None, help="the segment length (Config's by default)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(args.device)
    where = card(device)
    rows_out = []
    for model_name in args.models.split(","):
        for bs in (int(b) for b in args.batches.split(",")):
            config = Config(training_batch_size=bs)
            if args.iters_per_log:
                config = config.replace(iters_per_log=args.iters_per_log)
            fn = {"nl": bench_nl, "latent_ode": bench_latent_ode}[model_name]
            rows = max(args.rows, (args.segments + 1) * config.iters_per_log * bs)
            steps_per_sec, seg_len = fn(config, rows, bs, args.segments, device=device)
            rows_out.append({"model": model_name, "batch_size": bs, "steps_per_sec": steps_per_sec,
                             "sec_per_iter": 1.0 / steps_per_sec, "samples_per_sec": steps_per_sec * bs,
                             "table_rows": rows, "seg_len": seg_len, "segments_timed": args.segments, **where})
            print(json.dumps(rows_out[-1]), flush=True)
    return rows_out


if __name__ == "__main__":
    main()

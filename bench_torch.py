"""Headline benchmark of the PyTorch/CUDA port: MPPI rollouts/s with the
flagship NL dynamics model in the planning loop, on one NVIDIA GPU (the
counterpart of ``bench.py``).

    python3 bench_torch.py [--device cuda] [--seeds 8]

One rollout is one of the K=1000 candidate trajectories that a plan
simulates over the T=40-step horizon. The measured episodes run the whole
closed-loop protocol: 200 env steps on cartpole with delay 1, each a full
MPPI plan of 40 sequential NL forwards over seeds x K rows, the seeds in
lockstep. They run through ``training.evaluate_policy``, the entry point
users call, with ``Config(fused_nl_planner=True)``, so each forward is one
launch of the hand-written CUDA kernel (``route: "kernel"``); the timed
region starts after the kernel build and a warm-up tick. The weights are the
tracked trained checkpoint of ``artifacts/checkpoints/``.

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``,
``unit``, ``vs_baseline`` (against the 10k rollouts/s north star of
BASELINE.md), ``nl_forward_flops`` and its ``nl_forward_flops_source``
(``"analytic"``: the port has no XLA cost analysis),
``nl_forwards_per_sec``, ``mfu_vs_h100_tf32_peak`` (model FLOPs of one
forward x forwards/s over the H100's dense TF32 peak: the kernel's GEMMs run
in split TF32 on the tensor cores), ``trained_checkpoint`` and
``train_steps_per_sec`` (``scripts/bench_train_torch.py``'s NL point at batch
16), plus ``card`` (the card's name and power limit), ``route`` and
``nl_forward_launches`` (the kernel's launches in the measured evaluation).
Without CUDA, and without ``--device cpu``, it prints one line with
``error`` and ``value: 0.0`` and exits 1. ``--device cpu`` runs the same
path through the kernel's plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BASELINE_ROLLOUTS_PER_SEC = 10_000.0  # BASELINE.md's north star
H100_TF32_PEAK_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (NVIDIA data sheet)
METRIC = "nl_mppi_rollouts_per_sec"
ENV, DELAY = "oderl-cartpole", 1


def unit(card_name: str, k: int, t: int, seeds: int) -> str:
    return (f"rollouts/s ({card_name}, K={k},T={t} NL-dynamics MPPI, {seeds} seed-batched full episodes, "
            "forward kernel)")


def nl_forward_flops_analytic(n_obs, m_act, *, terms=17, hidden=128, buf=4):
    """Analytic FLOPs of ONE NL forward (one sample, one query time), every
    matmul at 2 FLOPs per multiply-add (``bench.py``'s count):

    - the reverse GRU, 2 layers of hidden h = hidden // 2 over the buf=4
      action window: per layer and step, x @ Wx (in x 3h) and h @ Wh (h x 3h);
    - the encoder head, Linear h -> 2;
    - the Laplace representation MLP (2 * terms + n + 2) -> hidden -> hidden
      -> 2 * terms * n with tanh;
    - the fourier ILT combine: ~10 FLOPs per (term, output dim).

    Elementwise nonlinearities are left out (under 2% of the matmul count).
    """
    h = hidden // 2
    latent = n_obs + 2
    flops = 0
    in_dim = m_act
    for _ in range(2):  # GRU layers
        flops += 2 * buf * (in_dim * 3 * h + h * 3 * h)
        in_dim = h
    flops += 2 * h * 2  # encoder output head
    w_in = 2 * terms + latent
    flops += 2 * (w_in * hidden + hidden * hidden + hidden * 2 * terms * n_obs)
    flops += 10 * terms * n_obs  # ILT combine
    return flops


def nl_forward_flops(spec, config) -> tuple[float, str]:
    """FLOPs per NL forward and their source. ``bench.py`` asks XLA's cost
    analysis first; the port has none, so the count is the analytic one."""
    return float(nl_forward_flops_analytic(spec.n_obs, spec.m, terms=config.nl_s_recon_terms,
                                           hidden=config.nl_hidden_units, buf=config.action_buffer_size)), "analytic"


def main(device="cuda", seeds=8, config=None, roll_outs=None, time_steps=None, train_rows=100_000,
         train_segments=2) -> dict:
    """The bench's record, printed as one JSON line. ``config`` replaces the
    default ``Config`` (its ``fused_nl_planner`` is set); ``roll_outs`` and
    ``time_steps`` the planner's K and T; ``train_rows`` and
    ``train_segments`` size the training point."""
    from scripts.bench_train_torch import bench_nl

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.ops import pallas_nl
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint
    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(device)
    config = (config or Config()).replace(fused_nl_planner=True)
    spec = make_env(ENV, dt=config.dt).spec
    model = make_model("nl", ENV, spec.n_obs, spec.m, spec.action_high, config, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    # the tracked trained flagship; a checkpoint that does not load (another
    # width) leaves the init, and the line says so
    ckpt = resolve_checkpoint(model_checkpoint_name("nl", ENV, DELAY, "exp", 0, True), repo_root=ROOT)
    trained = False
    try:
        params = load_pytree(ckpt, like=params)
        trained = True
    except ValueError as e:
        print(f"bench_torch.py: using UNTRAINED params ({ckpt}: {e})", file=sys.stderr)

    pallas_nl.nl_forward_fused.launches = 0
    res = evaluate_policy("nl", ENV, DELAY, list(range(seeds)), config, model_apply=model.apply, params=params,
                          roll_outs=roll_outs, time_steps=time_steps, device=device)
    launches = pallas_nl.nl_forward_fused.launches
    rollouts_per_sec = res["mppi_rollouts_per_sec"]
    # one rollout is T sequential forwards of one sample, so the model-FLOP
    # rate is rollouts/s x T x FLOPs per forward
    flops_fwd, flops_src = nl_forward_flops(spec, config)
    forwards_per_sec = rollouts_per_sec * res["time_steps"]
    mfu = flops_fwd * forwards_per_sec / H100_TF32_PEAK_FLOPS

    train_steps_per_sec, _ = bench_nl(config, rows=train_rows, batch_size=config.training_batch_size,
                                      segments=train_segments, device=device)
    where = card(device)
    out = {
        "metric": METRIC,
        "value": round(rollouts_per_sec, 1),
        "unit": unit(where["device"], res["roll_outs"], res["time_steps"], seeds),
        "vs_baseline": round(rollouts_per_sec / BASELINE_ROLLOUTS_PER_SEC, 3),
        "nl_forward_flops": round(flops_fwd),
        "nl_forward_flops_source": flops_src,
        "nl_forwards_per_sec": round(forwards_per_sec),
        "mfu_vs_h100_tf32_peak": round(mfu, 4),
        "trained_checkpoint": trained,
        "train_steps_per_sec": round(train_steps_per_sec, 1),
        "card": where,
        "route": "kernel" if config.fused_nl_planner else "plain",
        "nl_forward_launches": launches,
    }
    print(json.dumps(out), flush=True)
    return out


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": unit("no CUDA device", 1000, 40, args.seeds),
                          "vs_baseline": 0.0, "error": "CUDA is not available; pass --device cpu to run on the CPU"}),
              flush=True)
        return 1
    main(device=args.device, seeds=args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(cli())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase widths [--phase kernels ...]

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
``scripts/port_jax_reference.py``), and runs NL once more with
``change_goal`` (the planner's goal moves from x = -2 to +2 halfway) against
the JAX package's run of that batch
(``artifacts/port/jax_eval_cartpole_d1_change_goal.json``, made by
``scripts/port_jax_goal_reference.py``). Then ``data.collector`` collects 20
oracle episodes with exploration noise on pendulum d1 into a temporary
directory and reads the buffer back. Phase ``deploy`` exports the fused
controller (``serving.export_controller``), holds the loaded step to the
eager one over replayed ticks and counts its kernel launches, serves 200
ticks through ``scripts/serve_demo_torch.py``'s loop with the native tick
log, reads phase ``collect``'s buffer through its ``.rbuf``, starts two
processes on one fresh compile cache and runs ``tune.autotune``. Phase ``ilt`` inverts tests/test_ilt.py's
analytic pairs with each of the six ILT algorithms at f64 and f32 against
the closed forms. Phase ``train`` runs the port's first training segment
(250 updates) in f32 and in f64 on the JAX runs recorded in
``artifacts/port/jax_train_pendulum_d1.npz`` (made by
``scripts/port_jax_train_reference.py``) and holds the losses and the
forward against them, trains with ``training.train_model`` on the collected
buffer (full width, 4 epochs), checks the forward kernel on the weights it
trained against the f64 forward, and evaluates them through the kernel with
the oracle and random over seeds 0-19. Phase ``baselines`` runs the four
baseline families (rnn, delta_t_rnn, node, latent_ode) on pendulum d1 at
full width from their tracked checkpoints: each forward against the JAX
package's f64 outputs in ``artifacts/port/jax_baselines_pendulum_d1.npz``
(made by ``scripts/port_jax_baselines_reference.py``), the latent ODE's also
over one 40-step carried horizon; ``evaluate_policy`` of rnn, delta_t_rnn
and node over seeds 0-19 (200 steps), with the oracle and random, against
the JAX package's recorded returns; the latent ODE's episode with carried
history, cut to its first steps (``scripts/port_baselines_eval.py eval``
runs it in full); ``train_model`` of each family on the collected buffer;
and the reference's 20-update training segments at f64. It also holds the
f32 forward of every tracked family checkpoint of the paper's table (38:
rnn on pendulum d0 and d1, the other three families on every env at delays
0-3) to the JAX package's f64 forward on 256 queries of its env
(``artifacts/port/jax_baselines_table.npz``, made by
``scripts/port_jax_baselines_reference.py --table``), and evaluates
delta_t_rnn on acrobot at delay 0 (2-d actions) at the full protocol
against its JAX record (``scripts/port_families_table.py`` runs every
family cell of the table). Phase ``precision``
imports the tracked reference checkpoint
(``artifacts/baseline_parity/ref_latent_ode_cartpole_d1_r4.pt``) through
``interop``, exports it back bit-exact, holds the card's ``latent_ode_ref``
forward to the CPU's f64 one and runs its 20-seed cartpole-d1 batch cut to
its first steps; then it runs the trained cartpole-d1 NL in bfloat16 and in
int8 (``ops.quant``) beside float32: the forwards' errors, int8's int32 sums
against the CPU's bit for bit, the saturation probe, the 20-seed batches of
both held by the 3-sigma rule (bfloat16 to the JAX package's bfloat16 batch,
int8 to phase ``eval``'s), and one plan's time per route at K=1,000 and
65,536. Phase ``table`` (run right after the kernels' checks, before any
profiler trace) runs the paper's table through the grid driver
``run_exp_multi_torch.main`` on the card: pendulum, cartpole and acrobot at
delays 0-3 for nl (the tracked checkpoints through the forward kernel;
pendulum d0's, trained with the age channel, in a call of its own with
``--encode_obs_time true``), the oracle and random, each cell 20 seeds, every
NL cell held to the JAX package's run at HEAD
(``artifacts/port/jax_eval_table.json``, made by
``scripts/port_jax_driver_reference.py``) and every oracle cell to its
records, and prints the normalized table. Phase ``driver`` runs
the grid driver on the card: per-delay NL training with ``--train_gate``,
a delta_t_rnn delay ensemble with ``--ensemble_gate`` (and its f64 segment
against its members' own), the MPPI sweep through the kernel
(``training.run_mppi_sweep``) and a cell traced with ``--profile_trace_dir``.
Phase ``shard`` runs the multi-device layer on the one card: the 20-seed
evaluation under each shard mode in a one-rank NCCL group (equal to phase
``eval``'s returns), two ranks sharing the card over gloo
(``scripts/port_shard_check.py``: K-sharded ticks at K=1,000 and 262,144
against the one-rank plan, the seed-sharded evaluation, grid shapes), the
forward kernel at the ranks' row counts, the dp x tp training step, and the
driver under torchrun with ``--shard``. Phase ``entry`` (after ``driver``)
runs the repo's own entry points: ``bench_torch.py`` in a fresh process (its
JSON line must show the kernel route, the trained checkpoint and the analytic
FLOP count), ``scripts/eval_bigk_torch.py`` at K=16,384,
``scripts/heldout_parity_torch.py`` on the tracked checkpoints and
``scripts/make_readme_table_torch.py`` on phase ``table``'s records. Phase
``widths`` (after ``entry``) runs the forward kernel at nl_hidden_units 24 to
2,048 on cartpole at 1,000 and 20,000 rows and 4,096 at 1,000 rows against its
plain version (the resident kernel up to 128, past it the streamed variant, a
chain of stage kernels tiled over rows and columns) on a seeded init and, past
128, on the tracked checkpoint widened to each width; the head
kernel at a 512-wide input; and the driver at nl_hidden_units 512 on cartpole
d1: 15 s of training warm-started from the widened tracked checkpoint, 10
seeds through the streamed kernel and through the plain route on the same
checkpoint, replayed ticks and the exported step.
Phase ``train`` also holds ``train_model``'s loss curve at 500 and 1,000 updates
to the band of the JAX package's three runs of the e2e training
(``artifacts/port/jax_e2e_pendulum_d1.json``, made by
``scripts/port_jax_e2e_reference.py``).

Every phase prints ``phase <name> start`` and ``phase <name> done <seconds>``;
after the total, one line gives every phase's seconds beside the run's
budget. Any failure raises, and the script exits non-zero. The last three lines are
the kernels' record (one JSON object), the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``. With
``--phase``, the build and the named phases of ``ALONE`` run, in the order
given, and the last line is the card's.

The script imports nothing of JAX; it needs the repository around it and
one CUDA device, and fails without either.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager, redirect_stdout
from functools import partial
from pathlib import Path

import numpy as np
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.data import (
    collect_expert_data,
    get_val_loss_delay_time_multi,
    load_replay_buffer,
    replay_buffer_filename,
    save_replay_buffer,
)
from neurallaplacecontrol_tpu_torch import oderl
from neurallaplacecontrol_tpu_torch.data.synthetic import generate_irregular_data_delay_latent
from neurallaplacecontrol_tpu_torch.envs import env_step, make_env
from neurallaplacecontrol_tpu_torch.envs.oracle import cartpole_dynamics_dt_latent, cartpole_dynamics_dt_latent_reduced
from neurallaplacecontrol_tpu_torch.models import make_carried_dynamics, make_latent_ode_model, make_model
from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for
from neurallaplacecontrol_tpu_torch.models import seq_baselines
from neurallaplacecontrol_tpu_torch.models.common import cast_params, mlp_apply_tanh
from neurallaplacecontrol_tpu_torch.ops import ilt, nl_cuda, pallas_ilt, pallas_nl
from neurallaplacecontrol_tpu_torch.ops.integrate import odeint_dopri5_with_stats
from neurallaplacecontrol_tpu_torch.results import latex_table, mean_confidence_interval, normalized_scores, summarize
from neurallaplacecontrol_tpu_torch.training import (
    EpisodeSettings,
    SeedDraws,
    evaluate_policy,
    make_batched_episode_fn,
    make_episode_fn,
    train_model,
)
from neurallaplacecontrol_tpu_torch.training import ensemble
from neurallaplacecontrol_tpu_torch.training.eval import build_planner
from neurallaplacecontrol_tpu_torch.training.sweep import SweepSpec, run_mppi_sweep
from neurallaplacecontrol_tpu_torch.models.common import tree_leaves, tree_unflatten
from neurallaplacecontrol_tpu_torch.oderl.dynamics import OderlDraws
from neurallaplacecontrol_tpu_torch.training.train import make_adam, make_optimizer, make_train_segment_fn, median
from neurallaplacecontrol_tpu_torch.training.train_latent_ode import build_history_windows, make_latent_ode_segment_fn
from neurallaplacecontrol_tpu_torch.utils.device import card
from neurallaplacecontrol_tpu_torch.utils.checkpoint import (
    from_jax_params,
    load_pytree,
    model_checkpoint_name,
    resolve_checkpoint,
    save_pytree,
    tracked_checkpoint_path,
    unflatten_params,
)
from scripts import eval_bigk_torch, heldout_parity_torch, make_readme_table_torch
from scripts.e2e_nl_pendulum_torch import check_curve, read_jax_curve, window_means

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
# the whole run's budget in seconds, printed beside each phase's: 90% of the
# 1,200 s in which the run must end
TOTAL_BUDGET_S = 1080
ACTION_TOL = 0.05  # env units (cartpole acts in [-3, 3]): kernel vs plain controller
TIMED_LAUNCHES = 50
TRACE_TICKS = 5  # controller ticks under torch.profiler
EVAL_SEEDS = list(range(20))  # the paper's 20 seeds per cell
EVAL_STEPS = 200  # int(10 / dt): 10-second episodes
SEED_ROWS = len(EVAL_SEEDS) * K  # forward rows per launch in the evaluation
SERVE_ROWS = 32768  # forward rows per launch in the benchmark's serve cell (portbench traffic serve-k32768)
TRACE_EVAL_TICKS = 3  # seed-batched episode ticks under torch.profiler
JAX_REFERENCE = ROOT / "artifacts" / "port" / "jax_eval_cartpole_d1.json"
JAX_GOAL_REFERENCE = ROOT / "artifacts" / "port" / "jax_eval_cartpole_d1_change_goal.json"
COLLECT_ENV, COLLECT_EPISODES = "oderl-pendulum", 20
JAX_TRAIN_REFERENCE = ROOT / "artifacts" / "port" / "jax_train_pendulum_d1.npz"
TRAIN_ENV = "oderl-pendulum"  # the collected buffer's env; trained at delay DELAY
TRAIN_EPOCHS = 4  # train_model's epochs on the collected buffer: 250 updates each
TRACE_UPDATES = 20  # training updates under torch.profiler
# Limits on the port's training against the JAX run's first segment (250
# updates), set from ``scripts/port_train_numerics.py gaps`` on an NVIDIA
# H100 80GB HBM3 at 700 W and on a CPU. Sound runs: the run as recorded, and
# with the init moved by one ulp (1% of the weights, or all of them).
# - f32: two correct runs part by 1e-2 in one update's loss from update 37
#   on, on the card and on a CPU alike, so the segment's mean loss only
#   tells a gross fault. Seven sound card runs: 8.3e-3 to 1.1e-2 (the CPU's
#   6.7e-4 to 9.7e-4: another rounding path). Limit 2e-2; a learning rate
#   10% off reads 2.0e-2 on the card and is left to the f64 check.
# - f64: the sharp check. As recorded, every update's loss within 3.6e-9 of
#   JAX's and the forward after the segment within 9.6e-7 (CPU: 7.1e-9,
#   1.9e-6). The init moved by one f32 ulp in 1% of its weights gives
#   6.7e-3 and 1.7, a learning rate or clip norm 10% off 7.1 or more and
#   1,100 or more. Limits 1e-7 and 1e-4.
# - The port's forward of JAX's f32 weights after the segment, median over
#   the 4,000 inputs: 1.5e-5 on a CPU; limit 1e-3.
JAX_F32_SEGMENT_LIMIT = 2e-2
JAX_F64_UPDATE_LIMIT = 1e-7
JAX_F64_FORWARD_LIMIT = 1e-4
JAX_WEIGHTS_FORWARD_MEDIAN_LIMIT = 1e-3
# The forward kernel on weights this early in training, against the f64
# forward in units of the fourier terms' size (``forward_errors``'s
# ``kernel_cond``). On the H100 (``scripts/port_train_numerics.py kernel``)
# the kernel read 6.0e-7 to 2.4e-6 on the JAX run's and the port's early
# weights (the f32 plain forward 4.6e-7 to 1.5e-6); the kernel with one TF32
# pass where it takes three read 5.2e-4 to 2.1e-3
TRAINED_KERNEL_COND_TOL = 1e-5
# The curve of train_model's run against the JAX package's three runs of the
# e2e training (artifacts/port/jax_e2e_pendulum_d1.json, made by
# scripts/port_jax_e2e_reference.py): its 500-update means at these counts
# lie within scripts/e2e_nl_pendulum_torch.py's band (a factor 3 beyond the
# JAX runs' min and max). Early training is set by the init more than by the
# data, so the phase's 4,000 collected rows are held to the e2e's band.
TRAIN_BAND_COUNTS = (500, 1000)
# the analytic pairs of tests/test_ilt.py (F, f) and its table of MSE limits
# against the closed form on linspace(0.05, 4, 40); fourier's bound is that
# file's convergence test (sin, 257 terms)
ILT_TS = np.linspace(0.05, 4.0, 40)
ILT_PAIRS = {
    "exp": (lambda s: 1.0 / (s + 1.0), lambda t: np.exp(-t)),
    "sin": (lambda s: 1.0 / (s**2 + 1.0), np.sin),
    "ramp": (lambda s: 1.0 / s**2, lambda t: t),
    "damped_cos": (lambda s: (s + 1.0) / ((s + 1.0) ** 2 + 4.0), lambda t: np.cos(2.0 * t) * np.exp(-t)),
}
ILT_TABLE = [  # (algorithm, terms, pairs, f64 MSE limit, f32 MSE limit)
    ("dehoog", 17, tuple(ILT_PAIRS), 1e-8, 1e-8),
    ("dehoog", 33, tuple(ILT_PAIRS), 1e-8, 1e-8),
    ("fixed_talbot", 17, tuple(ILT_PAIRS), 1e-5, 1e-5),
    # f32 cannot carry these three to the f64 table: talbot's and euler's
    # 33-term sums cancel terms of e^{t s} size, and stehfest's weights
    # reach 3.6e9. Worst f32 MSE over the pairs on a CPU and on an NVIDIA
    # H100 80GB HBM3 at 700 W: talbot-33 2.1e-4 and 6.3e-5, euler-33 4.2e-6
    # and 8.3e-6; held at 10 times the CPU's. Stehfest at f32 is no inverse
    # at all (926 on a CPU, 1,240 on the H100): held at 10 times the card's,
    # which only catches a blow-up
    ("fixed_talbot", 33, tuple(ILT_PAIRS), 1e-5, 2e-3),
    ("euler", 33, tuple(ILT_PAIRS), 1e-8, 4.2e-5),
    ("stehfest", 16, tuple(ILT_PAIRS), 1e-2, 1.24e4),
    ("fourier", 257, ("sin",), 1e-4, 1e-4),
]
# tests/test_ilt.py::test_cme_accuracy_bounds_quantified: held-out pairs on
# linspace(0.1, 3, 200), MSE limits at 17 and 41 terms, and 1e-5 at 33
CME_TS = np.linspace(0.1, 3.0, 200)
CME_PAIRS = (
    (lambda s: 1 / (s + 1) ** 2, lambda t: t * np.exp(-t), 3e-6, 1e-7),
    (lambda s: s / (s * s + 1), np.cos, 4e-4, 1e-5),
    (lambda s: 1 / torch.sqrt(s), lambda t: 1 / np.sqrt(np.pi * t), 3e-5, 5e-7),
)
# Phase ``baselines``: the four baseline families on pendulum d1, the one cell
# with a tracked checkpoint of every family, against the JAX package's f64
# run of ``scripts/port_jax_baselines_reference.py``
JAX_BASELINES_REFERENCE = ROOT / "artifacts" / "port" / "jax_baselines_pendulum_d1.npz"
BASELINE_ENV = "oderl-pendulum"
BASELINE_FAMILIES = ("rnn", "delta_t_rnn", "node", "latent_ode")
BASELINE_EVAL_FAMILIES = ("rnn", "delta_t_rnn", "node")  # evaluated in full: 20 seeds, 200 steps
DT = 0.05  # Config().dt, the planner's query horizon
BASELINE_FORWARD_TOL = 1e-3  # rel_err of the f32 forward on the card against JAX's f64
# The latent ODE's episode is cut to its first steps here (a tick took 2.8 s on
# an NVIDIA H100 80GB HBM3 at 700 W, host-bound); scripts/port_baselines_eval.py
# runs all 200 and traces a tick
LATENT_ODE_STEPS = 5
# pendulum's reward per step is -(l^2 ((1 - cos)^2 + sin^2) + c thdot^2 + c_u u^2):
# the JAX random policy averages -2.9 on this cell; a cut episode of planned
# steps stays above this floor unless it diverges
LATENT_ODE_MIN_REWARD = -20.0
BASELINE_TRAIN_ROWS = 800  # train_model's data: the collected buffer's first rows
BASELINE_TRAINING = {  # family: (epochs, iters_per_log, training_use_only_samples)
    "rnn": (3, 25, None),
    "delta_t_rnn": (3, 25, None),
    "node": (2, 50, 100),  # batch size 1: 100 updates an epoch
    "latent_ode": (2, 25, None),
}
BASELINE_SEGMENT_LIMIT = 1e-7  # each f64 update's loss against JAX's, relative
# Phase ``table``: the paper's table through the grid driver
# (run_exp_multi_torch.main) on the card, 3 envs x delays 0-3 x {nl, oracle,
# random}, each cell 20 seeds, 200 steps, K=1000, T=40. Its cells are held to
# the JAX package: the oracle to its records of the paper's full run, NL to its
# run at HEAD (scripts/port_jax_driver_reference.py), since those records
# predate the per-hemisphere sphere map, which moves the NL forward's f32 bits
# (pendulum d1: record -125.87 +- 12.82, the package at HEAD -135.26 +- 3.43)
JAX_RESULTS = ROOT / "artifacts" / "results_full_r5.jsonl"
JAX_RNN_RESULTS = ROOT / "artifacts" / "results_rnn_all12_r3.jsonl"  # rnn's records: results_full_r5 has none
JAX_BASELINES_TABLE = ROOT / "artifacts" / "port" / "jax_baselines_table.npz"
FAMILY_TABLE_FAMILIES = ("delta_t_rnn", "node", "latent_ode")  # tracked on all 12 cells; rnn on pendulum d0, d1
FAMILY_CELL_OFF_PENDULUM = ("delta_t_rnn", "oderl-acrobot", 0)  # phase baselines' full-protocol cell
JAX_TABLE_REFERENCE = ROOT / "artifacts" / "port" / "jax_eval_table.json"
TABLE_DELAYS = (0, 1, 2, 3)
TABLE_MODELS = ("nl", "oracle", "random")
# the one tracked NL checkpoint trained with the age channel (its GRU takes the
# action and the entry's age): it loads only under Config(encode_obs_time=True),
# so its cell runs in a driver call of its own with that flag, while the
# oracle and random of the same (env, delay) run without it, as JAX's did
AGE_CHANNEL_CELL = ("oderl-pendulum", 0)
DRIVER_GATE_SEEDS = 5  # the gates' seeds and the training parts' final evaluation
DRIVER_TRAIN_SECONDS = 5  # the NL draw gated against random; a 5 s draw may fail the margin
ENSEMBLE_TRAIN_SECONDS = 3
ENSEMBLE_ROWS = 4000  # the ensemble's buffers: phase collect's d1, the driver's own d0
ENSEMBLE_SEGMENT_LIMIT = 1e-10  # f64, each update's loss: ensemble member vs its own segment
SWEEP = dict(n_trials=3, base_seeds=2, max_seeds=6, roll_outs=(256, 1000, 4096), time_steps=(20, 40))
TRACE_SEEDS = 2
# Phase ``shard``: the multi-device layer on the one card (a world of one
# over NCCL, two ranks sharing the card over gloo, torchrun with one rank).
# The K-sharded plan sums each half of K apart, so in f32 it parts from the
# one-rank plan by rounding; SHARD_TICK_LIMIT bounds |dU| / (1 + |U|) and
# |d action| over 10 replayed ticks, and a plan without the reductions over
# the ranks must read above it
# (sound: 2.1e-7 to 2.4e-7 at K=1,000 and 262,144; planted: 0.29 to 1.0;
# NVIDIA H100 80GB HBM3, 700 W)
SHARD_TICK_LIMIT = 1e-5
SHARD_FORWARD_ROWS = (10_000, 131_072, 262_144)  # a rank's rows at K=20,000 / 2, 262,144 / 2, 262,144
SHARD_TIMED_ROWS = (131_072, 262_144)
SHARD_TRAIN_STEPS = 2
TRAIN_STEP_RTOL, TRAIN_STEP_ATOL = 2e-4, 1e-6  # tests/test_sharding.py:140-144, the JAX test's f32 tolerance
SHARD_DRIVER_SEEDS = 4
SHARD_RANKS_TIMEOUT_S = 600
SHARD_DRIVER_TIMEOUT_S = 300
# Phase ``precision``: the rest of the model surface. The reference .pt
# imports through ``interop`` and plans as ``latent_ode_ref``; the NL model
# runs in bfloat16 and in int8 beside the float32 routes.
REF_LATENT_ODE_PT = ROOT / "artifacts" / "baseline_parity" / "ref_latent_ode_cartpole_d1_r4.pt"
JAX_PRECISION_REFERENCE = ROOT / "artifacts" / "port" / "jax_eval_cartpole_d1_precision.json"
LOR_FORWARD_TOL = 1e-3  # rel_err of the card's f32 forward against the CPU's f64, BASELINE_FORWARD_TOL's rule
LOR_STEPS = 3  # the latent_ode_ref episode cut to its first steps (scripts/port_baselines_eval.py runs 200)
LOR_MIN_REWARD = -20.0  # a cut step's reward on cartpole, as LATENT_ODE_MIN_REWARD
BF16_ROWS = 512  # tests/test_models.py:130-173: rel max < 0.10, median < 0.01
BF16_MAX_LIMIT, BF16_MEDIAN_LIMIT = 0.10, 0.01
INT8_ROWS = 4096  # tests/test_quant.py:96-113: median |err| < 0.05, mean |err| / std < 0.10
INT8_MEDIAN_LIMIT, INT8_SPREAD_LIMIT = 0.05, 0.10
INT8_ACC_ROWS = (1, 7, 17, 1000, SEED_ROWS)  # padded and unpadded rows of torch._int_mm
SATURATION_K = 256  # scripts/bench_int8.py's probe: K = min(k, 256), T = 40
PLAN_KS = (1000, 65_536)
PLAN_REPS = {1000: 6, 65_536: 3}
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores (NVIDIA data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (NVIDIA data sheet)
SPLIT_PASSES = 3  # split TF32: hi*hi + hi*lo + lo*hi per product
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s
# Phase ``research``: the ODE-RL stack, the sequence baselines and the
# latent data, held to the JAX package's f64 run of
# ``scripts/port_jax_research_reference.py`` and to the port's own f64
JAX_RESEARCH_REFERENCE = ROOT / "artifacts" / "port" / "jax_research_pendulum.npz"
RESEARCH_ENV = "oderl-pendulum"
RESEARCH_ROWS, RESEARCH_H, RESEARCH_TAU = 100, 2.0, 5.0  # forward_simulate's initial states and horizon
RESEARCH_F32_TOL = 1e-3  # each family's f32 rollout against its f64 one on the same draws, rel_err
RESEARCH_SIM_TOL = 1e-10  # simulate_enode at f64 against JAX's, rel_err
RESEARCH_UPDATE_TOL = 1e-7  # each trainer update's loss against JAX's, relative
RESEARCH_SEQ_TOL = 1e-7  # each sequence-model update's loss against JAX's, relative
RESEARCH_LATENT_TOL = 1e-10  # the latent generator and the two-frame oracles, rel_err
RESEARCH_TRACE_UPDATES = 1  # each demo trainer's updates under torch.profiler
# ENODE's f64 train_policy at full width takes 1.55-2.08 s an update on an
# NVIDIA H100 80GB HBM3 at 700 W (host-bound): the phase holds the first 5 of
# the artifact's 20 updates of it, and all 20 of gradient_match and
# train_dynamics
RESEARCH_POLICY_UPDATES = 5
# The demo at its own widths, its iterations cut to fit the phase's ~90 s:
# train_dynamics 200 -> 100 updates, train_policy 100 -> 20 (0.69-0.83 s an
# update on an NVIDIA H100 80GB HBM3 at 700 W, host-bound); gradient_match
# keeps 300
RESEARCH_DEMO_DYN_UPDATES, RESEARCH_DEMO_POL_UPDATES = 100, 20


PHASE_SECONDS = {}  # each phase's seconds in this run, printed after the total
PART_SECONDS = {}  # seconds of parts of a phase, printed beside them (within their phase's)


@contextmanager
def phase(name: str):
    print(f"phase {name} start", flush=True)
    t0 = time.perf_counter()
    yield
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"phase {name} done {PHASE_SECONDS[name]:.3f}", flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them, from ``utils.device.card``."""
    c = card(torch.device("cuda", 0))
    return f"{c['device']}, {c['power_limit_w']:.2f} W"


def rel_err(got: torch.Tensor, exp: torch.Tensor) -> float:
    return float(((got - exp).abs() / (1.0 + exp.abs())).max())


def forward_errors(got: torch.Tensor, obs, acts, packed, n: int, in_dim: int) -> dict:
    """The forward kernel's output ``got`` against the plain forward on the
    same packed f32 weights and inputs: at f32 (``kernel_vs_plain``, the
    metric of ``rel_err``), and at f64 (``kernel_vs_plain64``, with
    ``plain_vs_plain64`` for the f32 plain forward). ``kernel_cond`` and
    ``plain_cond`` scale the distance to the f64 forward to the size of the
    fourier terms that each output sums: max |got - exp64| / (1 + sum_k
    |term_k|), with the terms taken from the f64 forward. On weights whose
    outputs cancel terms thousands of times their size, f32 cannot resolve
    the output to ``rel_err``'s 1e-3, but the terms it can."""
    packed64 = tuple(x.double() for x in packed)
    obs64, acts64 = obs.double(), acts.double()
    exp = pallas_nl.nl_forward_plain(obs, acts, packed, n, in_dim)
    hid64 = pallas_nl.nl_trunk_plain(obs64, acts64, packed64, in_dim)
    w_theta, w_phi, b_theta, b_phi, s_re, s_im = packed64[15:]
    f_re, f_im = pallas_ilt._sphere_f(hid64 @ w_theta + b_theta, hid64 @ w_phi + b_phi)
    exp64 = (f_re @ s_re - f_im @ s_im)[:, :n]
    scale = 1.0 + (f_re.abs() @ s_re.abs() + f_im.abs() @ s_im.abs())[:, :n]
    return {"kernel_vs_plain": rel_err(got, exp), "kernel_vs_plain64": rel_err(got.double(), exp64),
            "plain_vs_plain64": rel_err(exp.double(), exp64),
            "kernel_cond": float(((got.double() - exp64).abs() / scale).max()),
            "plain_cond": float(((exp.double() - exp64).abs() / scale).max()),
            "max_abs_out": float(exp64.abs().max()), "max_term_sum": float(scale.max() - 1.0)}


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


def nl_config(env_name: str, delay: int) -> "port.Config":
    """The ``Config`` that the tracked NL checkpoint of a cell loads under."""
    return port.Config(encode_obs_time=(env_name, delay) == AGE_CHANNEL_CELL)


def load_nl(env_name: str, device, delay: int = DELAY):
    env = make_env(env_name)
    spec = env.spec
    params = load_pytree(
        resolve_checkpoint(model_checkpoint_name("nl", env_name, delay, "exp", 0, True)),
        device=device,
    )
    model = make_model("nl", env_name, spec.n_obs, spec.m, spec.action_high, nl_config(env_name, delay),
                       device=device)
    return env, params, model


def action_buffers(rng, rows: int, spec, A: int, age: bool) -> np.ndarray:
    """Seeded action buffers [rows, A * in] as tests/test_pallas_nl.py draws
    them; with the age channel, each entry's age on the exp grid (the newest
    0, the others sums of exponential steps), which enters the kernel raw."""
    window = rng.uniform(-spec.action_high, spec.action_high, (rows, A, spec.m + int(age)))
    if age:
        steps = rng.exponential(port.Config().dt, (rows, A - 1))
        window[:, :-1, -1] = np.cumsum(steps[:, ::-1], axis=1)[:, ::-1]
        window[:, -1, -1] = 0.0
    return window.reshape(rows, -1)


def check_kernels(device) -> dict:
    """Each kernel against its plain version on every tracked NL checkpoint
    (3 envs x delays 0-3): the forward at B=K and at the evaluation's S*K
    rows, the head at B=K."""
    records = {"nl_forward": [], "nl_head": []}
    terms = port.Config().nl_s_recon_terms
    for i, (env_name, delay) in enumerate((e, d) for e in ENVS for d in TABLE_DELAYS):
        env, params, model = load_nl(env_name, device, delay)
        spec = env.spec
        fused = model.make_fused_planner_apply(params, port.Config().dt)
        packed = fused.packed
        age = nl_config(env_name, delay).encode_obs_time
        n, in_dim, A = spec.n_obs, spec.m + int(age), port.Config().action_buffer_size
        # seeded inputs; the head's input is a hidden state in the trunk's tanh range
        rng = np.random.default_rng(3 + i)
        obs_all = torch.tensor(rng.standard_normal((SEED_ROWS, n)), dtype=torch.float32, device=device)
        acts_all = torch.tensor(action_buffers(rng, SEED_ROWS, spec, A, age), dtype=torch.float32, device=device)
        hid = packed[13].shape[0]
        x = torch.tensor(np.tanh(rng.standard_normal((K, hid))), dtype=torch.float32, device=device)
        head = packed[15:]
        head_hopper = torch.as_tensor(pallas_ilt.repack_head(head, n, terms), device=device)

        checks = []
        for rows in (K, SEED_ROWS):
            obs, acts = obs_all[:rows], acts_all[:rows]
            checks.append(("nl_forward", rows,
                           pallas_nl.nl_forward_fused(obs, acts, packed, n, in_dim, terms=terms, hopper=fused.hopper),
                           pallas_nl.nl_forward_plain(obs, acts, packed, n, in_dim)))
        checks.append(("nl_head", K, pallas_ilt.nl_head_fused(x, head, n, terms=terms, hopper=head_hopper),
                       pallas_ilt.nl_head_plain(x, head, n)))
        torch.cuda.synchronize()
        obs, acts = obs_all[:K], acts_all[:K]
        for name, rows, g, e in checks:
            where = f"{name} on {env_name} d{delay} at B={rows}"
            if g.shape != (rows, n) or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{where}: shape {tuple(g.shape)} or non-finite output")
            rel = rel_err(g, e)
            if not rel < KERNEL_TOL:
                raise RuntimeError(f"{where}: relative error {rel:.3e} >= {KERNEL_TOL}")
            rec = {"env": env_name, "delay": delay, "B": rows, "encode_obs_time": age,
                   "max_abs_err": float((g - e).abs().max()), "max_rel_err": rel,
                   "mean_abs_exp": float(e.abs().mean())}
            if (env_name, delay, rows) == (MAIN_ENV, DELAY, K):  # time at the main path's shapes
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
                if name == "nl_forward":
                    rec.update(weight_loads(K, fused, spec, terms))
                # the kernel's share of the tighter of its bounds
                tight = min(("bound_ms", "bound_tc_ms"), key=rec.get)
                rec["bound_share"], rec["bound_share_of"] = rec[tight] / rec["ms"], tight
            records[name].append(rec)
            print(f"kernel {name} {env_name} d{delay} B={rows}: " + json.dumps(rec), flush=True)
    return records


def weight_loads(rows: int, fused, spec, terms: int) -> dict:
    """The resident forward's CTAs at ``rows`` rows (each copies its weights
    once a launch, ``nl_forward_fused.weight_loads``), its CTAs a cluster and
    the rows each weight load serves."""
    plan = nl_cuda.forward_plan(forward_dims(rows, fused, spec, terms))
    return {"ctas": plan["ctas"], "cluster": plan["cluster"], "tile_rows": plan["tile"][0],
            "rows_per_weight_load": rows / plan["ctas"]}


def check_forward_rows(device, env_name: str, rows: int, timed: bool = False) -> dict:
    """The forward on ``env_name``'s tracked weights at ``rows`` batch rows
    against its plain version (``KERNEL_TOL``); with ``timed``, also its
    graph-timed and eager ms, bounds and weight loads at that size."""
    env, params, model = load_nl(env_name, device)
    spec = env.spec
    terms, A = port.Config().nl_s_recon_terms, port.Config().action_buffer_size
    fused = model.make_fused_planner_apply(params, port.Config().dt)
    packed, n, in_dim = fused.packed, spec.n_obs, spec.m
    rng = np.random.default_rng(20)
    obs = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=device)
    acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high, (rows, A * in_dim)),
                        dtype=torch.float32, device=device)
    kernel = partial(pallas_nl.nl_forward_fused, obs, acts, packed, n, in_dim, terms=terms, hopper=fused.hopper)
    plain = partial(pallas_nl.nl_forward_plain, obs, acts, packed, n, in_dim)
    got, exp = kernel(), plain()
    torch.cuda.synchronize()
    if got.shape != (rows, n) or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"nl_forward {env_name} at B={rows}: shape {tuple(got.shape)} or non-finite output")
    rel = rel_err(got, exp)
    if not rel < KERNEL_TOL:
        raise RuntimeError(f"nl_forward {env_name} at B={rows}: relative error {rel:.3e} >= {KERNEL_TOL}")
    rec = {"env": env_name, "B": rows, "max_abs_err": float((got - exp).abs().max()), "max_rel_err": rel}
    if timed:
        rec.update(ms=graph_ms(kernel, 20), eager_ms=time_ms(kernel, 20), plain_ms=graph_ms(plain, 5))
        rec.update(weight_loads(rows, fused, spec, terms))
        hid = packed[13].shape[0]
        rec.update(bounds(*forward_cost(rows, n, A, in_dim, packed[1].shape[0], hid, n, terms, packed)))
        tight = min(("bound_ms", "bound_tc_ms"), key=rec.get)
        rec["bound_share"], rec["bound_share_of"] = rec[tight] / rec["ms"], tight
    return rec


def check_forward_seed_batch(device) -> dict:
    """The forward on cartpole at the evaluation's S*K = 20,000 rows against
    its plain version, with its graph-timed ms and bounds at that size, and
    the same at the serve cell's K = 32,768 rows (``serve`` in the record)."""
    rec = check_forward_rows(device, MAIN_ENV, SEED_ROWS, timed=True)
    rec["serve"] = check_forward_rows(device, MAIN_ENV, SERVE_ROWS, timed=True)
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

    fwd = pallas_nl.nl_forward_fused
    fwd.launches = fwd.rows = fwd.streamed_launches = fwd.streamed_rows = 0
    pallas_ilt.nl_head_fused.launches = 0
    results = {name: evaluate_policy(name, MAIN_ENV, DELAY, EVAL_SEEDS, cfg, model_apply=model.apply,
                                     params=params, roll_outs=K, time_steps=T, device=device)
               for name in ("random", "oracle", "nl")}
    launches = {"nl_forward": fwd.launches, "nl_head": pallas_ilt.nl_head_fused.launches,
                "nl_forward_streamed": fwd.streamed_launches}
    rows_per_launch = fwd.rows / max(1, launches["nl_forward"])
    # the variant the kernel library plans at the evaluation's dims, and its tile
    fused = model.make_fused_planner_apply(params, cfg.dt)
    plan = dict(nl_cuda.forward_plan(forward_dims(SEED_ROWS, fused, env.spec, cfg.nl_s_recon_terms)))

    out = {"env": MAIN_ENV, "delay": DELAY, "K": K, "T": T, "steps": EVAL_STEPS, "seeds": len(EVAL_SEEDS),
           "launches": launches, "forward_rows_per_launch": rows_per_launch, "forward_plan": plan, "card": smi}
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
    env_t, mppi_cfg, mppi_params, dynamics, _, _ = build_planner(
        "nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K, time_steps=T,
        device=device)
    ticks = make_episode_fn(env_t, dynamics, mppi_cfg, mppi_params,
                            EpisodeSettings(delay=DELAY, n_steps=TRACE_EVAL_TICKS))
    tick_ms = 1e3 * results["nl"]["episode_elapsed_time"] / EVAL_STEPS
    out["trace"] = trace_ticks(lambda: ticks(SeedDraws(EVAL_SEEDS, device=device))[0].cpu(),
                               TRACE_EVAL_TICKS, tick_ms)
    print("eval " + json.dumps(out), flush=True)
    out["nl_returns"] = results["nl"]["total_rewards"]  # phase shard holds its sharded runs to these

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
    if launches["nl_forward_streamed"] or plan["variant"] != "resident":
        raise RuntimeError(f"the main path ran {launches['nl_forward_streamed']} streamed launches (plan {plan}): "
                           "at width 128 every launch is the resident kernel's")
    if not gap <= limit:
        raise RuntimeError(f"NL mean return {port_nl.mean():.3f} is {gap:.3f} from the JAX run's "
                           f"{jax_nl.mean():.3f}, over the limit {limit:.3f}")
    out["change_goal"] = run_change_goal(device, smi, model, params, cfg)
    return out


def run_change_goal(device, smi: str, model, params, cfg) -> dict:
    """Phase ``eval``'s ``change_goal`` batch: fused NL over seeds 0-19 with
    the planner's goal moving from x = -2 to +2 halfway, held to the JAX
    package's CPU run of the same cell (``JAX_GOAL_REFERENCE``, made by
    ``scripts/port_jax_goal_reference.py`` on the checkpoint whose sha256 it
    records) by the 3-sigma rule."""
    ref = json.loads(JAX_GOAL_REFERENCE.read_text())
    ckpt = Path(resolve_checkpoint(model_checkpoint_name("nl", MAIN_ENV, DELAY, "exp", 0, True)))
    digest = hashlib.sha256(ckpt.read_bytes()).hexdigest()
    if (ref["env"], ref["delay"], ref["seeds"], ref["change_goal"]) != (MAIN_ENV, DELAY, EVAL_SEEDS, True):
        raise RuntimeError(f"{JAX_GOAL_REFERENCE} holds another cell")
    if ckpt.relative_to(ROOT).as_posix() != ref["checkpoint"]["path"] or digest != ref["checkpoint"]["sha256"]:
        raise RuntimeError(f"the JAX change_goal run used {ref['checkpoint']}, this run loads {ckpt} ({digest})")
    pallas_nl.nl_forward_fused.launches = pallas_nl.nl_forward_fused.rows = 0
    r = evaluate_policy("nl", MAIN_ENV, DELAY, EVAL_SEEDS, cfg, model_apply=model.apply, params=params,
                        roll_outs=K, time_steps=T, change_goal=True, device=device)
    launches = pallas_nl.nl_forward_fused.launches
    got, exp = np.asarray(r["total_rewards"]), np.asarray(ref["nl"]["total_rewards"])
    n = len(EVAL_SEEDS)
    gap = abs(float(got.mean() - exp.mean()))
    limit = 3.0 * math.sqrt(exp.var(ddof=1) / n + got.var(ddof=1) / n)
    out = {**policy_stats(r), "jax_mean": float(exp.mean()), "jax_std": float(exp.std()), "gap": gap,
           "limit": limit, "launches": launches, "rows_per_launch": pallas_nl.nl_forward_fused.rows / max(1, launches),
           "checkpoint_sha256": digest, "jax_commit": ref["commit"], "card": smi}
    print("eval change_goal " + json.dumps(out), flush=True)
    if not all(math.isfinite(x) for x in r["total_rewards"]):
        raise RuntimeError("non-finite change_goal return")
    if launches != (EVAL_STEPS + 1) * T or out["rows_per_launch"] != SEED_ROWS:
        raise RuntimeError(f"change_goal: nl_forward launched {launches} times at {out['rows_per_launch']} rows")
    if not gap <= limit:
        raise RuntimeError(f"change_goal NL mean return {got.mean():.3f} is {gap:.3f} from the JAX run's "
                           f"{exp.mean():.3f}, over the limit {limit:.3f}")
    return out


def run_collect(device, tmp: str) -> dict:
    """Expert collection: 20 oracle episodes with exploration noise on the
    exp grid, written under the cache key to the directory ``tmp`` and read
    back with ``load_replay_buffer``."""
    n = COLLECT_EPISODES * EVAL_STEPS
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


def run_ilt(device) -> dict:
    """Each of the six ILT algorithms inverts the analytic pairs on the card
    at f64 and f32, held against the closed form at tests/test_ilt.py's
    limits (``ILT_TABLE``, ``CME_PAIRS``)."""
    cases, failures = [], []

    def check(alg, terms, pair, dtype, mse, limit):
        ok = math.isfinite(mse) and mse <= limit
        cases.append({"algorithm": alg, "terms": terms, "pair": pair, "dtype": str(dtype)[6:],
                      "mse": mse, "limit": limit, "ok": ok})
        if not ok:
            failures.append(cases[-1])

    for dtype in (torch.float64, torch.float32):
        t = torch.tensor(ILT_TS, dtype=dtype, device=device)
        for alg, terms, pairs, lim64, lim32 in ILT_TABLE:
            for name in pairs:
                F, f = ILT_PAIRS[name]
                got = ilt.inverse_laplace(F, t, terms, alg).double().cpu().numpy()
                check(alg, terms, name, dtype, float(np.mean((got - f(ILT_TS)) ** 2)),
                      lim64 if dtype == torch.float64 else lim32)
        t = torch.tensor(CME_TS, dtype=dtype, device=device)
        for i, (F, f, lim17, lim41) in enumerate(CME_PAIRS):
            for terms, limit in ((17, lim17), (33, 1e-5), (41, lim41)):
                got = ilt.inverse_laplace(F, t, terms, "cme").double().cpu().numpy()
                check("cme", terms, f"held_out_{i}", dtype, float(np.mean((got - f(CME_TS)) ** 2)), limit)
    # fixed_tablot is the reference's spelling of fixed_talbot: the same function
    t = torch.tensor(ILT_TS, dtype=torch.float64, device=device)
    alias = ilt.inverse_laplace(ILT_PAIRS["sin"][0], t, 17, "fixed_tablot")
    same = bool(torch.equal(alias, ilt.inverse_laplace(ILT_PAIRS["sin"][0], t, 17, "fixed_talbot")))
    out = {"cases": len(cases), "failed": len(failures), "fixed_tablot_alias_equal": same,
           "worst": {f"{c['algorithm']}_{c['terms']}_{c['dtype']}": max(
               d["mse"] for d in cases if (d["algorithm"], d["terms"], d["dtype"]) ==
               (c["algorithm"], c["terms"], c["dtype"])) for c in cases}}
    print("ilt " + json.dumps(out), flush=True)
    if failures or not same:
        raise RuntimeError(f"ILT cases over their limits: {failures}; fixed_tablot alias equal: {same}")
    return out


def read_jax_train_reference(path=JAX_TRAIN_REFERENCE) -> dict:
    """The record of ``scripts/port_jax_train_reference.py`` as numpy: the
    ``init`` and ``final`` parameter trees (``final``: the f32 run's params
    after its segments), the ``data`` (s0, a0, sn, ts), ``batch_idx``
    [segments, updates, batch], the f32 run's ``losses`` [segments, updates]
    and ``pred`` (its final params' forward on the data), the f64 run's
    ``losses64`` and ``pred64``, and ``meta``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def section(name):
        return {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(name + "/")}

    return {"init": unflatten_params(section("init")), "final": unflatten_params(section("final")),
            "data": section("data"), "meta": json.loads(str(flat["meta"])),
            **{k: flat[k] for k in ("batch_idx", "losses", "pred", "losses64", "pred64")}}


def train_against_jax(ref: dict, device, dtype=torch.float32, config=None) -> dict:
    """The port's segments on the JAX run's init, data and batch order at
    ``dtype`` (f32: the f32 run's segments; f64: the f64 run's), each
    segment's cap from the previous one's median as ``train_model`` takes
    it. Gaps to the JAX run: the first segment's mean loss, the largest
    relative gap of one update's loss, and the final params' forward on the
    data as max |got - exp| / (1 + |exp|). ``config`` replaces the default
    ``Config`` (a planted fault in ``scripts/port_train_numerics.py``)."""
    cfg = config or port.Config()
    f64 = dtype == torch.float64
    exp_losses, exp_pred = (ref["losses64"], ref["pred64"]) if f64 else (ref["losses"], ref["pred"])
    model = make_model("nl", TRAIN_ENV, 3, 1, 2.0, cfg, dtype=dtype, device=device)
    params = from_jax_params(ref["init"], device=device, dtype=dtype)
    optimizer = make_optimizer(cfg)
    state = optimizer.init(params)
    segment = make_train_segment_fn(model, optimizer)
    s0, a0, sn, ts = (torch.as_tensor(ref["data"][k], dtype=dtype, device=device) for k in ("s0", "a0", "sn", "ts"))
    batch_idx = torch.as_tensor(ref["batch_idx"][:len(exp_losses)], dtype=torch.long, device=device)
    loss_cap, losses = math.inf, []
    t0 = time.perf_counter()
    for seg_idx in batch_idx:
        params, state, seg_losses = segment(params, state, s0, a0, sn, ts, seg_idx, loss_cap)
        seg_losses = seg_losses.cpu()
        losses.append(seg_losses.numpy())
        seg_median = median(seg_losses)
        if math.isfinite(seg_median) and seg_median > 0:
            loss_cap = cfg.training_loss_skip_factor * seg_median
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        pred = model.apply(params, s0, a0, ts).cpu().numpy()
    losses = np.stack(losses)
    return {"dtype": str(dtype)[6:], "updates": int(losses.size), "seconds": seconds,
            "ms_per_update": 1e3 * seconds / losses.size,
            "segment_mean_loss": losses.mean(axis=1).tolist(), "jax_segment_mean_loss": exp_losses.mean(axis=1).tolist(),
            "first_segment_rel_gap": float(abs(losses[0].mean() / exp_losses[0].mean() - 1.0)),
            "update_loss_rel_gap": float(np.max(np.abs(losses - exp_losses) / np.abs(exp_losses))),
            "forward_rel_gap": float(np.max(np.abs(pred - exp_pred) / (1.0 + np.abs(exp_pred)))),
            "finite": bool(np.isfinite(losses).all()), "count": int(state.count), "params": params,
            "losses": losses}


def trace_updates(segment, params, state, data, batch_idx, ms_per_update: float) -> dict:
    """``TRACE_UPDATES`` training updates of one segment under
    ``trace_ticks``: the device's busy time per update and its idle share."""
    return trace_ticks(lambda: segment(params, state, *data, batch_idx[:TRACE_UPDATES])[2].cpu(),
                       TRACE_UPDATES, ms_per_update)


def run_train(device, smi: str, tmp: str) -> dict:
    """Training on the card: the port's segments against the JAX run of
    ``artifacts/port/jax_train_pendulum_d1.npz``; ``train_model`` on the
    buffer phase ``collect`` wrote; the forward kernel on the weights it
    trained; and ``evaluate_policy`` of those weights through the kernel,
    with the oracle and random, over seeds 0-19."""
    cfg = port.Config()
    # 1. held against JAX: the first segment in f32 and in f64, and the port's
    # forward of JAX's f32 weights after it
    ref = read_jax_train_reference()
    runs = {name: train_against_jax(ref, device, dtype) for name, dtype in (("f32", torch.float32),
                                                                          ("f64", torch.float64))}
    model = make_model("nl", TRAIN_ENV, 3, 1, 2.0, cfg, device=device)
    jax_final = from_jax_params(ref["final"], device=device)
    data = tuple(torch.as_tensor(ref["data"][k], device=device) for k in ("s0", "a0", "sn", "ts"))
    with torch.no_grad():
        pred = model.apply(jax_final, data[0], data[1], data[3]).cpu().numpy()
    weights_gap = float(np.median(np.abs(pred - ref["pred"]) / (1.0 + np.abs(ref["pred"]))))
    optimizer = make_optimizer(cfg)
    segment = make_train_segment_fn(model, optimizer)
    batch_idx = torch.as_tensor(ref["batch_idx"][0], dtype=torch.long, device=device)
    trace = trace_updates(segment, runs["f32"].pop("params"), optimizer.init(jax_final), data, batch_idx,
                          runs["f32"]["ms_per_update"])
    runs["f64"].pop("params")
    for r in runs.values():
        del r["losses"]
    vs_jax = {**runs, "jax_weights_forward_median_rel_gap": weights_gap, "jax_commit": ref["meta"]["commit"]}
    jax_checks = {
        "f32 first segment's mean loss": (runs["f32"]["first_segment_rel_gap"], JAX_F32_SEGMENT_LIMIT),
        "f64 loss of each update": (runs["f64"]["update_loss_rel_gap"], JAX_F64_UPDATE_LIMIT),
        "f64 forward after the segment": (runs["f64"]["forward_rel_gap"], JAX_F64_FORWARD_LIMIT),
        "forward of JAX's weights, median": (weights_gap, JAX_WEIGHTS_FORWARD_MEDIAN_LIMIT),
    }
    vs_jax["limits"] = {what: limit for what, (_, limit) in jax_checks.items()}

    # 2. the normal entry point on the collected buffer
    saved = Path(tmp) / "saved_models"
    tcfg = cfg.replace(offline_datasets_path=tmp, saved_models_path=str(saved) + "/",
                       training_epochs=TRAIN_EPOCHS, end_training_after_seconds=None)
    t0 = time.perf_counter()
    model, params, res = train_model("nl", TRAIN_ENV, tcfg, delay=DELAY, retrain=True, force_retrain=True,
                                     device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    name = model_checkpoint_name("nl", TRAIN_ENV, DELAY, "exp", 0, True, training_epochs=TRAIN_EPOCHS)
    reloaded = load_pytree(saved / name, like=params)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(reloaded), tree_leaves(params)))
    env = make_env(TRAIN_ENV)
    init = model.init(torch.Generator(device=device).manual_seed(0))
    tracked = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", TRAIN_ENV, DELAY, "exp", 0, True)),
                          device=device)
    val = {k: get_val_loss_delay_time_multi(model.apply, p, env, DELAY, device=device)
           for k, p in (("init", init), ("trained", params), ("tracked_checkpoint", tracked))}
    updates = TRAIN_EPOCHS * (COLLECT_EPISODES * EVAL_STEPS // cfg.training_batch_size)

    # 3. the forward kernel on the weights the port trained, against the plain
    # forward at f32 and at f64 (``forward_errors``)
    fused = model.make_fused_planner_apply(params, cfg.dt)
    kernel_err = {}
    for rows in (K, SEED_ROWS):
        rng = np.random.default_rng(rows)
        obs = torch.tensor(rng.standard_normal((rows, 3)), dtype=torch.float32, device=device)
        acts = torch.tensor(rng.uniform(-2.0, 2.0, (rows, 4)), dtype=torch.float32, device=device)
        got = pallas_nl.nl_forward_fused(obs, acts, fused.packed, 3, 1, terms=cfg.nl_s_recon_terms,
                                         hopper=fused.hopper)
        if got.shape != (rows, 3) or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"nl_forward on trained weights at B={rows}: non-finite or wrong shape")
        kernel_err[rows] = forward_errors(got, obs, acts, fused.packed, 3, 1)

    # 4. evaluate the trained weights through the kernel
    ecfg = cfg.replace(fused_nl_planner=True)
    pallas_nl.nl_forward_fused.launches = pallas_ilt.nl_head_fused.launches = 0
    results = {name: evaluate_policy(name, TRAIN_ENV, DELAY, EVAL_SEEDS, ecfg, model_apply=model.apply,
                                     params=params, roll_outs=K, time_steps=T, device=device)
               for name in ("random", "oracle", "nl")}
    launches = {"nl_forward": pallas_nl.nl_forward_fused.launches, "nl_head": pallas_ilt.nl_head_fused.launches}
    mean, ci, _ = normalized_scores(results.values(), agg="ci95")[(DELAY, TRAIN_ENV, "nl")]

    band = check_curve(window_means(res["segment_losses"]), read_jax_curve(), counts=TRAIN_BAND_COUNTS)

    out = {
        "env": TRAIN_ENV, "delay": DELAY, "card": smi, "vs_jax": vs_jax, "trace_per_update": trace,
        "band": band,
        "train_model": {"updates": updates, "wall_s": wall, "train_seconds": res["train_seconds"],
                        "updates_per_s": updates / wall, "ms_per_update": 1e3 * wall / updates,
                        "epoch_losses": res["epoch_losses"], "train_loss": res["train_loss"],
                        "checkpoint_reads_back_equal": same},
        "val_loss": val, "kernel_on_trained_weights": max(e["kernel_vs_plain"] for e in kernel_err.values()),
        "kernel_cond_on_trained_weights": max(e["kernel_cond"] for e in kernel_err.values()),
        "kernel_cond_limit": TRAINED_KERNEL_COND_TOL,
        "kernel_by_rows": kernel_err, "launches": launches,
        "eval": {name: policy_stats(r) for name, r in results.items()}, "nl_normalized_ci95": [mean, ci],
    }
    print("train " + json.dumps(out), flush=True)
    out["eval_results"] = results  # phase baselines scores its families against this oracle and random

    for what, (value, limit) in jax_checks.items():
        if not value < limit:
            raise RuntimeError(f"{what}: {value} is not below {limit}")
    for rows, e in kernel_err.items():
        # f32 cannot hold these weights' outputs to KERNEL_TOL (the f32 plain
        # forward misses it as well), but it can hold the fourier terms they
        # sum: the kernel is held to the f64 forward in units of their size
        if not e["kernel_cond"] < TRAINED_KERNEL_COND_TOL:
            raise RuntimeError(f"nl_forward on trained weights at B={rows}: kernel_cond {e['kernel_cond']} "
                               f"is not below {TRAINED_KERNEL_COND_TOL}: {e}")
    losses = res["epoch_losses"] + [res["train_loss"]]
    if not all(r["finite"] for r in runs.values()) or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not res["epoch_losses"][-1] < res["epoch_losses"][0]:
        raise RuntimeError(f"the last epoch's loss is not below the first's: {res['epoch_losses']}")
    if [p["updates"] for p in band["points"]] != list(TRAIN_BAND_COUNTS) or not band["inside"]:
        raise RuntimeError(f"train_model's curve leaves the JAX runs' band: {band}")
    if not same:
        raise RuntimeError("the checkpoint read back differs from the trained params")
    if not val["trained"] < val["init"]:
        raise RuntimeError(f"validation loss {val['trained']} is not below the init's {val['init']}")
    returns = [x for r in results.values() for x in r["total_rewards"]]
    if not all(math.isfinite(x) for x in returns):
        raise RuntimeError("non-finite episode return in the evaluation of the trained weights")
    if launches["nl_forward"] != (EVAL_STEPS + 1) * T:
        raise RuntimeError(f"nl_forward launched {launches['nl_forward']} times in phase train")
    return out


def read_jax_baselines_reference(path=JAX_BASELINES_REFERENCE) -> dict:
    """The record of ``scripts/port_jax_baselines_reference.py``: its arrays by
    name ("inputs/obs", "out/rnn", ...), with ``meta`` and ``jax_returns``
    parsed from their JSON."""
    with np.load(path) as z:
        rec = {k: z[k] for k in z.files}
    rec["meta"] = json.loads(str(rec["meta"]))
    rec["jax_returns"] = json.loads(str(rec["jax_returns"]))
    return rec


def load_family(family: str, device, dtype=torch.float32, z0_noise=None, config=None, env_name=BASELINE_ENV,
                delay=DELAY):
    """(model, params) of a baseline family on its tracked checkpoint of the
    cell (pendulum d1 by default), loaded into the model's own tree
    (``load_pytree(like=...)``). ``z0_noise`` replaces the latent ODE's fixed
    draw."""
    cfg = config or port.Config()
    spec = make_env(env_name).spec
    if family == "latent_ode" and z0_noise is not None:
        model = make_latent_ode_model(spec.n_obs, spec.m, norm_stats_for(env_name, spec.action_high, spec.m),
                                      dt=cfg.dt, dtype=dtype, device=device, z0_noise=torch.as_tensor(z0_noise))
    else:
        model = make_model(family, env_name, spec.n_obs, spec.m, spec.action_high, cfg, dtype=dtype, device=device)
    path = resolve_checkpoint(model_checkpoint_name(family, env_name, delay, "exp", 0, True))
    return model, load_pytree(path, like=model.init(torch.Generator(device=device).manual_seed(0)))


def latent_ode_accepted_steps(model, params, obs, abuf, ts, eps) -> torch.Tensor:
    """Each row's accepted dopri5 steps in the latent ODE's forward from
    z0 = z_mean + z_std * eps (the decode ``predict_diff`` runs)."""
    A = abuf.shape[1]
    z_mean, z_std = model.encode_history(params, obs[:, None].expand(-1, A, -1), abuf[..., :model.action_dim])
    t1 = ts.reshape(-1)
    _, n_acc = odeint_dopri5_with_stats(
        lambda z, _t: mlp_apply_tanh(params["dec_ode"], z), z_mean + z_std * eps,
        torch.stack([torch.zeros_like(t1), t1], dim=1), rtol=1e-3, atol=1e-4, max_steps=24)
    return n_acc[0]


def baseline_forwards(ref: dict, device) -> dict:
    """Each family's f32 forward on the card against the JAX package's f64
    forward on the reference's 1,000 queries, as ``rel_err``; the latent ODE
    on JAX's z0 draw, with the share of rows whose accepted dopri5 step count
    differs from JAX's, the error over the rows whose counts agree and over
    all rows, ``decoder_nfes`` against JAX's, and the carried dynamics over
    one 40-step horizon (the final states of all rows, every step's states
    of the first 100)."""
    q = [torch.as_tensor(ref[f"inputs/{k}"], device=device) for k in ("obs", "abuf", "ts")]
    out = {}
    with torch.no_grad():
        for family in BASELINE_FAMILIES:
            model, params = load_family(family, device, z0_noise=ref["latent_ode/z0"])
            t0 = time.perf_counter()
            got = model.apply(params, *q)
            torch.cuda.synchronize()
            exp = torch.as_tensor(ref[f"out/{family}"], device=device)
            rec = {"rel_err": rel_err(got.double(), exp), "max_abs_err": float((got.double() - exp).abs().max()),
                   "finite": bool(torch.isfinite(got).all()), "ms": 1e3 * (time.perf_counter() - t0)}
            if family == "latent_ode":
                eps = torch.as_tensor(ref["latent_ode/z0"], dtype=torch.float32, device=device)
                n_acc = latent_ode_accepted_steps(model, params, *q, eps).cpu().numpy()
                agree = n_acc == ref["latent_ode/n_acc"]
                row_err = ((got.double() - exp).abs() / (1.0 + exp.abs())).amax(dim=1).cpu().numpy()
                nfes = model.decoder_nfes(params, *q).cpu().numpy()
                rec.update({"steps_differ_share": float(1.0 - agree.mean()), "rel_err_all_rows": rec["rel_err"],
                            "rel_err": float(row_err[agree].max()) if agree.any() else math.inf,
                            "nfes": nfes.tolist(), "jax_nfes": ref["latent_ode/nfes"].tolist()})
                carry_init, dyn = make_carried_dynamics(model, params, DT, 3, 1)
                state = torch.as_tensor(ref["carried/state0"], device=device)
                full = torch.as_tensor(ref["carried/full"], device=device)
                carry, traced = carry_init(state), []
                for t in range(full.shape[1] - 3):
                    carry, state = dyn(carry, state, full[:, t:t + 4])
                    traced.append(state[:ref["carried/states"].shape[1]])
                rec["carried_final_rel_err"] = rel_err(state.double(), torch.as_tensor(ref["carried/final"],
                                                                                        device=device))
                rec["carried_steps_rel_err"] = rel_err(torch.stack(traced).double(),
                                                       torch.as_tensor(ref["carried/states"], device=device).double())
            out[family] = rec
    return out


def family_table_cells() -> list:
    """The tracked family checkpoints of the paper's table, as (family, env,
    delay): rnn on pendulum d0 and d1, delta_t_rnn, node and latent_ode on
    every env at delays 0-3."""
    return ([("rnn", "oderl-pendulum", d) for d in (0, 1)]
            + [(f, e, d) for f in FAMILY_TABLE_FAMILIES for e in ENVS for d in TABLE_DELAYS])


def read_jax_baselines_table(path=JAX_BASELINES_TABLE) -> dict:
    """``scripts/port_jax_baselines_reference.py --table``'s record: its arrays
    by name ("inputs/<env>/obs", "out/<family>/<env>/<delay>", ...) and
    ``meta`` parsed from its JSON."""
    with np.load(path) as z:
        rec = {k: z[k] for k in z.files}
    rec["meta"] = json.loads(str(rec["meta"]))
    return rec


def table_forwards(ref: dict, device) -> dict:
    """The f32 forward on the card of every tracked family checkpoint against
    the JAX package's f64 forward on the reference's 256 queries of its env,
    as ``rel_err``; the latent ODE on JAX's z0 draw, over the rows whose
    accepted dopri5 step counts agree with JAX's, with the share that differ.
    Each checkpoint must be the file the reference ran (sha256). Keyed
    ``"<env>/<delay>/<family>"``."""
    out = {}
    with torch.no_grad():
        for family, env_name, delay in family_table_cells():
            key = f"{env_name}/{delay}/{family}"
            pinned = ref["meta"]["checkpoints"].get(key)
            path = tracked_checkpoint_path(model_checkpoint_name(family, env_name, delay, "exp", 0, True))
            digest = hashlib.sha256(path.read_bytes()).hexdigest()
            if pinned is None or pinned["sha256"] != digest:
                raise RuntimeError(f"{JAX_BASELINES_TABLE} ran {key} on {pinned}, the tracked file is {path} "
                                   f"(sha256 {digest})")
            q = [torch.as_tensor(ref[f"inputs/{env_name}/{k}"], device=device) for k in ("obs", "abuf", "ts")]
            z0 = ref[f"latent_ode/{env_name}/z0"] if family == "latent_ode" else None
            model, params = load_family(family, device, z0_noise=z0, env_name=env_name, delay=delay)
            got = model.apply(params, *q).double()
            exp = torch.as_tensor(ref[f"out/{family}/{env_name}/{delay}"], device=device)
            rec = {"rel_err": rel_err(got, exp), "finite": bool(torch.isfinite(got).all())}
            if family == "latent_ode":
                eps = torch.as_tensor(z0, dtype=torch.float32, device=device)
                n_acc = latent_ode_accepted_steps(model, params, *q, eps).cpu().numpy()
                agree = n_acc == ref[f"n_acc/{env_name}/{delay}"]
                row_err = ((got - exp).abs() / (1.0 + exp.abs())).amax(dim=1).cpu().numpy()
                rec.update({"steps_differ_share": float(1.0 - agree.mean()), "rel_err_all_rows": rec["rel_err"],
                            "rel_err": float(row_err[agree].max()) if agree.any() else math.inf})
            out[key] = rec
    return out


def off_pendulum_cell(device, smi: str) -> dict:
    """``FAMILY_CELL_OFF_PENDULUM`` (delta_t_rnn on acrobot at delay 0: 2-d
    actions, no delay) at the paper's protocol through ``evaluate_policy``,
    its mean return against the JAX package's record of the cell by the
    3-sigma rule."""
    name, env_name, delay = FAMILY_CELL_OFF_PENDULUM
    model, params = load_family(name, device, env_name=env_name, delay=delay)
    r = evaluate_policy(name, env_name, delay, EVAL_SEEDS, port.Config(), model_apply=model.apply, params=params,
                        roll_outs=K, time_steps=T, device=device)
    gap, limit = three_sigma(r["total_rewards"], jax_cell_returns(env_name, delay, name))
    return {"family": name, "env": env_name, "delay": delay, **policy_stats(r),
            "returns": len(r["total_rewards"]), "gap_to_jax": gap, "limit": limit, "card": smi}


def baseline_segments(ref: dict, device, dtype=torch.float64, config=None) -> dict:
    """The reference's 20-update training segment of each family from its
    checkpoint at ``dtype``, on the same data and batch indices (and, for the
    latent ODE, JAX's IWAE draws): the largest relative gap of one update's
    loss to JAX's f64 run. ``config`` replaces the default (a planted fault)."""
    cfg = config or port.Config()
    data = read_jax_train_reference()["data"]
    s0, a0, sn, ts = (torch.as_tensor(data[k], dtype=dtype, device=device) for k in ("s0", "a0", "sn", "ts"))
    optimizer = make_optimizer(cfg)
    out = {}
    for family in BASELINE_FAMILIES:
        model, params = load_family(family, device, dtype=dtype, config=cfg)
        idx = torch.as_tensor(ref[f"train/{family}/batch_idx"], dtype=torch.long, device=device)
        t0 = time.perf_counter()
        if family == "latent_ode":
            windows = build_history_windows(s0, a0, sn, ts, cfg.action_buffer_size)
            eps = torch.as_tensor(ref["train/latent_ode/eps"], dtype=dtype, device=device)
            _, _, losses = make_latent_ode_segment_fn(model, optimizer)(params, optimizer.init(params), eps,
                                                                          *windows, idx)
        else:
            _, _, losses = make_train_segment_fn(model, optimizer)(params, optimizer.init(params), s0, a0, sn, ts,
                                                                   idx)
        losses = losses.double().cpu().numpy()
        exp = ref[f"train/{family}/losses"]
        out[family] = {"update_loss_rel_gap": float(np.max(np.abs(losses - exp) / np.abs(exp))),
                       "ms_per_update": 1e3 * (time.perf_counter() - t0) / len(losses),
                       "first_loss": float(losses[0]), "last_loss": float(losses[-1])}
    return out


def family_training(device, tmp: str) -> dict:
    """``train_model`` of each family on the first ``BASELINE_TRAIN_ROWS`` rows
    of the buffer phase ``collect`` wrote, from the port's init at the default
    config but for the epochs and the log cadence: node at batch size 1, the
    latent ODE through ``train_latent_ode``. Epoch mean losses, first and last."""
    rows = load_replay_buffer(Path(tmp) / replay_buffer_filename(COLLECT_ENV, DELAY), device=device)
    data_dir = Path(tmp) / "baselines"
    save_replay_buffer(data_dir / replay_buffer_filename(COLLECT_ENV, DELAY),
                       *(x[:BASELINE_TRAIN_ROWS] for x in rows))
    out = {}
    for family, (epochs, per_log, subset) in BASELINE_TRAINING.items():
        cfg = port.Config(offline_datasets_path=str(data_dir), saved_models_path=str(data_dir / "saved") + "/",
                          training_epochs=epochs, iters_per_log=per_log, training_use_only_samples=subset,
                          end_training_after_seconds=None)
        t0 = time.perf_counter()
        _, _, res = train_model(family, BASELINE_ENV, cfg, delay=DELAY, retrain=True, force_retrain=True,
                                device=device)
        torch.cuda.synchronize()
        out[family] = {"epochs": epochs, "iters_per_log": per_log, "samples": subset or BASELINE_TRAIN_ROWS,
                       "epoch_losses": res["epoch_losses"],
                       "wall_s": time.perf_counter() - t0}
    return out


def run_baselines(device, smi: str, tmp: str, baselines: dict) -> dict:
    """Phase ``baselines``: the four baseline families on pendulum d1 at full
    width, each held against the JAX package: the forwards on the card
    against JAX's f64 outputs; the 20-seed, 200-step evaluation of rnn,
    delta_t_rnn and node, with the oracle and random, against the JAX
    package's recorded returns; a cut episode of the latent ODE with carried
    history; ``train_model`` of each family on the collected buffer; and
    the reference's 20-update segments at f64. ``baselines`` holds the
    ``evaluate_policy`` results of random and the oracle on this cell (phase
    ``train`` runs them)."""
    ref = read_jax_baselines_reference()
    timings = {}
    t0 = time.perf_counter()
    forwards = baseline_forwards(ref, device)
    timings["forwards_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table_ref = read_jax_baselines_table()
    table_fwd = table_forwards(table_ref, device)
    timings["table_forwards_s"] = PART_SECONDS["baselines.table_forwards"] = time.perf_counter() - t0
    print("baselines " + json.dumps({"table_forwards": table_fwd, "rows": table_ref["meta"]["rows"], "card": smi}),
          flush=True)

    t0 = time.perf_counter()
    n = len(EVAL_SEEDS)
    results = {name: baselines[name] for name in ("random", "oracle")}
    families = {}
    for name in BASELINE_EVAL_FAMILIES:
        model, params = load_family(name, device)
        results[name] = evaluate_policy(name, BASELINE_ENV, DELAY, EVAL_SEEDS, port.Config(),
                                        model_apply=model.apply, params=params, roll_outs=K, time_steps=T,
                                        device=device)
        env_t, mppi_cfg, mppi_params, dynamics, _, _ = build_planner(
            name, BASELINE_ENV, DELAY, port.Config(), model_apply=model.apply, params=params, roll_outs=K,
            time_steps=T, device=device)
        tick = make_episode_fn(env_t, dynamics, mppi_cfg, mppi_params, EpisodeSettings(delay=DELAY, n_steps=1))
        families[name] = {"trace": trace_ticks(lambda: tick(SeedDraws(EVAL_SEEDS, device=device))[0].cpu(), 1,
                                               1e3 * results[name]["episode_elapsed_time"] / EVAL_STEPS)}
    timings["eval_s"] = time.perf_counter() - t0
    scores = normalized_scores(results.values(), agg="std")
    checks = {}
    for name, r in results.items():
        got = np.asarray(r["total_rewards"])
        jax_ret = np.asarray(ref["jax_returns"][name]["total_rewards"])
        gap = abs(float(got.mean() - jax_ret.mean()))
        limit = 3.0 * math.sqrt(jax_ret.var(ddof=1) / n + got.var(ddof=1) / n)
        line = {"family": name, **policy_stats(r), "jax_mean": float(jax_ret.mean()),
                "jax_std": float(jax_ret.std()), "gap_to_jax": gap, "limit": limit,
                "jax_file": ref["jax_returns"][name]["file"], "card": smi}
        if name in families:
            line["normalized_std"] = list(scores[(DELAY, BASELINE_ENV, name)][:2])
            line.update(families[name])
            line["forward"] = forwards[name]
            checks[name] = (gap, limit)
        families[name] = line
        print("baselines " + json.dumps(line), flush=True)

    t0 = time.perf_counter()
    off_cell = off_pendulum_cell(device, smi)
    timings["off_pendulum_cell_s"] = PART_SECONDS["baselines.off_pendulum_cell"] = time.perf_counter() - t0
    print("baselines " + json.dumps(off_cell), flush=True)

    # the latent ODE: a cut episode with carried history, 20 seeds in lockstep
    t0 = time.perf_counter()
    model, params = load_family("latent_ode", device)
    env_t, mppi_cfg, mppi_params, dynamics, carry_init, _ = build_planner(
        "latent_ode", BASELINE_ENV, DELAY, port.Config(), model_apply=model, params=params, roll_outs=K,
        time_steps=T, device=device)
    episodes = make_batched_episode_fn(env_t, dynamics, mppi_cfg, mppi_params,
                                       EpisodeSettings(delay=DELAY, n_steps=LATENT_ODE_STEPS),
                                       dynamics_carry_init=carry_init)
    totals, records = episodes(EVAL_SEEDS)
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t0
    tick_ms = 1e3 * cut_s / LATENT_ODE_STEPS
    timings["latent_ode_cut_episode_s"] = cut_s
    per_step = records.reward.cpu().numpy()
    states = records.sn.cpu().numpy()
    line = {"family": "latent_ode", "steps": LATENT_ODE_STEPS, "of_steps": EVAL_STEPS, "seeds": n,
            "cut_return_mean": float(totals.mean()), "reward_per_step_min": float(per_step.min()),
            "reward_per_step_mean": float(per_step.mean()), "episode_batch_s": cut_s, "tick_ms": tick_ms,
            "ticks_per_s": 1e3 / tick_ms, "forward": forwards["latent_ode"], "card": smi}
    families["latent_ode"] = line
    print("baselines " + json.dumps(line), flush=True)

    t0 = time.perf_counter()
    training = family_training(device, tmp)
    timings["train_model_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    segments = baseline_segments(ref, device)
    timings["segments_f64_s"] = time.perf_counter() - t0
    out = {"env": BASELINE_ENV, "delay": DELAY, "K": K, "T": T, "train_model": training,
           "segments_f64": segments, "timings": timings, "jax_commit": ref["meta"]["commit"], "card": smi}
    print("baselines " + json.dumps(out), flush=True)

    for family, rec in {**forwards, **table_fwd}.items():
        if not rec["finite"] or not rec["rel_err"] < BASELINE_FORWARD_TOL:
            raise RuntimeError(f"{family} forward: {rec['rel_err']} is not below {BASELINE_FORWARD_TOL}: {rec}")
    if len(table_fwd) != len(family_table_cells()):
        raise RuntimeError(f"{len(table_fwd)} family checkpoints' forwards checked, not {len(family_table_cells())}")
    if off_cell["returns"] != n or not off_cell["gap_to_jax"] <= off_cell["limit"]:
        raise RuntimeError(f"the off-pendulum family cell: {off_cell}")
    lode = forwards["latent_ode"]
    if not lode["carried_final_rel_err"] < BASELINE_FORWARD_TOL:
        raise RuntimeError(f"latent_ode carried horizon: {lode['carried_final_rel_err']} is not below "
                           f"{BASELINE_FORWARD_TOL}")
    if lode["nfes"] != lode["jax_nfes"]:
        raise RuntimeError(f"latent_ode decoder_nfes {lode['nfes']}, JAX {lode['jax_nfes']}")
    for name, (gap, limit) in checks.items():
        if not gap <= limit:
            raise RuntimeError(f"{name} mean return is {gap:.3f} from the JAX package's, over the limit {limit:.3f}")
    returns = [x for r in results.values() for x in r["total_rewards"]]
    if not all(math.isfinite(x) for x in returns):
        raise RuntimeError("non-finite episode return in the baselines' evaluation")
    state_max = np.asarray(env_t.state_max)
    if not (np.isfinite(per_step).all() and np.isfinite(states).all() and (per_step <= 0.0).all()
            and per_step.min() >= LATENT_ODE_MIN_REWARD):
        raise RuntimeError(f"latent_ode cut episode not finite and bounded: rewards {per_step.min()}..{per_step.max()}, "
                           f"state max {np.abs(states).max()} (box {state_max})")
    for family, rec in training.items():
        losses = rec["epoch_losses"]
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{family}: train_model's loss did not fall: {losses}")
    for family, rec in segments.items():
        if not rec["update_loss_rel_gap"] < BASELINE_SEGMENT_LIMIT:
            raise RuntimeError(f"{family} f64 segment: {rec['update_loss_rel_gap']} is not below "
                               f"{BASELINE_SEGMENT_LIMIT}")
    return {"families": families, "table_forwards": table_fwd, "off_pendulum_cell": off_cell, **out}


def three_sigma(a, b) -> tuple[float, float]:
    """The gap between two batches' mean returns and its limit, PERF.md
    section 2's rule: |mean_a - mean_b| <= 3 sqrt(s_a^2 / n_a + s_b^2 / n_b)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    gap = abs(float(a.mean() - b.mean()))
    return gap, 3.0 * math.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))


def reference_import(device, smi: str) -> dict:
    """The tracked reference checkpoint through ``interop``: imported on the
    card at the file's dtype and exported back (every tensor bit-exact to
    the file, the buffers included), the card's f32 forward against the
    CPU's f64 forward on the same rows, and the 20-seed batch of
    ``latent_ode_ref`` at K=1000, T=40, planned as ``evaluate_policy`` plans
    it (``build_planner``), cut to ``LOR_STEPS`` steps, with one tick traced."""
    from neurallaplacecontrol_tpu_torch import interop

    sd = interop.load_torch_state_dict(str(REF_LATENT_ODE_PT))
    raw = torch.load(REF_LATENT_ODE_PT, map_location="cpu", weights_only=True)
    arch = interop.latent_ode_arch_from_state_dict(sd)
    env = make_env(MAIN_ENV)
    spec = env.spec
    if (arch["state_dim"], arch["action_dim"]) != (spec.n_obs, spec.m):
        raise RuntimeError(f"{REF_LATENT_ODE_PT.name} is no {MAIN_ENV} model: {arch}")
    norm = norm_stats_for(MAIN_ENV, spec.action_high, spec.m)
    back = interop.latent_ode_state_dict_from_params(interop.latent_ode_params_from_state_dict(sd, device=device),
                                                     norm=norm, dt=float(sd["dt"]))
    mismatched = sorted(set(raw) ^ set(back)) + [
        k for k in raw if k in back and not (back[k].dtype == raw[k].numpy().dtype
                                             and np.array_equal(back[k], raw[k].numpy()))]

    cfg = port.Config(latent_ode_hidden_units=arch["hidden_units"])
    model = make_model("latent_ode_ref", MAIN_ENV, spec.n_obs, spec.m, spec.action_high, cfg, device=device)
    model64 = make_model("latent_ode_ref", MAIN_ENV, spec.n_obs, spec.m, spec.action_high, cfg,
                         dtype=torch.float64, device="cpu")
    params = interop.latent_ode_params_from_state_dict(sd, device=device, dtype=torch.float32)
    params64 = interop.latent_ode_params_from_state_dict(sd, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(30)
    A = cfg.action_buffer_size
    obs = rng.standard_normal((K, spec.n_obs)) * norm.state_std
    acts = rng.uniform(-spec.action_high, spec.action_high, (K, A, spec.m))
    ts = np.full((K, 1), cfg.dt)
    got = model.apply(params, *(torch.tensor(x, dtype=torch.float32, device=device) for x in (obs, acts, ts)))
    exp = model64.apply(params64, *(torch.tensor(x) for x in (obs, acts, ts)))
    forward = {"rows": K, "rel_err": rel_err(got.double().cpu(), exp), "finite": bool(torch.isfinite(got).all()),
               "max_abs_out": float(exp.abs().max()), "limit": LOR_FORWARD_TOL,
               "euler_substeps": sum(len(s) for _, s in model.substep_plan)}

    env_t, mppi_cfg, mppi_params, dynamics, carry_init, _ = build_planner(
        "latent_ode_ref", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K,
        time_steps=T, device=device)
    episodes = make_batched_episode_fn(env_t, dynamics, mppi_cfg, mppi_params,
                                       EpisodeSettings(delay=DELAY, n_steps=LOR_STEPS),
                                       dynamics_carry_init=carry_init)
    t0 = time.perf_counter()
    totals, records = episodes(EVAL_SEEDS)
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t0
    tick = make_episode_fn(env_t, dynamics, mppi_cfg, mppi_params, EpisodeSettings(delay=DELAY, n_steps=1))
    trace = trace_ticks(lambda: tick(SeedDraws(EVAL_SEEDS, device=device))[0].cpu(), 1,
                        1e3 * cut_s / LOR_STEPS)
    print("trace " + json.dumps({"model": "latent_ode_ref", **trace}), flush=True)
    per_step = records.reward.cpu().numpy()
    states = records.sn.cpu().numpy()
    out = {"file": str(REF_LATENT_ODE_PT.relative_to(ROOT)), "tensors": len(raw), "arch": arch,
           "export_mismatched": mismatched, "forward": forward, "env": MAIN_ENV, "delay": DELAY, "K": K, "T": T,
           "steps": LOR_STEPS, "of_steps": EVAL_STEPS, "seeds": len(EVAL_SEEDS),
           "cut_return_mean": float(totals.mean()), "reward_per_step_min": float(per_step.min()),
           "reward_per_step_mean": float(per_step.mean()), "episode_batch_s": cut_s,
           "tick_ms": 1e3 * cut_s / LOR_STEPS, "trace": trace, "card": smi}
    print("precision reference " + json.dumps(out), flush=True)
    if mismatched:
        raise RuntimeError(f"{REF_LATENT_ODE_PT.name} does not export back bit-exact: {mismatched}")
    if not (forward["finite"] and forward["rel_err"] < LOR_FORWARD_TOL):
        raise RuntimeError(f"latent_ode_ref f32 forward on the card: {forward}")
    if not (np.isfinite(per_step).all() and np.isfinite(states).all() and (per_step <= 0.0).all()
            and per_step.min() >= LOR_MIN_REWARD):
        raise RuntimeError(f"latent_ode_ref cut episode not finite and bounded: rewards "
                           f"{per_step.min()}..{per_step.max()}")
    return out


def plan_ms(ctrl, obs, noise, reps: int):
    """Mean wall time of one plan of ``ctrl`` from ``obs`` on ``noise``, each
    plan ended by reading its action on the host, after two warm-up plans;
    returns (ms, the last action)."""
    state = ctrl.reset(0)
    for _ in range(2):
        ctrl.step(state, obs, noise=noise)[0].cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        action = ctrl.step(state, obs, noise=noise)[0].cpu()
    return 1e3 * (time.perf_counter() - t0) / reps, action


def run_precision(device, smi: str, eval_returns) -> dict:
    """Phase ``precision``: ``reference_import``, then the trained
    cartpole-d1 NL in bfloat16 and in int8 beside the float32 routes: the
    bf16 forward against the f32 one (tests/test_models.py's bounds), int8's
    int32 sums on the card against the CPU's and the exact integer product
    bit for bit, its forward's error envelope (tests/test_quant.py's bounds)
    and ``planner_saturation_probe``, the 20-seed 200-step batches of bf16
    (plain route) and int8, and one plan's time at each K of ``PLAN_KS`` for
    every route. The bf16 config with ``fused_nl_planner`` must launch the
    forward kernel (at f32) and plan as the f32 kernel route does.

    The batches are held by ``three_sigma`` to the JAX package's batches of
    the same precision (``JAX_PRECISION_REFERENCE``, made by
    ``scripts/port_jax_precision_reference.py``), and int8 also to phase
    ``eval``'s f32 batch (``eval_returns``). bf16's gap to the f32 batch is
    printed, not held: bf16 compute plans this cell better than f32 by 10-18
    in both packages (PERF.md section 6), beyond the rule's limit."""
    from neurallaplacecontrol_tpu_torch.ops import quant

    failures = []
    jax_ref = json.loads(JAX_PRECISION_REFERENCE.read_text())
    if (jax_ref["env"], jax_ref["delay"], jax_ref["seeds"]) != (MAIN_ENV, DELAY, EVAL_SEEDS):
        raise RuntimeError(f"{JAX_PRECISION_REFERENCE} holds another cell: {jax_ref['env']} d{jax_ref['delay']}")
    reference = reference_import(device, smi)

    env, params, m32 = load_nl(MAIN_ENV, device)
    spec = env.spec
    cfg32, cfg_bf = port.Config(), port.Config(nl_compute_dtype="bfloat16")
    mbf = make_model("nl", MAIN_ENV, spec.n_obs, spec.m, spec.action_high, cfg_bf, device=device)
    norm = norm_stats_for(MAIN_ENV, spec.action_high, spec.m)
    qapply = quant.quantized_apply_for("nl", MAIN_ENV, params, cfg32, spec, fold_t=float(cfg32.dt))

    # bf16 against f32 on the trained weights
    rng = np.random.default_rng(31)
    obs = torch.tensor(rng.standard_normal((BF16_ROWS, spec.n_obs)), dtype=torch.float32, device=device)
    abuf = torch.tensor(rng.uniform(-3.0, 3.0, (BF16_ROWS, 4, spec.m)), dtype=torch.float32, device=device)
    ts = torch.full((BF16_ROWS, 1), cfg32.dt, device=device)
    a, b = m32.apply(params, obs, abuf, ts), mbf.apply(params, obs, abuf, ts)
    rel = ((b - a).abs() / (1.0 + a.abs())).flatten()
    bf16 = {"rows": BF16_ROWS, "rel_max": float(rel.max()), "rel_median": float(rel.median()),
            "out_dtype": str(b.dtype).removeprefix("torch."), "limits": [BF16_MAX_LIMIT, BF16_MEDIAN_LIMIT]}
    if not (bool(torch.isfinite(b).all()) and bf16["rel_max"] < BF16_MAX_LIMIT
            and bf16["rel_median"] < BF16_MEDIAN_LIMIT and b.dtype == torch.float32):
        failures.append(f"bf16 forward against f32: {bf16}")

    # int8: the int32 sums bit for bit, the error envelope, the saturation probe
    q = quant.quantize_nl_params(params, state_dim=spec.n_obs, action_dim=spec.m,
                                 s_recon_terms=cfg32.nl_s_recon_terms)
    operands = {f"gru{i}_{w}": (layer[f"wq_{w}"], layer[f"wq_{w}_mm"])
                for i, layer in enumerate(q["gru"]) for w in ("ih", "hh")}
    operands.update({"enc_out": (q["enc_out"]["wq"], q["enc_out"]["wq_mm"]),
                     **{f"mlp{i}": (layer["wq"], layer["wq_mm"]) for i, layer in enumerate(q["mlp"])}})
    g = torch.Generator().manual_seed(32)
    acc = {"layers": list(operands), "rows": list(INT8_ACC_ROWS), "mismatched": []}
    for name, (wq, wq_mm) in operands.items():
        for rows in INT8_ACC_ROWS:
            xq = torch.randint(-127, 128, (rows, wq.shape[0]), generator=g, dtype=torch.int8)
            card = quant.int8_matmul_int32(xq.to(device), wq_mm)[:, :wq.shape[1]].cpu()
            cpu = quant.int8_matmul_int32(xq, wq_mm.cpu())[:, :wq.shape[1]]
            exact = (xq.long() @ wq.cpu().long()).int()
            if not (card.dtype == torch.int32 and torch.equal(card, cpu) and torch.equal(card, exact)):
                acc["mismatched"].append([name, rows])
    if acc["mismatched"]:
        failures.append(f"int8 int32 sums differ from the CPU's: {acc['mismatched']}")
    rng = np.random.default_rng(33)
    obs = torch.tensor(rng.standard_normal((INT8_ROWS, spec.n_obs)) * np.array([1.5, 6.0, 0.7, 0.7, 9.0]),
                       dtype=torch.float32, device=device)
    abuf = torch.tensor(rng.uniform(-3.0, 3.0, (INT8_ROWS, 4, spec.m)), dtype=torch.float32, device=device)
    ts = torch.full((INT8_ROWS, 1), cfg32.dt, device=device)
    ref, out = m32.apply(params, obs, abuf, ts), qapply(None, obs, abuf, ts)
    err = (out - ref).abs()
    int8 = {"rows": INT8_ROWS, "median_abs_err": float(err.median()),
            "mean_abs_err_over_std": float(err.mean() / ref.std()),
            "limits": [INT8_MEDIAN_LIMIT, INT8_SPREAD_LIMIT], "int32_sums": acc}
    if not (bool(torch.isfinite(out).all()) and int8["median_abs_err"] < INT8_MEDIAN_LIMIT
            and int8["mean_abs_err_over_std"] < INT8_SPREAD_LIMIT):
        failures.append(f"int8 forward's error envelope: {int8}")
    obs0 = env.observe(env.reset(torch.Generator().manual_seed(0))).to(device)
    int8["saturation"] = quant.planner_saturation_probe(
        m32.apply, params, norm, obs0, action_high=spec.action_high, action_dim=spec.m, K=SATURATION_K, T=T,
        dt=cfg32.dt, generator=torch.Generator(device=device).manual_seed(1),
        action_buffer_size=cfg32.action_buffer_size)
    sat = int8["saturation"]["clip_frac_per_step"]
    if len(sat) != T or not all(0.0 <= f <= 1.0 for f in sat):
        failures.append(f"saturation probe: {int8['saturation']}")

    # the forward kernel at the largest plan's rows against its plain version
    # (a comparison: its launches are not counted)
    kernel_check = check_forward_rows(device, MAIN_ENV, max(PLAN_KS))

    # the 20-seed batches, then one plan per route at each K
    pallas_nl.nl_forward_fused.launches = 0
    pallas_ilt.nl_head_fused.launches = 0
    batches = {}
    for name, cfg, apply in (("bf16", cfg_bf, mbf.apply), ("int8", cfg32, qapply)):
        r = evaluate_policy("nl", MAIN_ENV, DELAY, EVAL_SEEDS, cfg, model_apply=apply, params=params,
                            roll_outs=K, time_steps=T, device=device)
        jax_returns = jax_ref["policies"][name]["total_rewards"]
        gap, limit = three_sigma(r["total_rewards"], eval_returns)
        jax_gap, jax_limit = three_sigma(r["total_rewards"], jax_returns)
        env_t, mppi_cfg, mppi_params, dynamics, _, _ = build_planner(
            "nl", MAIN_ENV, DELAY, cfg, model_apply=apply, params=params, roll_outs=K, time_steps=T, device=device)
        tick = make_episode_fn(env_t, dynamics, mppi_cfg, mppi_params, EpisodeSettings(delay=DELAY, n_steps=1))
        tick_ms = 1e3 * r["episode_elapsed_time"] / EVAL_STEPS
        batches[name] = {**policy_stats(r), "tick_ms": tick_ms, "f32_mean": float(np.mean(eval_returns)),
                         "gap_to_f32": gap, "limit": limit, "jax_mean": float(np.mean(jax_returns)),
                         "jax_std": float(np.std(jax_returns)), "gap_to_jax": jax_gap, "jax_limit": jax_limit,
                         "jax_commit": jax_ref["commit"],
                         "trace": trace_ticks(lambda: tick(SeedDraws(EVAL_SEEDS, device=device))[0].cpu(), 1,
                                              tick_ms)}
        if not all(math.isfinite(x) for x in r["total_rewards"]):
            failures.append(f"{name} 20-seed batch: non-finite return")
        if not jax_gap <= jax_limit:
            failures.append(f"{name} 20-seed batch: mean {batches[name]['mean']:.3f} is {jax_gap:.3f} from the JAX "
                            f"package's {name} batch, over the limit {jax_limit:.3f}")
        if name == "int8" and not gap <= limit:
            failures.append(f"int8 20-seed batch: mean {batches[name]['mean']:.3f} is {gap:.3f} from the f32 "
                            f"batch's, over the limit {limit:.3f}")
    if pallas_nl.nl_forward_fused.launches:
        failures.append(f"the bf16 and int8 batches launched the forward kernel "
                        f"{pallas_nl.nl_forward_fused.launches} times")

    routes = {
        "f32_plain": (cfg32, m32.apply), "bf16_plain": (cfg_bf, mbf.apply),
        "f32_kernel": (cfg32.replace(fused_nl_planner=True), m32.apply),
        "bf16_kernel": (cfg_bf.replace(fused_nl_planner=True), mbf.apply), "int8": (cfg32, qapply),
    }
    plans = []
    for k_rows in PLAN_KS:
        reps = PLAN_REPS[k_rows]
        g = torch.Generator(device=device).manual_seed(34)
        line, actions, noise = {"K": k_rows, "T": T, "reps": reps, "card": smi}, {}, None
        for name, (cfg, apply) in routes.items():
            ctrl = port.make_controller("nl", MAIN_ENV, DELAY, cfg, model_apply=apply, params=params,
                                        roll_outs=k_rows, time_steps=T, device=device)
            if noise is None:  # one draw for every route
                noise = torch.randn((k_rows, T, spec.m), generator=g, device=device) @ ctrl.mppi_params.noise_chol.T
            before = pallas_nl.nl_forward_fused.launches
            line[f"{name}_ms"], actions[name] = plan_ms(ctrl, obs0, noise, reps)
            line[f"{name}_launches"] = pallas_nl.nl_forward_fused.launches - before
        line["bf16_kernel_action_diff"] = float((actions["bf16_kernel"] - actions["f32_kernel"]).abs().max())
        plans.append(line)
        print("precision plan " + json.dumps(line), flush=True)
        if line["bf16_kernel_launches"] != (2 + reps) * T or line["bf16_kernel_action_diff"] != 0.0:
            failures.append(f"the bf16 config with the fused planner at K={k_rows} launched the kernel "
                            f"{line['bf16_kernel_launches']} times (expected {(2 + reps) * T}) and planned "
                            f"{line['bf16_kernel_action_diff']} from the f32 kernel route")
    launches = pallas_nl.nl_forward_fused.launches
    if pallas_ilt.nl_head_fused.launches:
        failures.append(f"nl_head launched {pallas_ilt.nl_head_fused.launches} times in phase precision")

    out = {"env": MAIN_ENV, "delay": DELAY, "K": K, "T": T, "bf16_forward": bf16, "int8_forward": int8,
           "batches": batches, "plans": plans, "launches": launches, "kernel_check": kernel_check, "card": smi}
    print("precision " + json.dumps(out), flush=True)
    if failures:
        raise RuntimeError("phase precision: " + "; ".join(failures))
    return {**out, "reference": reference}


class RecordedDraws:
    """``oderl.OderlDraws`` that keeps every draw it makes, so that the f32
    run of a family can replay the f64 run's draws (``replay``)."""

    def __init__(self, generator):
        self.draws, self.items = OderlDraws(generator), []

    def _keep(self, value):
        self.items.append(value)
        return value

    def f_noise(self, net, params, L, rows=1):
        return self._keep(self.draws.f_noise(net, params, L, rows))

    def pets(self, T, L, PN, n, dtype):
        return self._keep(self.draws.pets(T, L, PN, n, dtype))

    def moments(self, T, L, N, n, dtype):
        return self._keep(self.draws.moments(T, L, N, n, dtype))

    def randint(self, high, n):
        return self._keep(self.draws.randint(high, n))

    def replay(self, dtype):
        """The draws again, in order, float64 tensors cast to ``dtype``."""
        def cast(x):
            if torch.is_tensor(x):
                return x.to(dtype) if x.dtype == torch.float64 else x
            if isinstance(x, (list, tuple)):
                return type(x)(cast(v) for v in x)
            if isinstance(x, dict):
                return {k: cast(v) for k, v in x.items()}
            return x

        return ListDraws([cast(v) for v in self.items])


class ListDraws:
    """The methods of ``oderl.OderlDraws`` over a list of draws, one a call."""

    def __init__(self, items):
        self.items = list(items)

    def _next(self, *_args, **_kw):
        return self.items.pop(0)

    f_noise = pets = moments = randint = _next


class ArtifactDraws:
    """The JAX run's draws of an ENODE trainer: ENODE draws no function
    noise, so ``f_noise`` is None, and ``randint`` hands over the recorded
    indices in the order the trainer asks for them."""

    def __init__(self, *index_arrays, device):
        self.items = [torch.as_tensor(x, dtype=torch.long, device=device) for row in zip(*index_arrays) for x in row]

    def f_noise(self, net, params, L, rows=1):
        return None

    def randint(self, high, n):
        return self.items.pop(0)


class ArtifactSyntheticDraws:
    """``data.SyntheticDraws``' methods over the JAX latent generator's draws."""

    def __init__(self, ref, device):
        self.ref, self.dtype, self.device = ref, torch.float64, device

    def _t(self, key):
        return torch.as_tensor(self.ref[key], dtype=torch.float64, device=self.device)

    def states_actions(self, rounds, n_states, state_dim, n_actions, action_dim, shared):
        return self._t("latent/u_states"), self._t("latent/u_actions")

    def grid_dts(self, ts_grid, dt, rounds):
        return self._t("latent/grid_dts")

    def buffer(self, n, size, action_dim):
        return self._t("latent/u_buffer")


def read_jax_research_reference(path=JAX_RESEARCH_REFERENCE) -> dict:
    """The artifact's arrays, ``meta`` parsed; refuses a reference made from
    JAX sources that differ from this checkout's."""
    with np.load(path) as z:
        ref = {k: z[k] for k in z.files}
    ref["meta"] = json.loads(str(ref["meta"]))
    stale = [f for f, digest in ref["meta"]["sources"].items()
             if hashlib.sha256((ROOT / f).read_bytes()).hexdigest() != digest]
    if stale:
        raise RuntimeError(f"{path.name} was made from other JAX sources than this checkout's: {stale}")
    return ref


def _tree(ref, prefix, device, dtype=torch.float64):
    return from_jax_params(unflatten_params({k[len(prefix) + 1:]: v for k, v in ref.items()
                                             if k.startswith(prefix + "/")}), device=device, dtype=dtype)


def _rel_losses(got, exp) -> float:
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.max(np.abs(got - exp) / np.abs(exp)))


def research_families(device) -> dict:
    """Part 1: ``forward_simulate`` of each dynamics family at ``DEFAULTS``
    (full width) from 100 states, f32 against the port's f64 on the same
    init and draws."""
    env = make_env(RESEARCH_ENV)
    s0 = env.observe(torch.stack([env.reset(torch.Generator(device=device).manual_seed(i), torch.float64, device)
                                  for i in range(RESEARCH_ROWS)]))
    out = {}
    for fam in oderl.DYNAMICS_FAMILIES:
        c64 = oderl.make_ctrl(env, fam, dtype=torch.float64, device=device)
        c32 = oderl.make_ctrl(env, fam, dtype=torch.float32, device=device)
        p32 = c32.init(torch.Generator(device=device).manual_seed(0))
        p64 = cast_params(p32, torch.float64)
        rec = RecordedDraws(torch.Generator(device=device).manual_seed(1))
        kw = dict(L=10, tau=RESEARCH_TAU, compute_rew=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st64, rt64, _ = c64.forward_simulate(p64, rec, RESEARCH_H, s0, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st32, rt32, _ = c32.forward_simulate(p32, rec.replay(torch.float32), RESEARCH_H, s0.float(), **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[fam] = {"shape": list(st32.shape), "st_rel_err": rel_err(st32.double(), st64),
                    "rt_rel_err": rel_err(rt32.double(), rt64), "f64_s": t1 - t0, "f32_s": t2 - t1,
                    "finite": bool(torch.isfinite(st32).all() and torch.isfinite(rt32).all())}
    return out


def research_enode_vs_jax(device, ref) -> dict:
    """Part 2: ENODE at f64 on JAX's init, data and draws: ``simulate_enode``
    and the first updates of each trainer at its default arguments (20, and
    ``RESEARCH_POLICY_UPDATES`` of ``train_policy``)."""
    env = make_env(RESEARCH_ENV)
    ctrl = oderl.make_ctrl(env, "enode", dtype=torch.float64, device=device)
    params = oderl.ctrl_params_from_jax(ctrl, _tree(ref, "enode/init", "cpu"))
    D = oderl.Dataset(*(torch.as_tensor(ref[f"data/{k}"], device=device) for k in oderl.Dataset._fields))
    n = int(ref["gm/losses"].shape[0])
    out = {}
    st, rt, ts = ctrl.forward_simulate(params, ArtifactDraws(device=device), RESEARCH_H,
                                       torch.as_tensor(ref["sim/s0"], device=device), L=10, tau=RESEARCH_TAU,
                                       compute_rew=True)
    rows = int(ref["sim/st_head"].shape[1])
    t = lambda k: torch.as_tensor(ref[k], device=device)  # noqa: E731
    out["simulate_rel_err"] = max(rel_err(st[:, :, -1], t("sim/st_last")), rel_err(rt[:, :, -1], t("sim/rt_last")),
                                  rel_err(st[:, :rows], t("sim/st_head")), rel_err(rt[:, :rows], t("sim/rt_head")),
                                  rel_err(ts, t("sim/ts")))
    probe_x = t("probe/x")[None].expand(10, -1, -1)
    timings = {}

    def timed(name, updates, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timings[name] = 1e3 * (time.perf_counter() - t0) / updates
        return res

    p, losses = timed("gradient_match", n, lambda: oderl.gradient_match(
        ctrl, params, D, ArtifactDraws(device=device), n_iter=n))
    out["gradient_match"] = {"max_rel": _rel_losses(losses, ref["gm/losses"]),
                             "probe_rel_err": rel_err(ctrl.f_net.apply(p["f"], probe_x), t("gm/probe_f"))}
    p, losses = timed("train_dynamics", n, lambda: oderl.train_dynamics(
        ctrl, params, D, ArtifactDraws(ref["dyn/traj"], ref["dyn/start"], device=device), n_iter=n, log_every=0))
    out["train_dynamics"] = {"max_rel": _rel_losses(losses, ref["dyn/losses"]),
                             "probe_rel_err": max(rel_err(ctrl.f_net.apply(p["f"], probe_x), t("dyn/probe_f")),
                                                  rel_err(p["logsn"], t("dyn/logsn")))}
    n_pol = min(n, RESEARCH_POLICY_UPDATES)
    p, rewards = timed("train_policy", n_pol, lambda: oderl.train_policy(
        ctrl, params, D, ArtifactDraws(ref["pol/idx"][:n_pol], device=device), n_iter=n_pol, log_every=0))
    out["train_policy"] = {"max_rel": _rel_losses(rewards, ref["pol/rewards"][:n_pol]), "updates": n_pol}
    if n_pol == n:  # the artifact's probes are of the params after all its updates
        out["train_policy"]["probe_rel_err"] = max(rel_err(ctrl.policy_apply(p, t("probe/s")), t("pol/probe_g")),
                                                   rel_err(ctrl.value_apply(p, t("probe/s")), t("pol/probe_V")))
    out["updates"], out["ms_per_update"] = n, timings
    return out


def research_demo(device, tmp: str) -> dict:
    """Part 3: ``scripts/oderl_demo_torch.py`` in f32 at its own sizes, then a
    few updates of each trainer on its result under ``trace_ticks``."""
    from scripts import oderl_demo_torch as demo

    dyn = {**demo.DYN, "n_iter": RESEARCH_DEMO_DYN_UPDATES}
    pol = {**demo.POL, "n_iter": RESEARCH_DEMO_POL_UPDATES}
    res = demo.main(device=device, out=str(Path(tmp) / "oderl"), dyn=dyn, pol=pol)
    out = {}
    n_updates = {"gradient_match": demo.GM["n_iter"], "train_dynamics": dyn["n_iter"], "train_policy": pol["n_iter"]}
    for name, n in n_updates.items():
        losses = np.asarray(res[name]["losses"])
        k = max(1, n // 10)
        out[name] = {"updates": n, "first_mean": float(losses[:k].mean()), "last_mean": float(losses[-k:].mean()),
                     "ms_per_update": 1e3 * res[name]["seconds"] / n}
        # the drift and segment fits lower their losses; the policy raises the
        # imagined return, compared on every stored state before and after
        before, after = res[name].get("imagined_return", (out[name]["first_mean"], out[name]["last_mean"]))
        out[name]["improved"] = after > before if name == "train_policy" else after < before
        if name == "train_policy":
            out[name]["imagined_return_before"], out[name]["imagined_return_after"] = before, after
    ctrl = oderl.make_ctrl(make_env(RESEARCH_ENV), "enode", device=device, **demo.SIZES)
    params = ctrl.load(res["checkpoint"])
    D = oderl.collect_data(ctrl.env, 2.0, 8, torch.Generator(device=device).manual_seed(2), device=device)
    g = torch.Generator(device=device).manual_seed(3)
    runs = {
        "gradient_match": lambda: oderl.gradient_match(ctrl, params, D, g, n_iter=RESEARCH_TRACE_UPDATES,
                                                       lr=demo.GM["lr"]),
        "train_dynamics": lambda: oderl.train_dynamics(ctrl, params, D, g, n_iter=RESEARCH_TRACE_UPDATES,
                                                       n_seg=demo.DYN["n_seg"], log_every=0),
        "train_policy": lambda: oderl.train_policy(ctrl, params, D, g, log_every=0,
                                                   **{**pol, "n_iter": RESEARCH_TRACE_UPDATES}),
    }
    for name, run in runs.items():
        trace = trace_ticks(run, RESEARCH_TRACE_UPDATES, out[name]["ms_per_update"])
        out[name].update({k: trace[k] for k in ("device_ops_per_tick", "device_busy_ms_per_tick", "idle_share",
                                                "traced_tick_ms")})
    return out


def research_sequences(device, ref) -> dict:
    """Part 4: ODE-RNN, GRU and GRU-D at their default widths, 60 f64 Adam
    updates of the reconstruction MSE on JAX's irregular sine and init."""
    x, ts = (torch.as_tensor(ref[k], device=device) for k in ("seq/x", "seq/ts"))
    makers = {"ode_rnn": lambda: seq_baselines.make_ode_rnn(1, device=device),
              "gru": lambda: seq_baselines.make_classic_rnn(1, cell="gru", device=device),
              "expdecay": lambda: seq_baselines.make_classic_rnn(1, cell="expdecay", device=device)}
    out = {}
    for name, make in makers.items():
        model = make()
        params = seq_baselines.sequence_params_from_jax(model, _tree(ref, f"seq/{name}/init", "cpu"))
        opt = make_adam(1e-2)
        state = opt.init(params)
        losses = []
        for _ in range(int(ref[f"seq/{name}/losses"].shape[0])):
            leaves = [v.detach().requires_grad_(True) for v in tree_leaves(params)]
            loss = torch.mean((model.reconstruct(tree_unflatten(params, leaves), x, ts) - x) ** 2)
            updates, state = opt.update(tree_unflatten(params, list(torch.autograd.grad(loss, leaves))), state)
            params = tree_unflatten(params, [(a + u).detach() for a, u in zip(tree_leaves(params),
                                                                             tree_leaves(updates))])
            losses.append(loss.detach())
        out[name] = {"max_rel": _rel_losses([float(v) for v in losses], ref[f"seq/{name}/losses"]),
                     "encode_rel_err": rel_err(model.encode(params, x, ts),
                                               torch.as_tensor(ref[f"seq/{name}/encode"], device=device))}
    return out


def research_latent(device, ref) -> dict:
    """Part 5: the latent generator on cartpole (``latent=True``, delay 2) on
    JAX's draws, and both two-frame oracles, at f64."""
    env = make_env("oderl-cartpole", ts_grid="exp")
    got = generate_irregular_data_delay_latent(env, ArtifactSyntheticDraws(ref, device), 2, samples_per_dim=3,
                                               rand=True, latent=True)
    t = lambda k: torch.as_tensor(ref[k], device=device)  # noqa: E731
    out = {"generator_rel_err": max(rel_err(g, t(f"latent/{k}")) for k, g in zip(("s0", "a0", "sb", "sn", "ts"),
                                                                                  got)),
           "rows": int(got[0].shape[0])}
    trig, prev, act, ts = t("oracle/trig"), t("oracle/trig_prev"), t("oracle/action"), t("oracle/ts")
    out["oracle_rel_err"] = max(
        rel_err(cartpole_dynamics_dt_latent(trig, prev, act, ts), t("oracle/latent")),
        rel_err(cartpole_dynamics_dt_latent_reduced(trig[:, [0, 2, 3]], prev[:, [0, 2, 3]], act, ts),
                t("oracle/latent_reduced")))
    return out


def run_research(device, smi: str, tmp: str) -> dict:
    """Phase ``research``: the modules off the paper's path, on the card.
    1. The five dynamics families' f32 rollouts against their f64 ones
    (``RESEARCH_F32_TOL``). 2. ENODE against the JAX package at f64 on its
    init, data and draws (``JAX_RESEARCH_REFERENCE``): ``simulate_enode``
    (``RESEARCH_SIM_TOL``) and each trainer's first updates, 20 of
    ``gradient_match`` and ``train_dynamics`` and ``RESEARCH_POLICY_UPDATES`` of
    ``train_policy`` (``RESEARCH_UPDATE_TOL``). 3. The f32 demo at its widths with its
    iterations cut (``RESEARCH_DEMO_*``), each fit improving, with each
    trainer's update time and device trace. 4. The sequence models' 60
    updates (``RESEARCH_SEQ_TOL``). 5. The latent data
    (``RESEARCH_LATENT_TOL``). One ``research <part> {...}`` line per part."""
    ref = read_jax_research_reference()
    failures, out, seconds = [], {}, {}
    parts = (("families", lambda: research_families(device)), ("enode", lambda: research_enode_vs_jax(device, ref)),
             ("demo", lambda: research_demo(device, tmp)), ("sequences", lambda: research_sequences(device, ref)),
             ("latent", lambda: research_latent(device, ref)))
    for name, run in parts:
        t0 = time.perf_counter()
        out[name] = run()
        seconds[name] = time.perf_counter() - t0
        print(f"research {name} " + json.dumps({**out[name], "part_s": seconds[name], "card": smi}), flush=True)
    for fam, r in out["families"].items():
        if not (r["finite"] and max(r["st_rel_err"], r["rt_rel_err"]) < RESEARCH_F32_TOL):
            failures.append(f"{fam}: f32 rollout {max(r['st_rel_err'], r['rt_rel_err']):.3e} from f64")
    if not out["enode"]["simulate_rel_err"] < RESEARCH_SIM_TOL:
        failures.append(f"simulate_enode {out['enode']['simulate_rel_err']:.3e} from JAX's")
    for name in ("gradient_match", "train_dynamics", "train_policy"):
        if not out["enode"][name]["max_rel"] < RESEARCH_UPDATE_TOL:
            failures.append(f"{name}: an update {out['enode'][name]['max_rel']:.3e} from JAX's")
        if not out["demo"][name]["improved"]:
            failures.append(f"demo {name}: no improvement ({out['demo'][name]})")
    for name, r in out["sequences"].items():
        if not r["max_rel"] < RESEARCH_SEQ_TOL:
            failures.append(f"sequence model {name}: an update {r['max_rel']:.3e} from JAX's")
    if not max(out["latent"]["generator_rel_err"], out["latent"]["oracle_rel_err"]) < RESEARCH_LATENT_TOL:
        failures.append(f"latent data {out['latent']}")
    if failures:
        raise RuntimeError("phase research: " + "; ".join(failures))
    return {**out, "seconds": seconds}


def driver_args(tmp: str, part: str, *args) -> list:
    """The driver's command line for one part of phase ``driver``: its results,
    logs and checkpoints under ``tmp/driver/<part>``, on the card."""
    out = Path(tmp) / "driver" / part
    return ["--device", "cuda", "--results", str(out / "results.jsonl"), "--log_folder", str(out / "logs"),
            "--saved_models_path", str(out / "saved") + "/", *args]


def protocol_mismatch(rec: dict, delay: int, seeds) -> list:
    """The fields of a JAX record that differ from the protocol this run holds
    it to (K rollouts, horizon T, seeds 0-19, the cell's delay), as
    ``name=recorded``."""
    want = {"roll_outs": K, "time_steps": T, "seeds": EVAL_SEEDS, "delay": delay}
    got = {"roll_outs": rec.get("roll_outs"), "time_steps": rec.get("time_steps"), "seeds": seeds,
           "delay": rec.get("delay")}
    return [f"{k}={got[k]}" for k in want if got[k] != want[k]]


def jax_cell_returns(env_name: str, delay: int, model_name: str, encode_obs_time: bool = False) -> np.ndarray:
    """The JAX package's per-seed returns of one cell: NL's from its run at
    HEAD (``JAX_TABLE_REFERENCE``), on the tracked checkpoint that the table
    loads here (its path and sha256 must match the reference's) and under
    the same ``encode_obs_time``; rnn's from its runs (``JAX_RNN_RESULTS``);
    the others' from the full run's records (``JAX_RESULTS``). A record made
    under another protocol than this run's (``protocol_mismatch``) is
    refused."""
    if model_name == "nl":
        ref = json.loads(JAX_TABLE_REFERENCE.read_text())
        cell = ref["cells"].get(f"{env_name}/{delay}/nl")
        if cell is None:
            raise RuntimeError(f"{JAX_TABLE_REFERENCE} has no NL cell {env_name} d{delay}")
        bad = protocol_mismatch(cell, delay, ref["seeds"])
        if bad:
            raise RuntimeError(f"{JAX_TABLE_REFERENCE} ran {env_name} d{delay} NL under {', '.join(bad)}, not this "
                               f"run's K={K}, T={T}, seeds {EVAL_SEEDS}")
        path = tracked_checkpoint_path(model_checkpoint_name("nl", env_name, delay, "exp", 0, True))
        digest = hashlib.sha256(path.read_bytes()).hexdigest()
        if (ROOT / cell["checkpoint"]["path"]).resolve() != path.resolve() or cell["checkpoint"]["sha256"] != digest:
            raise RuntimeError(f"{JAX_TABLE_REFERENCE} ran {env_name} d{delay} NL on {cell['checkpoint']}, the grid "
                               f"loads {path} (sha256 {digest})")
        if cell["config"]["encode_obs_time"] != encode_obs_time:
            raise RuntimeError(f"{JAX_TABLE_REFERENCE} ran {env_name} d{delay} NL under encode_obs_time="
                               f"{cell['config']['encode_obs_time']}, the grid runs it under {encode_obs_time}")
        return np.asarray(cell["total_rewards"])
    path = JAX_RNN_RESULTS if model_name == "rnn" else JAX_RESULTS
    for line in path.read_text().splitlines():
        r = json.loads(line)
        if (r["env_name"], r["delay"], r["model_name"]) == (env_name, delay, model_name) and not r.get("errored"):
            bad = protocol_mismatch(r, delay, r.get("seeds"))
            if bad:
                raise RuntimeError(f"{path} ran {env_name} d{delay} {model_name} under {', '.join(bad)}, not this "
                                   f"run's K={K}, T={T}, seeds {EVAL_SEEDS}")
            return np.asarray(r["total_rewards"])
    raise RuntimeError(f"{path} has no record of {env_name} d{delay} {model_name}")


def table_calls() -> list:
    """The table's driver calls, as (envs, delays, models, extra flags): the
    driver runs the product of its lists, so the 35 cells without the age
    channel take three products, and ``AGE_CHANNEL_CELL``'s NL a call of its
    own under ``--encode_obs_time true``."""
    age_env, age_delay = AGE_CHANNEL_CELL
    others = tuple(e for e in ENVS if e != age_env)
    later = tuple(d for d in TABLE_DELAYS if d != age_delay)
    return [(ENVS, TABLE_DELAYS, ("oracle", "random"), ()),
            (others, TABLE_DELAYS, ("nl",), ()),
            ((age_env,), later, ("nl",), ()),
            ((age_env,), (age_delay,), ("nl",), ("--encode_obs_time", "true"))]


def hold_records(recs: list, expected, grid, held) -> tuple[dict, list]:
    """Each cell of a grid's records: its mean, std, normalized score
    against the records' own oracle and random, batch seconds and ticks/s;
    each cell of a model in ``held`` by the 3-sigma rule to the JAX
    package's returns (``jax_cell_returns``; NL's under the age channel at
    ``AGE_CHANNEL_CELL``). Returns (cells, failures): a cell of ``expected``
    without a record, a record outside ``grid``, a cell recorded twice, an
    errored record, a cell with other than 20 returns, a held cell without a
    JAX record or over its limit."""
    failures, cells, n = [], {}, len(EVAL_SEEDS)
    by_cell = {}
    for r in recs:
        by_cell.setdefault((r["env_name"], r["delay"], r["model_name"]), []).append(r)
    errored = sorted(k for k, v in by_cell.items() if any(r.get("errored") for r in v))
    missing, extra = sorted(set(expected) - set(by_cell)), sorted(set(by_cell) - set(grid))
    twice = sorted(k for k, v in by_cell.items() if len(v) > 1)
    if errored or missing or extra or twice:
        failures.append(f"{len(recs)} records, {len(errored)} errored {errored}, missing {missing}, extra {extra}, "
                        f"recorded twice {twice}")
    scores = normalized_scores([r for r in recs if not r.get("errored")], agg="std")
    for (env_name, delay, model_name), (r, *_) in sorted(by_cell.items()):
        if r.get("errored"):
            continue
        name, got = f"{env_name} d{delay} {model_name}", np.asarray(r["total_rewards"], np.float64)
        score = scores.get((delay, env_name, model_name))  # none without the cell's oracle and random
        cell = {"mean": float(got.mean()), "std": float(got.std()),
                "normalized_std": None if score is None else list(score[:2]),
                "episode_batch_s": r["episode_elapsed_time"], "ticks_per_s": EVAL_STEPS / r["episode_elapsed_time"]}
        cells[f"{env_name}/{delay}/{model_name}"] = cell
        if got.shape != (n,):
            failures.append(f"{name}: {got.size} returns, expected {n}")
            continue
        if model_name not in held:
            continue
        age = model_name == "nl" and (env_name, delay) == AGE_CHANNEL_CELL
        try:
            jax_ret = jax_cell_returns(env_name, delay, model_name, encode_obs_time=age)
        except RuntimeError as e:
            failures.append(f"{name}: {e}")
            continue
        cell["jax_mean"] = float(jax_ret.mean())
        cell["gap_to_jax"], cell["limit"] = three_sigma(got, jax_ret)
        if not cell["gap_to_jax"] <= cell["limit"]:
            failures.append(f"{name}: mean {cell['mean']:.3f} is {cell['gap_to_jax']:.3f} from the JAX package's, "
                            f"over the limit {cell['limit']:.3f}")
    return cells, failures


def table_cells(recs: list, launches: dict) -> tuple[dict, list]:
    """Phase ``table``'s holds of its records: ``hold_records`` over the 36
    cells, NL and the oracle held, and every NL cell's forward launches
    (``launches[(env, delay)]``: launches and rows) at 8,040 of S*K rows.
    Returns (cells, failures)."""
    grid = [(e, d, m) for e in ENVS for d in TABLE_DELAYS for m in TABLE_MODELS]
    cells, failures = hold_records(recs, grid, grid, ("nl", "oracle"))
    for key, cell in cells.items():
        env_name, delay, model_name = key.split("/")
        if model_name == "nl":
            cell["launches"], rows = launches.get((env_name, int(delay)), (0, 0))
            cell["rows_per_launch"] = rows / max(1, cell["launches"])
            if cell["launches"] != (EVAL_STEPS + 1) * T or rows != cell["launches"] * SEED_ROWS:
                failures.append(f"{env_name} d{delay} nl: the forward kernel launched {cell['launches']} times over "
                                f"{rows} rows, expected {(EVAL_STEPS + 1) * T} at {SEED_ROWS}")
    return cells, failures


def run_table(device, smi: str, tmp: str) -> dict:
    """Phase ``table``: the paper's evaluation grid through
    ``run_exp_multi_torch.main`` on the card, on the tracked checkpoints with
    the fused NL planner, all calls into one results file (``table_calls``);
    each cell held as ``table_cells`` holds it, and ``results.summarize``
    over the file must print the ``latex_table`` of the records. The
    forward's launches and rows are read around each NL cell's
    ``evaluate_policy``."""
    import run_exp_multi_torch as driver

    fwd = pallas_nl.nl_forward_fused
    out_dir = Path(tmp) / "table"
    results = out_dir / "results.jsonl"
    launches, recs, seconds = {}, [], {}
    evaluate = driver.evaluate_policy

    def counted(model_name, env_name, delay, *args, **kw):
        before = fwd.launches, fwd.rows
        r = evaluate(model_name, env_name, delay, *args, **kw)
        if model_name == "nl":
            launches[(env_name, delay)] = (fwd.launches - before[0], fwd.rows - before[1])
        return r

    fwd.launches = fwd.rows = 0
    driver.evaluate_policy = counted
    try:
        for envs, delays, models, extra in table_calls():
            t0 = time.perf_counter()
            run = driver.main(["--device", "cuda", "--results", str(results), "--log_folder", str(out_dir / "logs"),
                               "--envs", ",".join(envs), "--delays", ",".join(map(str, delays)),
                               "--models", ",".join(models), "--seed_runs", str(len(EVAL_SEEDS)),
                               "--fused_nl_planner", "true",
                               "--saved_models_path", str(ROOT / "artifacts" / "checkpoints") + "/", *extra])
            torch.cuda.synchronize()
            seconds[f"{','.join(models)} x {len(envs)} envs x d{','.join(map(str, delays))}"] = time.perf_counter() - t0
            recs += run["records"]
    finally:
        driver.evaluate_policy = evaluate
    cells, failures = table_cells(recs, launches)
    stdout = io.StringIO()
    with redirect_stdout(stdout):
        summarize.main([str(results)])
    table = latex_table([r for r in recs if not r.get("errored")])
    out = {"card": smi, "records": len(recs), "errored": sum(bool(r.get("errored")) for r in recs),
           "launches": fwd.launches, "rows_per_launch": fwd.rows / max(1, fwd.launches), "seconds": seconds,
           "summarize_equals_latex_table": stdout.getvalue().rstrip().endswith(table)}
    for key, cell in cells.items():
        print(f"table {key} " + json.dumps(cell), flush=True)
    print("table " + json.dumps(out), flush=True)
    print(table, flush=True)
    if not out["summarize_equals_latex_table"]:
        failures.append("summarize over the JSONL does not print the driver's latex_table")
    if failures:
        raise RuntimeError("phase table: " + "; ".join(failures))
    return {**out, "cells": cells, "results": results}


def ensemble_segments_f64(device, tmp: str) -> dict:
    """One 20-update segment of a 2-delay delta_t_rnn ensemble at f64 on the
    card (the tracked pendulum d0 and d1 checkpoints, each on the first rows
    of its own collected buffer, one shared batch order) against each
    member's own ``train_model`` segment: the largest relative gap of one
    update's loss, and of one parameter after the segment."""
    cfg = port.Config()
    model = make_model("delta_t_rnn", COLLECT_ENV, 3, 1, 2.0, cfg, dtype=torch.float64, device=device)
    members, data = [], []
    for d in (0, 1):
        members.append(load_pytree(resolve_checkpoint(model_checkpoint_name("delta_t_rnn", COLLECT_ENV, d, "exp", 0,
                                                                             True)), device=device, dtype=torch.float64))
        rows = load_replay_buffer(Path(tmp) / replay_buffer_filename(COLLECT_ENV, d), device=device)
        data.append([x[:ENSEMBLE_ROWS].double() for x in rows])
    stacked = [torch.stack([data[0][i], data[1][i]]) for i in range(4)]
    idx = torch.as_tensor(np.random.default_rng(9).permutation(ENSEMBLE_ROWS)[:320].reshape(20, 16), device=device)
    optimizer = make_optimizer(cfg)
    ens_segment = ensemble.make_ensemble_segment_fn(model.apply, optimizer)
    segment = make_train_segment_fn(model, optimizer)

    def run_ensemble():
        return ens_segment(ensemble.stack_trees(members),
                           ensemble.stack_states([optimizer.init(m) for m in members]), *stacked, idx)

    def run_members():
        return [segment(m, optimizer.init(m), *data[i], idx) for i, m in enumerate(members)]

    ms = {}
    for name, run in (("ensemble", run_ensemble), ("members", run_members)):
        run()  # warm: each path's first call, then one timed call, its wall time
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0) / idx.shape[0]
        if name == "ensemble":
            p_e, _, losses_e = result
        else:
            per_member = result
    loss_gap, param_gap = 0.0, 0.0
    for i, (p_i, _, losses_i) in enumerate(per_member):
        loss_gap = max(loss_gap, float(((losses_e[i] - losses_i).abs() / losses_i.abs()).max()))
        for a, b in zip(tree_leaves(ensemble.slice_tree(p_e, i)), tree_leaves(p_i)):
            param_gap = max(param_gap, float(((a - b).abs() / (1e-12 + b.abs())).max()))
    return {"family": "delta_t_rnn", "delays": [0, 1], "updates": idx.shape[0], "batch": idx.shape[1],
            "update_loss_rel_gap": loss_gap, "param_rel_gap": param_gap, "limit": ENSEMBLE_SEGMENT_LIMIT,
            "ensemble_ms_per_update": ms["ensemble"], "members_ms_per_update": ms["members"]}


def run_driver(device, smi: str, tmp: str) -> dict:
    """Phase ``driver``: the grid driver ``run_exp_multi_torch.main`` on the
    card, through its uses beside the evaluation grid (phase ``table``).
    1. Per-delay training of
    NL on phase collect's buffer with ``--train_gate nl``. 2. A delay ensemble
    of delta_t_rnn over d0 and d1 with ``--ensemble_gate``, and the f64
    ensemble segment against its members' own segments. 3. The MPPI sweep
    on cartpole d1 through the kernel. 4. A driver call with
    ``--profile_trace_dir``. The launches of the forward kernel are counted
    in each part, and the kernel is held to its plain version on the tracked
    weights of each env at each row count that a part gave it."""
    import run_exp_multi_torch as driver

    fwd = pallas_nl.nl_forward_fused
    seconds, out, failures, launches = {}, {"card": smi}, [], {}
    shapes = set()  # (env, rows per launch) that the parts gave the forward kernel

    # 1. per-delay training of NL on the collected buffer, with the train gate
    fwd.launches = fwd.rows = 0
    t0 = time.perf_counter()
    trained = driver.main(driver_args(
        tmp, "train_gate", "--envs", COLLECT_ENV, "--delays", str(DELAY), "--models", "nl", "--retrain", "true",
        "--force_retrain", "true", "--train_seconds", str(DRIVER_TRAIN_SECONDS), "--train_gate", "nl",
        "--train_gate_retries", "1", "--ensemble_gate_seeds", str(DRIVER_GATE_SEEDS),
        "--seed_runs", str(DRIVER_GATE_SEEDS), "--fused_nl_planner", "true", "--offline_datasets_path", tmp))
    torch.cuda.synchronize()
    seconds["train_gate"] = time.perf_counter() - t0
    launches["train_gate"] = fwd.launches
    final = trained["records"]
    out["train_gate"] = {"gates": trained["gates"], "final": [
        {k: r.get(k) for k in ("model_name", "total_reward", "total_reward_std", "errored")} for r in final]}
    print("driver train_gate " + json.dumps(out["train_gate"]), flush=True)
    evals = len(trained["gates"]) + 1  # every gate check and the cell's own evaluation
    if not trained["gates"] or len(final) != 1 or final[0].get("errored") or not math.isfinite(final[0]["total_reward"]):
        failures.append(f"train_gate: gates {trained['gates']}, final records {final}")
    if launches["train_gate"] != evals * (EVAL_STEPS + 1) * T or fwd.rows != launches["train_gate"] * DRIVER_GATE_SEEDS * K:
        failures.append(f"train_gate: nl_forward launched {launches['train_gate']} times over {fwd.rows} rows, "
                        f"expected {evals * (EVAL_STEPS + 1) * T} at {DRIVER_GATE_SEEDS * K}")
    shapes.add((COLLECT_ENV, DRIVER_GATE_SEEDS * K))

    # 2. the delay ensemble, and its f64 segment against the members' own
    t0 = time.perf_counter()
    ens = driver.main(driver_args(
        tmp, "ensemble", "--envs", COLLECT_ENV, "--delays", "0,1", "--models", "delta_t_rnn", "--retrain", "true",
        "--force_retrain", "true", "--ensemble_delays", "true", "--ensemble_exclude", "none", "--ensemble_gate",
        "delta_t_rnn", "--train_seconds", str(ENSEMBLE_TRAIN_SECONDS), "--seed_runs", str(DRIVER_GATE_SEEDS),
        "--ensemble_gate_seeds", str(DRIVER_GATE_SEEDS), "--collect_expert_samples", str(ENSEMBLE_ROWS),
        "--offline_datasets_path", tmp))
    torch.cuda.synchronize()
    seconds["ensemble"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    segments = ensemble_segments_f64(device, tmp)
    seconds["ensemble_f64_segments"] = time.perf_counter() - t0
    out["ensemble"] = {"gates": ens["gates"], "final": [
        {k: r.get(k) for k in ("delay", "total_reward", "total_reward_std", "errored")} for r in ens["records"]],
        "f64_segments": segments}
    print("driver ensemble " + json.dumps(out["ensemble"]), flush=True)
    if len(ens["records"]) != 2 or any(r.get("errored") or not math.isfinite(r["total_reward"])
                                       for r in ens["records"]) or len(ens["gates"]) < 2:
        failures.append(f"ensemble: gates {ens['gates']}, records {ens['records']}")
    if not segments["update_loss_rel_gap"] < ENSEMBLE_SEGMENT_LIMIT:
        failures.append(f"ensemble f64 segment: {segments['update_loss_rel_gap']} is not below {ENSEMBLE_SEGMENT_LIMIT}")

    # 3. the MPPI sweep through the kernel
    _, params, model = load_nl(MAIN_ENV, device)
    fwd.launches = fwd.rows = 0
    t0 = time.perf_counter()
    best = run_mppi_sweep("nl", MAIN_ENV, DELAY, port.Config(fused_nl_planner=True), SweepSpec(**SWEEP),
                          model_apply=model.apply, params=params, device=device)
    torch.cuda.synchronize()
    seconds["sweep"] = time.perf_counter() - t0
    launches["sweep"] = fwd.launches
    trials = best.pop("trials")
    out["sweep"] = {"trials": trials, "best": best}
    print("driver sweep " + json.dumps(out["sweep"]), flush=True)
    expected = sum((EVAL_STEPS + 1) * t["mppi_time_steps"] for t in trials)
    expected_rows = sum((EVAL_STEPS + 1) * t["mppi_time_steps"] * t["n_seeds"] * t["mppi_roll_outs"] for t in trials)
    last = [t for t in trials if t["rung"] == trials[-1]["rung"]]
    if (launches["sweep"] != expected or fwd.rows != expected_rows
            or not all(math.isfinite(t["total_reward"]) for t in trials)):
        failures.append(f"sweep: nl_forward launched {launches['sweep']} times over {fwd.rows} rows (expected "
                        f"{expected} over {expected_rows}); trials {trials}")
    shapes.update((MAIN_ENV, t["n_seeds"] * t["mppi_roll_outs"]) for t in trials)
    shapes.add((MAIN_ENV, SWEEP["max_seeds"] * max(SWEEP["roll_outs"])))  # the most a sweep trial can give
    if best["total_reward"] != max(t["total_reward"] for t in last):
        failures.append(f"sweep: best {best} is not the best of the last rung {last}")

    # 4. a driver call with --profile_trace_dir
    trace_dir = Path(tmp) / "driver" / "trace"
    fwd.launches = fwd.rows = 0
    t0 = time.perf_counter()
    traced = driver.main(driver_args(tmp, "trace", "--envs", COLLECT_ENV, "--delays", str(DELAY), "--models", "nl",
                                     "--seed_runs", str(TRACE_SEEDS), "--fused_nl_planner", "true",
                                     "--profile_trace_dir", str(trace_dir),
                                     "--saved_models_path", str(ROOT / "artifacts" / "checkpoints") + "/"))
    seconds["trace"] = time.perf_counter() - t0
    launches["trace"] = fwd.launches
    files = sorted((trace_dir / f"{COLLECT_ENV}_nl_d{DELAY}").glob("*.pt.trace.json"))
    text = files[0].read_text() if files else ""
    out["trace"] = {"files": [f.name for f in files], "bytes": len(text),
                    "nl_forward_kernel_mentions": text.count("nl_forward_kernel"),
                    "episode_s": traced["records"][0].get("episode_elapsed_time")}
    print("driver trace " + json.dumps(out["trace"]), flush=True)
    if len(files) != 1 or out["trace"]["nl_forward_kernel_mentions"] == 0 or traced["records"][0].get("errored"):
        failures.append(f"trace: {out['trace']}")
    if launches["trace"] != (EVAL_STEPS + 1) * T or fwd.rows != launches["trace"] * TRACE_SEEDS * K:
        failures.append(f"trace: nl_forward launched {launches['trace']} times over {fwd.rows} rows, expected "
                        f"{(EVAL_STEPS + 1) * T} at {TRACE_SEEDS * K}")
    shapes.add((COLLECT_ENV, TRACE_SEEDS * K))

    # the forward kernel against its plain version at every (env, rows) above
    t0 = time.perf_counter()
    checks = [check_forward_rows(device, env_name, rows) for env_name, rows in sorted(shapes)]
    seconds["kernel_checks"] = time.perf_counter() - t0
    out["kernel_checks"] = [{k: c[k] for k in ("env", "B", "max_rel_err")} for c in checks]
    print("driver kernel_checks " + json.dumps(out["kernel_checks"]), flush=True)

    out["seconds"], out["launches"] = seconds, launches
    print("driver " + json.dumps({k: v for k, v in out.items() if k != "sweep"} | {"sweep_best": best}), flush=True)
    if failures:
        raise RuntimeError("phase driver: " + "; ".join(failures))
    return out


def plain_train_steps(model, params, opt, batch, steps: int):
    """The one-device training step (loss mean((pred - (sn - s0))**2), the
    optimizer on the whole tree) ``steps`` times: (losses, params)."""
    s0, a0, sn, ts = batch
    state, losses = opt.init(params), []
    for _ in range(steps):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        loss = torch.mean((model.apply(p, s0, a0, ts) - (sn - s0)) ** 2)
        updates, state = opt.update(tree_unflatten(params, list(torch.autograd.grad(loss, leaves))), state, p)
        params = tree_unflatten(params, [x.detach() + u for x, u in zip(leaves, tree_leaves(updates))])
        losses.append(float(loss.detach()))
    return losses, params


def shard_world_of_one(device, eval_returns) -> dict:
    """Part 1 and part 4 of phase ``shard`` in this process, a real one-rank
    NCCL group: the 20-seed evaluation under each shard mode against phase
    ``eval``'s unsharded returns, and the dp x tp training step against the
    one-device step."""
    import socket

    import torch.distributed as dist

    from neurallaplacecontrol_tpu_torch.parallel import make_mesh, make_sharded_train_step, multihost, shard_params
    from neurallaplacecontrol_tpu_torch.parallel import unshard_params

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port_no = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port_no}", 1, 0, device="cuda")
    if dist.get_backend() != "nccl":
        raise RuntimeError(f"the one-rank group runs {dist.get_backend()}, not nccl")
    try:
        env, params, model = load_nl(MAIN_ENV, device)
        cfg = port.Config(fused_nl_planner=True)
        fwd = pallas_nl.nl_forward_fused
        modes, launches = {}, 0
        for name, kw in (("seeds", {"shard_seeds": True}), ("rollouts", {"shard_rollouts": True}),
                         ("grid:1x1", {"shard_grid": (1, 1)})):
            fwd.launches = fwd.rows = 0
            r = evaluate_policy("nl", MAIN_ENV, DELAY, EVAL_SEEDS, cfg, model_apply=model.apply, params=params,
                                roll_outs=K, time_steps=T, device=device, **kw)
            got = np.asarray(r["total_rewards"])
            modes[name] = {"max_rel_gap": float(np.max(np.abs(got - eval_returns) / np.abs(eval_returns))),
                           "equal": bool(np.array_equal(got, eval_returns)), "launches": fwd.launches,
                           "rows_per_launch": fwd.rows / max(1, fwd.launches),
                           "episode_batch_s": r["episode_elapsed_time"], "group_size": r["shard_group_size"]}
            launches += fwd.launches
        # part 4: the dp x tp step on the one-rank mesh, two updates
        rng = np.random.default_rng(5)
        B = 256
        s0 = rng.standard_normal((B, 5))
        batch = tuple(torch.tensor(x, dtype=torch.float32, device=device) for x in (
            s0, rng.uniform(-3.0, 3.0, (B, 4, 1)), s0 + 0.01 * rng.standard_normal((B, 5)), np.full((B, 1), DT)))
        opt = make_optimizer(port.Config(learning_rate=1e-4, clip_grad_norm=0.1, weight_decay=0.0,
                                         use_lr_scheduler=False))
        ref_losses, ref_params = plain_train_steps(model, params, opt, batch, SHARD_TRAIN_STEPS)
        mesh = make_mesh(1, tp=2, device=device)
        step = make_sharded_train_step(model.apply, opt, mesh)
        p, state, losses = shard_params(params, mesh), None, []
        state = opt.init(p)
        for _ in range(SHARD_TRAIN_STEPS):
            p, state, loss = step(p, state, *batch)
            losses.append(float(loss))
        got, want = tree_leaves(unshard_params(p, mesh)), tree_leaves(ref_params)
        close = all(torch.allclose(a, b, rtol=TRAIN_STEP_RTOL, atol=TRAIN_STEP_ATOL) for a, b in zip(got, want))
        train = {"mesh": mesh.shape, "losses": losses, "one_device_losses": ref_losses,
                 "max_param_gap": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                 "within_rtol_atol": close, "rtol": TRAIN_STEP_RTOL, "atol": TRAIN_STEP_ATOL}
    finally:
        dist.destroy_process_group()
    return {"modes": modes, "launches": launches, "train": train}


def shard_two_ranks(tmp: str, eval_returns) -> list:
    """Part 2 of phase ``shard``: two processes of
    ``scripts/port_shard_check.py ranks`` sharing the card over gloo."""
    import socket

    out_dir = Path(tmp) / "shard_ranks"
    out_dir.mkdir(parents=True, exist_ok=True)
    returns = out_dir / "eval_returns.json"
    returns.write_text(json.dumps([float(x) for x in eval_returns]))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port_no = sock.getsockname()[1]
    script = str(ROOT / "scripts" / "port_shard_check.py")
    procs = [subprocess.Popen([sys.executable, script, "ranks", str(r), str(port_no), str(out_dir), str(returns)],
                              cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=SHARD_RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"shard rank {r} exited {p.returncode}:\n{text[-4000:]}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]


def shard_driver(tmp: str) -> dict:
    """Part 5 of phase ``shard``: the driver under torchrun with one rank, on
    pendulum d1 x {nl, random}, 4 seeds, the tracked checkpoints; the two
    shard modes run at once, each torchrun on a rendezvous port of its own."""
    parts, procs, out = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for shard in ("rollouts", "seeds"):
            parts[shard] = part = Path(tmp) / "shard_driver" / shard
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                   str(ROOT / "run_exp_multi_torch.py"), "--shard", shard, "--envs", COLLECT_ENV, "--delays",
                   str(DELAY), "--models", "nl,random", "--seed_runs", str(SHARD_DRIVER_SEEDS),
                   "--fused_nl_planner", "true", "--saved_models_path", str(ROOT / "artifacts" / "checkpoints") + "/",
                   "--results", str(part / "results.jsonl"), "--log_folder", str(part / "logs")]
            procs[shard] = subprocess.Popen(cmd, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True)
        for shard, proc in procs.items():
            _, stderr = proc.communicate(timeout=SHARD_DRIVER_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"torchrun --shard {shard} exited {proc.returncode}:\n{stderr[-4000:]}")
            recs = [json.loads(x) for x in (parts[shard] / "results.jsonl").read_text().splitlines()]
            out[shard] = {"seconds": time.perf_counter() - t0, "records": [
                {k: r.get(k) for k in ("model_name", "total_reward", "errored", "shard", "shard_group_size",
                                       "shard_fallback")} for r in recs]}
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return out


def run_shard(device, smi: str, eval_returns, tmp: str) -> dict:
    """Phase ``shard``: the multi-device layer on the one card. 1. A world of
    one over NCCL: the 20-seed cartpole-d1 evaluation under shard_seeds,
    shard_rollouts and shard_grid=(1, 1), each seed's return equal to phase
    ``eval``'s. 2. Two ranks sharing the card over gloo
    (``scripts/port_shard_check.py``): 10 replayed ticks of the K-sharded
    planner at K=1,000 and K=262,144 against the one-rank plan on the same
    noise (``SHARD_TICK_LIMIT``, and a planted fault that must exceed it),
    the seed-sharded 20-seed evaluation, and grid 2x1 and 1x2 on 4 seeds.
    3. The forward kernel against its plain version at the row counts the
    sharded planner gives it. 4. The dp x tp step at a world of one against
    the one-device step. 5. The driver under torchrun with ``--shard
    rollouts`` and ``--shard seeds``."""
    eval_returns = np.asarray(eval_returns, dtype=np.float64)
    seconds, failures, out = {}, [], {"card": smi}

    t0 = time.perf_counter()
    one = shard_world_of_one(device, eval_returns)
    seconds["world_of_one"] = time.perf_counter() - t0
    out["world_of_one"] = one
    print("shard world_of_one " + json.dumps(one | {"card": smi}), flush=True)
    for name, m in one["modes"].items():
        if not m["equal"]:
            failures.append(f"world of one, {name}: per-seed returns {m['max_rel_gap']:.3e} from phase eval's")
        if m["launches"] != (EVAL_STEPS + 1) * T or m["rows_per_launch"] != SEED_ROWS:
            failures.append(f"world of one, {name}: nl_forward launched {m['launches']} times at "
                            f"{m['rows_per_launch']} rows")
    if not one["train"]["within_rtol_atol"]:
        failures.append(f"dp x tp step: parameters {one['train']['max_param_gap']:.3e} from the one-device step")

    t0 = time.perf_counter()
    ranks = shard_two_ranks(tmp, eval_returns)
    seconds["two_ranks"] = time.perf_counter() - t0
    out["two_ranks"] = ranks
    launches = one["launches"] + sum(r["seeds"]["launches"] + sum(g["launches"] for g in r["grid"].values())
                                     for r in ranks)
    for r in ranks:
        for tick in r["ticks"]:
            if not (tick["U"] <= SHARD_TICK_LIMIT and tick["action"] <= SHARD_TICK_LIMIT):
                failures.append(f"rank {r['rank']} K={tick['K']}: sharded ticks {tick['U']:.3e} (U), "
                                f"{tick['action']:.3e} (action) from the one-rank plan, limit {SHARD_TICK_LIMIT}")
            if not tick["planted_U"] > SHARD_TICK_LIMIT:
                failures.append(f"rank {r['rank']} K={tick['K']}: the planted fault reads {tick['planted_U']:.3e}, "
                                f"inside the limit {SHARD_TICK_LIMIT}")
        got = np.asarray(r["seeds"]["returns"])
        gap = abs(float(got.mean() - eval_returns.mean()))
        limit = 3.0 * math.sqrt(got.var(ddof=1) / got.size + eval_returns.var(ddof=1) / eval_returns.size)
        r["seeds"]["mean_gap"], r["seeds"]["mean_limit"] = gap, limit
        if not gap <= limit:  # equal per seed is expected; a gap is reported, a shifted mean fails
            failures.append(f"rank {r['rank']}: seed-sharded mean return {gap:.3f} from phase eval's, over {limit:.3f}")
        grid_returns = [x for g in r["grid"].values() for x in g["returns"]]
        if not all(math.isfinite(x) for x in grid_returns):
            failures.append(f"rank {r['rank']}: non-finite grid return")
    print("shard two_ranks " + json.dumps({"card": smi, "ranks": ranks}), flush=True)
    if ranks[0]["seeds"]["returns"] != ranks[1]["seeds"]["returns"]:
        failures.append("the two ranks hold different seed-sharded records")

    t0 = time.perf_counter()
    checks = []
    for rows in SHARD_FORWARD_ROWS:
        rec = check_forward_rows(device, MAIN_ENV, rows, timed=rows in SHARD_TIMED_ROWS)
        checks.append(rec)
        print("kernel nl_forward shard rows: " + json.dumps(rec | {"card": smi}), flush=True)
    seconds["kernel_checks"] = time.perf_counter() - t0
    out["kernel_checks"] = checks

    t0 = time.perf_counter()
    drv = shard_driver(tmp)
    seconds["driver"] = time.perf_counter() - t0
    out["driver"] = drv
    print("shard driver " + json.dumps(drv | {"card": smi}), flush=True)
    for shard, d in drv.items():
        recs = d["records"]
        if len(recs) != 2 or any(r["errored"] or r["shard"] != shard or r["shard_group_size"] != 1 for r in recs):
            failures.append(f"driver --shard {shard}: records {recs}")
        random = [r for r in recs if r["model_name"] == "random"]
        if shard == "rollouts" and not (random and random[0]["shard_fallback"]):
            failures.append(f"driver --shard rollouts: the random cell carries no fallback stamp: {random}")

    out["seconds"], out["launches"] = seconds, launches
    print("shard " + json.dumps({"seconds": seconds, "launches": launches, "card": smi,
                                 "ticks": [[{k: t[k] for k in ("K", "U", "action", "planted_U")} for t in r["ticks"]]
                                           for r in ranks]}), flush=True)
    if failures:
        raise RuntimeError("phase shard: " + "; ".join(failures))
    return out


DEPLOY_TICKS = 200  # serve_demo_torch's loop on the exported step, with the tick log
DEPLOY_TICK_LIMIT = 1e-6  # |got - exp| / (1 + |exp|), exported vs eager tick on one noise
DEPLOY_CHAINED = 100  # ticks issued back to back for the device-amortized tick
TUNE_SEEDS = (0, 1)


def cold_and_warm_start(cache_dir: str) -> list:
    """Two processes on one fresh ``cache_dir`` (``serving.persistent_compile_cache``):
    each builds the kernel library and the two runtime libraries there and
    reports its compiler runs and seconds; the second should run none."""
    code = (
        "import json, time; t0 = time.perf_counter()\n"
        "from neurallaplacecontrol_tpu_torch import runtime, serving\n"
        "from neurallaplacecontrol_tpu_torch.ops import nl_cuda\n"
        "from neurallaplacecontrol_tpu_torch.runtime import _native, ticklog\n"
        f"serving.persistent_compile_cache({cache_dir!r})\n"
        "nl_cuda.library(); runtime.get_lib(); ticklog.get_lib()\n"
        "print(json.dumps({'nvcc': nl_cuda.compiles, 'gxx': _native.compiles, "
        "'seconds': time.perf_counter() - t0}))\n"
    )
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"compile-cache process failed:\n{proc.stderr[-3000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["process_s"] = time.perf_counter() - t0
        out.append(rec)
    return out


def run_deploy(device, smi: str, tmp: str, eager_tick_ms: float) -> dict:
    """Phase ``deploy``: the fused NL controller of phase ``controller``
    exported (``serving.export_controller``) and loaded back
    (``serving.load_controller_step``). 1. Ten replayed ticks on one noise,
    loaded against ``Controller.step`` (``DEPLOY_TICK_LIMIT``), the kernel
    launched T times a tick by the exported program. 2. 200 ticks of
    ``scripts/serve_demo_torch.py``'s loop on the loaded step with the tick
    log, read back. 3. Phase ``collect``'s buffer through its ``.rbuf``.
    4. Two processes on one fresh compile cache. 5. ``tune.autotune`` on
    2 seeds."""
    from scripts import serve_demo_torch as demo

    from neurallaplacecontrol_tpu_torch import serving, tune
    from neurallaplacecontrol_tpu_torch.data import replay
    from neurallaplacecontrol_tpu_torch.runtime.ticklog import TickLog

    failures, out = [], {"card": smi, "env": MAIN_ENV, "delay": DELAY, "K": K, "T": T}
    env, params, model = load_nl(MAIN_ENV, device)
    spec = env.spec
    cfg = port.Config(fused_nl_planner=True)
    ctrl = port.make_controller("nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K,
                                time_steps=T, device=device)
    pallas_nl.nl_forward_fused.launches = pallas_nl.nl_forward_fused.rows = 0
    pallas_ilt.nl_head_fused.launches = 0
    path = Path(tmp) / "controller.pt2"
    t0 = time.perf_counter()
    blob = serving.export_controller(ctrl, path=str(path))
    out["export_s"], out["export_bytes"] = time.perf_counter() - t0, len(blob)
    t0 = time.perf_counter()
    step = serving.load_controller_step(path, seed=0)
    out["load_s"] = time.perf_counter() - t0
    launches = {"export": pallas_nl.nl_forward_fused.launches}

    # 1. replayed ticks: the loaded step against the eager one on the same noise
    g = torch.Generator(device=device).manual_seed(1)
    chol = ctrl.mppi_params.noise_chol
    eager = loaded = ctrl.reset(0)
    raw = env.reset(torch.Generator().manual_seed(0)).to(device)
    errs, per_tick = [], []
    for _ in range(REPLAY_TICKS):
        obs = env.observe(raw)
        noise = torch.randn((K, T, spec.m), generator=g, device=device) @ chol.T
        a_e, eager = ctrl.step(eager, obs, noise=noise)
        before = pallas_nl.nl_forward_fused.launches
        a_x, loaded = step(loaded, obs, noise=noise)
        torch.cuda.synchronize()
        per_tick.append(pallas_nl.nl_forward_fused.launches - before)
        errs.append(max(rel_err(a_x, a_e), rel_err(loaded.U, eager.U),
                        rel_err(loaded.action_buffer, eager.action_buffer)))
        raw = env_step(env, raw, eager.action_buffer[-(DELAY + 1)], spec.dt)
    out["replay"] = {"ticks": REPLAY_TICKS, "max_rel_err": max(errs), "limit": DEPLOY_TICK_LIMIT,
                     "launches_per_tick": per_tick}
    if not max(errs) <= DEPLOY_TICK_LIMIT:
        failures.append(f"exported tick {max(errs):.3e} from the eager tick, limit {DEPLOY_TICK_LIMIT}")
    if per_tick != [T] * REPLAY_TICKS:
        failures.append(f"the exported program launched the forward {per_tick} times a tick, expected {T}")

    # 2. serve_demo_torch's loop on the loaded step, with the tick log
    log_path = str(Path(tmp) / "ticks.log")
    log, epoch, base_s = demo.open_ticklog(log_path, 4096, 2 + spec.m + spec.n_obs)
    before = pallas_nl.nl_forward_fused.launches
    lat, state, raw, records = demo.control_loop(step, ctrl.reset(0), env, raw, DEPLOY_TICKS, DELAY, log, base_s)
    launches["serve"] = pallas_nl.nl_forward_fused.launches - before
    log.close()
    lat_ms = np.asarray(lat[1:]) * 1e3  # the first tick includes one-time set-up
    before = pallas_nl.nl_forward_fused.launches
    amortized = demo.chained_ms(step, state, env.observe(raw), DEPLOY_CHAINED)
    launches["chained"] = pallas_nl.nl_forward_fused.launches - before
    reread = TickLog.open(log_path)
    logged = reread.read(0, reread.count) if reread.count == DEPLOY_TICKS else None
    reread.close()
    out["serve"] = {
        "ticks": DEPLOY_TICKS, "tick_ms_p50": float(np.percentile(lat_ms, 50)),
        "tick_ms_p90": float(np.percentile(lat_ms, 90)), "tick_ms_p99": float(np.percentile(lat_ms, 99)),
        "tick_ms_mean": float(lat_ms.mean()), "eager_tick_ms_mean": eager_tick_ms,
        "exported_over_eager": float(lat_ms.mean()) / eager_tick_ms,
        "tick_ms_device_amortized": amortized, "chained": DEPLOY_CHAINED,
        "ticklog_count": None if logged is None else len(logged), "ticklog_epoch_unix_s": epoch,
    }
    if logged is None or not np.array_equal(logged, np.asarray(records, dtype=np.float32)):
        failures.append(f"the tick log holds {reread.count} records, not the {DEPLOY_TICKS} appended")
    if launches["serve"] != DEPLOY_TICKS * T:
        failures.append(f"serve loop: {launches['serve']} launches, expected {DEPLOY_TICKS * T}")

    # 3. phase collect's buffer through its .rbuf sibling
    npz = Path(tmp) / replay_buffer_filename(COLLECT_ENV, DELAY)
    native = replay._load_rbuf(npz)
    with np.load(npz) as z:
        equal = native is not None and all(np.array_equal(native[k], z[k]) for k in replay.FIELDS)
    loaded_buf = load_replay_buffer(npz, device=device)
    out["rbuf"] = {"file_bytes": replay._rbuf_path(npz).stat().st_size if native is not None else None,
                   "native": native is not None, "equal_to_npz": equal,
                   "rows": None if native is None else int(native["s0"].shape[0])}
    if not equal or not all(torch.equal(x.cpu(), torch.from_numpy(native[k]))
                            for x, k in zip(loaded_buf, replay.FIELDS)):
        failures.append(f"the .rbuf round trip: {out['rbuf']}")

    # 4. cold and warm start on one fresh compile cache
    starts = cold_and_warm_start(str(Path(tmp) / "compile_cache"))
    out["compile_cache"] = starts
    if (starts[0]["nvcc"], starts[0]["gxx"]) != (1, 2) or (starts[1]["nvcc"], starts[1]["gxx"]) != (0, 0):
        failures.append(f"compile cache: cold {starts[0]}, warm {starts[1]} (expected 1/2 then 0/0 compiler runs)")

    # 5. autotune over the planner's three NL routes, 2 seeds
    trials_path = Path(tmp) / "autotune.jsonl"
    before = pallas_nl.nl_forward_fused.launches
    best, trials = tune.autotune("nl", MAIN_ENV, DELAY, base=port.Config(mppi_roll_outs=K, mppi_time_steps=T),
                                 model_apply=model.apply, params=params, seeds=TUNE_SEEDS, device=device,
                                 results_path=str(trials_path))
    launches["autotune"] = pallas_nl.nl_forward_fused.launches - before
    out["autotune"] = {"trials": trials, "best": {k: getattr(best, k) for k in ("fused_nl_planner",
                                                                              "nl_planner_precompute")},
                       "logged": len(trials_path.read_text().splitlines())}
    if out["autotune"]["logged"] != len(trials) or len(trials) != 3:
        failures.append(f"autotune: {len(trials)} trials, {out['autotune']['logged']} logged")

    out["launches"] = launches
    out["launches_total"] = pallas_nl.nl_forward_fused.launches
    print("deploy " + json.dumps(out), flush=True)
    if failures:
        raise RuntimeError("phase deploy: " + "; ".join(failures))
    return out


# Phase ``entry``: the repo's own entry points on the card. bench_torch.py's
# line in a fresh process; eval_bigk_torch, heldout_parity_torch and
# make_readme_table_torch in this one, with their files in the phase's
# temporary directory
ENTRY_TIMEOUT_S = 300
ENTRY_FLOPS = 384_338  # bench.py's analytic count of one cartpole NL forward (n=5, m=1)
HELDOUT_MODELS = ("node", "latent_ode", "nl")


def run_entry(device, smi: str, tmp: str, results_path) -> dict:
    """Phase ``entry``: ``bench_torch.py`` in a subprocess, its line parsed and
    checked (the kernel route, the trained checkpoint, the analytic FLOP
    count, an MFU in (0, 1], the kernel's launches); ``eval_bigk_torch`` at
    K=16,384 (finite returns, the kernel's launches counted here);
    ``heldout_parity_torch`` on the tracked checkpoints (finite MSEs); and
    ``make_readme_table_torch`` on the driver's records at ``results_path``
    (each NL cell's score in the table)."""
    failures, seconds, out = [], {}, {"card": smi}
    fwd = pallas_nl.nl_forward_fused
    steps_launches = (EVAL_STEPS + 1) * T

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT, capture_output=True, text=True,
                          timeout=ENTRY_TIMEOUT_S, check=False)
    seconds["bench_torch"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"bench_torch.py exited {proc.returncode}: {proc.stderr[-3000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    out["bench_torch"] = bench
    expect = {"route": "kernel", "trained_checkpoint": True, "nl_forward_flops": ENTRY_FLOPS,
              "nl_forward_launches": steps_launches}
    failures += [f"bench_torch {k}: {bench.get(k)!r}, expected {v!r}" for k, v in expect.items() if bench.get(k) != v]
    if not 0.0 < bench["mfu_vs_h100_tf32_peak"] <= 1.0:
        failures.append(f"bench_torch mfu_vs_h100_tf32_peak {bench['mfu_vs_h100_tf32_peak']} is not in (0, 1]")
    if not (math.isfinite(bench["value"]) and bench["value"] > 0 and bench["train_steps_per_sec"] > 0):
        failures.append(f"bench_torch value {bench['value']}, train_steps_per_sec {bench['train_steps_per_sec']}")

    fwd.launches = 0
    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        bigk = eval_bigk_torch.main(["--out", str(Path(tmp) / "results_bigk.jsonl")])
    torch.cuda.synchronize()
    seconds["eval_bigk_torch"] = time.perf_counter() - t0
    launches = {"bench_torch": bench["nl_forward_launches"], "eval_bigk_torch": fwd.launches}
    out["eval_bigk_torch"] = {k: bigk[k] for k in ("roll_outs", "total_rewards", "total_reward",
                                                   "mppi_rollouts_per_sec", "episode_elapsed_time", "route")}
    if not all(math.isfinite(x) for x in bigk["total_rewards"]):
        failures.append(f"eval_bigk_torch: non-finite return {bigk['total_rewards']}")
    if fwd.launches != steps_launches or bigk["nl_forward_launches"] != steps_launches:
        failures.append(f"eval_bigk_torch: nl_forward launched {fwd.launches} times, expected {steps_launches}")

    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        heldout = heldout_parity_torch.main(["--models", ",".join(HELDOUT_MODELS), "--out",
                                             str(Path(tmp) / "heldout_parity.log")])
    seconds["heldout_parity_torch"] = time.perf_counter() - t0
    out["heldout_parity_torch"] = heldout
    if set(heldout) != set(HELDOUT_MODELS) or not all(math.isfinite(v) and v > 0 for v in heldout.values()):
        failures.append(f"heldout_parity_torch: {heldout}")

    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        table = make_readme_table_torch.main(str(results_path))
    seconds["make_readme_table_torch"] = time.perf_counter() - t0
    recs = [json.loads(x) for x in Path(results_path).read_text().splitlines() if x.strip()]
    scores = normalized_scores([r for r in recs if not r.get("errored")])
    nl_cells = [f"{v[0]:.1f} ± {v[1]:.1f}" for (d, e, m), v in scores.items() if m == "nl"]
    nl_row = next(line for line in table.splitlines() if line.startswith("| **nl**"))
    out["make_readme_table_torch"] = {"records": len(recs), "nl_row": nl_row}
    if not nl_cells or not all(c in nl_row for c in nl_cells):
        failures.append(f"make_readme_table_torch: the NL row {nl_row!r} lacks the cells {nl_cells}")

    out["seconds"], out["launches"] = seconds, launches
    print("entry " + json.dumps(out), flush=True)
    if failures:
        raise RuntimeError("phase entry: " + "; ".join(failures))
    return out


# nl_hidden_units of phase widths' kernel checks; 200's GRU width (100, padded to 104) leaves
# the last m-tile of 16 columns half live
WIDTHS = (24, 100, 128, 160, 200, 256, 512, 1024, 2048, 4096)
WIDTH_ROWS = (K, SEED_ROWS)  # checked and timed
WIDTH_MAX_ROWS = {4096: K}  # widths timed at fewer rows: 4,096 at 1,000 only
WIDTH_RAGGED_ROWS = (1, 999, 1001)  # checked only: row tiles cut short
WIDTH_COND_LIMIT = 1e-5  # forward_errors' kernel_cond, as on phase train's early weights
# the f32 plain forward's rel_err to the f64 one below which f32 resolves the seeded init's
# outputs, and the kernel is held to the plain forward by KERNEL_TOL as well
WIDTH_RESOLVED = 1e-4
WIDE = 512  # the driver cell's nl_hidden_units
WIDE_SEEDS = 10
WIDE_TRAIN_SECONDS = 15
WIDE_HEAD_HX = 512
WIDE_EXPORT_TICKS = 5
# the exported controller's horizon: the trace of T = 40 forwards at width 512 took 27 s on an
# NVIDIA H100 80GB HBM3 at 700 W, past the phase's budget; tests/test_torch_cuda.py exports T = 40
WIDE_EXPORT_T = 8


def widen_nl(params, width: int, seed: int) -> dict:
    """An NL tree of width 128 embedded in one of nl_hidden_units = ``width``:
    the trained weights in the leading GRU units (each of the r, z, n blocks)
    and trunk columns, every new weight and bias drawn N(0, 0.02^2) from
    ``seed``. On phase widths' cartpole inputs the new units move the
    outputs by 0.04 (width 160) to 0.35 (width 1,024) in ``rel_err``, far
    past ``KERNEL_TOL``, while f32 resolves them as it resolves the trained
    model's."""
    g = torch.Generator().manual_seed(seed)

    def grow(old, shape, gates=None):
        new = (0.02 * torch.randn(shape, generator=g, dtype=torch.float64)).to(old.dtype).to(old.device)
        if gates is None:
            new[tuple(slice(0, k) for k in old.shape)] = old
            return new
        H, Hn = gates
        rows = (slice(0, old.shape[0]),) if old.dim() == 2 else ()
        for gate in range(3):
            new[rows + (slice(gate * Hn, gate * Hn + H),)] = old[rows + (slice(gate * H, (gate + 1) * H),)]
        return new

    H, Hn = params["encoder"]["gru"][0]["w_hh"].shape[0], width // 2
    gru = []
    for i, layer in enumerate(params["encoder"]["gru"]):
        k = layer["w_ih"].shape[0] if i == 0 else Hn
        gru.append({"w_ih": grow(layer["w_ih"], (k, 3 * Hn), (H, Hn)), "w_hh": grow(layer["w_hh"], (Hn, 3 * Hn), (H, Hn)),
                    "b_ih": grow(layer["b_ih"], (3 * Hn,), (H, Hn)), "b_hh": grow(layer["b_hh"], (3 * Hn,), (H, Hn))})
    out = params["encoder"]["out"]
    l0, l1, l2 = params["laplace_rep"]
    return {
        "encoder": {"gru": gru, "out": {"w": grow(out["w"], (Hn, out["w"].shape[1])), "b": out["b"]}},
        "laplace_rep": [
            {"w": grow(l0["w"], (l0["w"].shape[0], width)), "b": grow(l0["b"], (width,))},
            {"w": grow(l1["w"], (width, width)), "b": grow(l1["b"], (width,))},
            {"w": grow(l2["w"], (width, l2["w"].shape[1])), "b": l2["b"]},
        ],
    }


def replay_diffs(ctrls, env, device, ticks: int = REPLAY_TICKS) -> list:
    """Replays ``ctrls[0]``'s closed loop tick by tick through every
    controller: each tick, every controller plans from the first's state
    (cast to its own dtype) on the same observation and noise draw. Returns,
    for each later controller, the largest action gap to the first's: the
    forward's part of a tick, without the gaps of earlier ticks carried in
    the warm-started plans."""
    spec = env.spec
    raw = env.reset(torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator(device=device).manual_seed(2)
    chol = ctrls[0].mppi_params.noise_chol.float()
    state = ctrls[0].reset(0)
    gaps = [0.0] * (len(ctrls) - 1)
    for _ in range(ticks):
        obs = env.observe(raw)
        noise = torch.randn((K, T, spec.m), generator=g, device=device) @ chol.T
        acts, first = [], None
        for c in ctrls:
            dtype = c.reset(0).U.dtype
            a, nxt = c.step(type(state)(*(x.to(dtype) for x in state)), obs.to(dtype), noise=noise.to(dtype))
            acts.append(a.double())
            first = nxt if first is None else first
        gaps = [max(gap, float((a - acts[0]).abs().max())) for gap, a in zip(gaps, acts[1:])]
        state = first
        raw = env_step(env, raw, state.action_buffer[-(DELAY + 1)].to(raw.dtype), spec.dt)
    return gaps


def plain_controller(cfg, params, packed, spec, device, dtype=torch.float32):
    """The controller of ``cfg`` with the plain forward on ``packed`` in place
    of the kernel."""
    packed = tuple(x.to(dtype) for x in packed)
    return port.make_controller(
        "nl", MAIN_ENV, DELAY, cfg.replace(fused_nl_planner=False), roll_outs=K, time_steps=T, device=device,
        dtype=dtype, params=params, model_apply=lambda _p, obs, w, _ts: pallas_nl.nl_forward_plain(
            obs, w.reshape(w.shape[0], -1), packed, spec.n_obs, spec.m))


def forward_dims(rows: int, fused, spec, terms: int) -> tuple:
    """The integer dims of a forward launch at ``rows`` rows of ``fused``'s
    packed weights, as ``nl_cuda.forward_plan`` takes them."""
    packed, A = fused.packed, port.Config().action_buffer_size
    return (rows, spec.n_obs, A, spec.m, packed[1].shape[0], packed[13].shape[0], spec.n_obs, terms,
            fused.hopper.numel())


def width_forward_checks(device, width: int, tracked, stages=None) -> list:
    """The forward kernel at ``width`` on cartpole against its plain version
    at the rows of ``WIDTH_RAGGED_ROWS`` and ``WIDTH_ROWS``, on two sets of
    weights. On the port's init drawn from a seed (``weights: "seeded"``):
    the term-scaled f64 error, and where f32 resolves the outputs the error
    to the plain forward; at ``WIDTH_ROWS``, graph ms of kernel and plain in
    turns (plain, kernel, kernel, plain; each the faster of its two), eager
    ms, the bounds at the model's real widths, and with ``stages`` (a
    function of the kernel's call) its result. Past 128, on the tracked
    checkpoint widened to ``width`` (``widen_nl``, ``weights: "widened"``),
    whose outputs f32 resolves: the errors. ``width_failures`` holds them to
    their limits. Each record names the variant that ran, its tile (rows by
    columns of a GRU stage's CTA), its device launches per forward and its
    largest shared memory. 4,096 is timed at 1,000 rows only
    (``WIDTH_MAX_ROWS``)."""
    spec = make_env(MAIN_ENV).spec
    n, in_dim, A = spec.n_obs, spec.m, port.Config().action_buffer_size
    cfg = port.Config(nl_hidden_units=width)
    terms = cfg.nl_s_recon_terms
    model = make_model("nl", MAIN_ENV, n, in_dim, spec.action_high, cfg, device=device)
    weights = {"seeded": model.init(torch.Generator(device=device).manual_seed(width))}
    if width > 128:
        weights["widened"] = widen_nl(tracked, width, seed=width)
    timed = [r for r in WIDTH_ROWS if r <= WIDTH_MAX_ROWS.get(width, r)]
    recs = []
    for name, params in weights.items():
        fused = model.make_fused_planner_apply(params, cfg.dt)
        packed = fused.packed
        for rows in WIDTH_RAGGED_ROWS + tuple(timed):
            rng = np.random.default_rng(rows + width)
            obs = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=device)
            acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high, (rows, A * in_dim)),
                                dtype=torch.float32, device=device)
            kernel = partial(pallas_nl.nl_forward_fused, obs, acts, packed, n, in_dim, terms=terms,
                             hopper=fused.hopper)
            plain = partial(pallas_nl.nl_forward_plain, obs, acts, packed, n, in_dim)
            got = kernel()
            torch.cuda.synchronize()
            plan = nl_cuda.forward_plan(forward_dims(rows, fused, spec, terms))
            rec = {"width": width, "weights": name, "B": rows, "variant": plan["variant"], "tile": plan["tile"],
                   "launches_per_forward": plan["launches"], "smem_bytes": plan["smem_bytes"],
                   "finite": bool(torch.isfinite(got).all()) and got.shape == (rows, n),
                   **forward_errors(got, obs, acts, packed, n, in_dim)}
            if name == "seeded":
                rec["resolved"] = rec["plain_vs_plain64"] < WIDTH_RESOLVED
            if name == "seeded" and rows in timed:  # the times do not depend on the weights
                reps = TIMED_LAUNCHES if rows <= K else 10
                rec["turns_ms"] = [graph_ms(f, reps) for f in (plain, kernel, kernel, plain)]
                rec["ms"], rec["plain_ms"] = min(rec["turns_ms"][1:3]), min(rec["turns_ms"][0], rec["turns_ms"][3])
                rec["eager_ms"], rec["plain_eager_ms"] = time_ms(kernel, reps), time_ms(plain, reps)
                rec.update(bounds(*forward_cost(rows, n, A, in_dim, packed[1].shape[0], packed[13].shape[0], n,
                                                terms, packed)))
                rec["share_of_bound_tc"] = rec["bound_tc_ms"] / rec["ms"]
                if stages is not None:
                    rec["stages"] = stages(kernel)
            print(f"widths forward {width} {name} B={rows}: " + json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


def width_failures(checks: list) -> list:
    """What fails among ``width_forward_checks``' records: output not finite
    or of the wrong shape; on the seeded init a term-scaled error at or
    past ``WIDTH_COND_LIMIT``; an error to the plain forward at or past
    ``KERNEL_TOL`` on the widened weights, and on the seeded init where f32
    resolves the outputs; another variant than the resident one up to 128
    and the streamed one past it."""
    failures = []
    for r in checks:
        where = f"width {r['width']} ({r['weights']}) at B={r['B']}"
        if not r["finite"]:
            failures.append(f"{where}: non-finite output or wrong shape")
        if r["weights"] == "seeded" and not r["kernel_cond"] < WIDTH_COND_LIMIT:
            failures.append(f"{where}: term-scaled error {r['kernel_cond']:.3e} >= {WIDTH_COND_LIMIT}")
        if (r["weights"] == "widened" or r["resolved"]) and not r["kernel_vs_plain"] < KERNEL_TOL:
            failures.append(f"{where}: relative error {r['kernel_vs_plain']:.3e} >= {KERNEL_TOL}")
        if (r["variant"] == "resident") != (r["width"] <= 128):
            failures.append(f"{where}: the {r['variant']} variant ran")
    return failures


def width_head_check(device) -> dict:
    """The head kernel at Hx = ``WIDE_HEAD_HX`` (cartpole's 5 x 17 columns, in
    chunks sized to the stage) against its plain version at 1,000 rows."""
    D, terms = 5, port.Config().nl_s_recon_terms
    rng = np.random.default_rng(WIDE_HEAD_HX)
    w = rng.standard_normal((WIDE_HEAD_HX, 2 * D * terms)) / math.sqrt(WIDE_HEAD_HX)
    b = 0.1 * rng.standard_normal(2 * D * terms)
    head = pallas_ilt.to_device(pallas_ilt.pack_head_weights(w, b, D, terms, 0.125), device)
    hopper = torch.as_tensor(pallas_ilt.repack_head(head, D, terms), device=device)
    x = torch.tensor(np.tanh(rng.standard_normal((K, WIDE_HEAD_HX))), dtype=torch.float32, device=device)
    kernel = partial(pallas_ilt.nl_head_fused, x, head, D, terms=terms, hopper=hopper)
    plain = partial(pallas_ilt.nl_head_plain, x, head, D)
    got, exp = kernel(), plain()
    torch.cuda.synchronize()
    rec = {"Hx": WIDE_HEAD_HX, "B": K, "chunks": pallas_ilt.head_chunks(WIDE_HEAD_HX, D, terms),
           "max_abs_err": float((got - exp).abs().max()), "max_rel_err": rel_err(got, exp),
           "smem_bytes": nl_cuda.smem_bytes("nl_head", (K, WIDE_HEAD_HX, D, terms, hopper.numel())),
           "ms": graph_ms(kernel), "plain_ms": graph_ms(plain), **bounds(*head_cost(K, WIDE_HEAD_HX, D, terms, head))}
    print("widths head " + json.dumps(rec), flush=True)
    return rec


def wide_driver_cell(device, tmp: str, tracked) -> dict:
    """The driver at nl_hidden_units = ``WIDE`` on cartpole d1:
    ``train_model`` for ``WIDE_TRAIN_SECONDS`` on the tracked buffer,
    warm-started from the tracked checkpoint widened to ``WIDE``
    (``widen_nl``), and a ``WIDE_SEEDS``-seed evaluation through the forward
    kernel (its streamed variant), then the same checkpoint through the plain
    route, the two held by the 3-sigma rule. On the trained checkpoint: the
    kernel against the plain forward (``KERNEL_TOL``, as phase ``kernels``
    holds the tracked weights), ``REPLAY_TICKS`` replayed ticks of the
    kernel's controller against the plain forward's (``ACTION_TOL``), and
    the exported step, at a horizon of ``WIDE_EXPORT_T``, against the eager
    one (``DEPLOY_TICK_LIMIT``)."""
    import run_exp_multi_torch as driver

    from neurallaplacecontrol_tpu_torch import serving

    fwd = pallas_nl.nl_forward_fused
    failures, seconds, out = [], {}, {}
    env = make_env(MAIN_ENV)
    spec = env.spec
    cfg = port.Config(nl_hidden_units=WIDE, fused_nl_planner=True)
    terms = cfg.nl_s_recon_terms
    saved = Path(tmp) / "driver" / "wide" / "saved"
    ckpt = saved / model_checkpoint_name("nl", MAIN_ENV, DELAY, "exp", 0, True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    start = widen_nl(tracked, WIDE, seed=WIDE)
    save_pytree(str(ckpt), start)  # where train_model warm-starts
    common = ["--envs", MAIN_ENV, "--delays", str(DELAY), "--models", "nl", "--nl_hidden_units", str(WIDE),
              "--seed_runs", str(WIDE_SEEDS), "--offline_datasets_path", str(ROOT / "artifacts" / "offlinedata") + "/"]
    fwd.launches = fwd.rows = fwd.streamed_launches = fwd.streamed_rows = 0
    t0 = time.perf_counter()
    trained = driver.main(driver_args(tmp, "wide", *common, "--fused_nl_planner", "true", "--retrain", "true",
                                      "--train_gate", "none", "--train_seconds", str(WIDE_TRAIN_SECONDS)))
    torch.cuda.synchronize()
    seconds["train_and_kernel_eval"] = time.perf_counter() - t0
    launches = {"kernel": fwd.launches, "streamed": fwd.streamed_launches, "streamed_rows": fwd.streamed_rows}
    fwd.launches = fwd.rows = fwd.streamed_launches = fwd.streamed_rows = 0
    t0 = time.perf_counter()
    plain = driver.main(driver_args(tmp, "wide_plain", *common, "--fused_nl_planner", "false",
                                    "--saved_models_path", str(saved) + "/"))
    torch.cuda.synchronize()
    seconds["plain_eval"] = time.perf_counter() - t0
    launches["plain_route"] = fwd.launches
    recs = trained["records"] + plain["records"]
    expected = (EVAL_STEPS + 1) * T
    if len(recs) != 2 or any(r.get("errored") or not math.isfinite(r["total_reward"]) for r in recs):
        failures.append(f"records {recs}")
    else:
        a, b = (np.asarray(r["total_rewards"]) for r in recs)
        gap, limit = three_sigma(a, b)
        out["returns"] = {"kernel": [float(a.mean()), float(a.std())], "plain": [float(b.mean()), float(b.std())],
                          "gap": gap, "limit": limit,
                          "episode_batch_s": [r["episode_elapsed_time"] for r in recs]}
        if not gap <= limit:
            failures.append(f"kernel and plain returns {gap:.3f} apart, over the limit {limit:.3f}")
    if (launches["kernel"], launches["streamed"], launches["streamed_rows"], launches["plain_route"]) != (
            expected, expected, expected * WIDE_SEEDS * K, 0):
        failures.append(f"launches {launches}: expected {expected} streamed at {WIDE_SEEDS * K} rows, none plain")

    # the trained checkpoint: the forward on its weights, the replayed ticks, the exported step
    model = make_model("nl", MAIN_ENV, spec.n_obs, spec.m, spec.action_high, cfg, device=device)
    params = load_pytree(str(ckpt), device=device)
    # how far training moved the weights from the widened start, relative to the start's norm
    moved = [(x - y).square().sum() for x, y in zip(tree_leaves(params), tree_leaves(start))]
    out["moved_from_start"] = float(torch.stack(moved).sum().sqrt() / torch.stack(
        [y.square().sum() for y in tree_leaves(start)]).sum().sqrt())
    fused = model.make_fused_planner_apply(params, cfg.dt)
    rows = WIDE_SEEDS * K
    out["forward_plan"] = dict(nl_cuda.forward_plan(forward_dims(rows, fused, spec, terms)))
    rng = np.random.default_rng(WIDE)
    obs = torch.tensor(rng.standard_normal((rows, spec.n_obs)), dtype=torch.float32, device=device)
    acts = torch.tensor(rng.uniform(-spec.action_high, spec.action_high, (rows, 4 * spec.m)), dtype=torch.float32,
                        device=device)
    got = pallas_nl.nl_forward_fused(obs, acts, fused.packed, spec.n_obs, spec.m, terms=terms, hopper=fused.hopper)
    e = out["trained_forward"] = forward_errors(got, obs, acts, fused.packed, spec.n_obs, spec.m)
    if not e["kernel_vs_plain"] < KERNEL_TOL:
        failures.append(f"the kernel on the trained weights: {e}")
    ctrl = port.make_controller("nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K,
                                time_steps=T, device=device)
    before = fwd.streamed_launches
    gaps = replay_diffs([plain_controller(cfg, params, fused.packed, spec, device), ctrl,
                         plain_controller(cfg, params, fused.packed, spec, device, torch.float64)], env, device)
    launches["replay"] = fwd.streamed_launches - before
    out["replay"] = {"kernel_vs_plain": gaps[0], "plain64_vs_plain": gaps[1]}
    if not gaps[0] <= ACTION_TOL or launches["replay"] != REPLAY_TICKS * T:
        failures.append(f"replayed ticks: kernel and plain controllers {gaps[0]} apart (limit {ACTION_TOL}), "
                        f"{launches['replay']} streamed launches")
    ctrl = port.make_controller("nl", MAIN_ENV, DELAY, cfg, model_apply=model.apply, params=params, roll_outs=K,
                                time_steps=WIDE_EXPORT_T, device=device)
    t0 = time.perf_counter()
    step = serving.load_controller_step(serving.export_controller(ctrl, path=str(Path(tmp) / "wide.pt2")))
    seconds["export"] = time.perf_counter() - t0
    g = torch.Generator(device=device).manual_seed(1)
    eager = loaded = ctrl.reset(0)
    raw = env.reset(torch.Generator().manual_seed(0)).to(device)
    errs, per_tick = [], []
    for _ in range(WIDE_EXPORT_TICKS):
        obs = env.observe(raw)
        noise = torch.randn((K, WIDE_EXPORT_T, spec.m), generator=g, device=device) @ ctrl.mppi_params.noise_chol.T
        a_e, eager = ctrl.step(eager, obs, noise=noise)
        before = fwd.streamed_launches
        a_x, loaded = step(loaded, obs, noise=noise)
        torch.cuda.synchronize()
        per_tick.append(fwd.streamed_launches - before)
        errs.append(max(rel_err(a_x, a_e), rel_err(loaded.U, eager.U)))
        raw = env_step(env, raw, eager.action_buffer[-(DELAY + 1)], spec.dt)
    out["export"] = {"ticks": WIDE_EXPORT_TICKS, "T": WIDE_EXPORT_T, "max_rel_err": max(errs),
                     "streamed_launches_per_tick": per_tick}
    if not max(errs) <= DEPLOY_TICK_LIMIT or per_tick != [WIDE_EXPORT_T] * WIDE_EXPORT_TICKS:
        failures.append(f"exported step {out['export']} against the eager one (limit {DEPLOY_TICK_LIMIT})")
    out["launches"], out["seconds"] = launches, seconds
    out["failures"] = failures
    return out


def run_widths(device, smi: str, tmp: str) -> dict:
    """Phase ``widths``: the forward kernel at every width of ``WIDTHS`` (the
    resident variant up to 128, the streamed one past it) against its plain
    version, the head kernel at a wide input, and the driver at
    nl_hidden_units = ``WIDE`` end to end (``wide_driver_cell``)."""
    failures, seconds = [], {}
    _, tracked, _ = load_nl(MAIN_ENV, device)
    t0 = time.perf_counter()
    checks = [rec for width in WIDTHS for rec in width_forward_checks(device, width, tracked)]
    seconds["forward_checks"] = time.perf_counter() - t0
    failures += width_failures(checks)
    t0 = time.perf_counter()
    head = width_head_check(device)
    seconds["head"] = time.perf_counter() - t0
    if not head["max_rel_err"] < KERNEL_TOL:
        failures.append(f"head at Hx={WIDE_HEAD_HX}: relative error {head['max_rel_err']:.3e} >= {KERNEL_TOL}")
    t0 = time.perf_counter()
    cell = wide_driver_cell(device, tmp, tracked)
    seconds["driver_cell"] = time.perf_counter() - t0
    failures += [f"driver cell: {f}" for f in cell.pop("failures")]
    out = {"card": smi, "checks": checks, "head": head, "driver": cell, "seconds": seconds}
    print("widths " + json.dumps({"card": smi, "head": head, "driver": cell, "seconds": seconds}), flush=True)
    if failures:
        raise RuntimeError("phase widths: " + "; ".join(failures))
    return out


def kernels_line(records: dict, seed_batch: dict, launches: dict, training: dict, shard_rows: list,
                 precision_rows: dict, entry_launches: dict, widths: dict, main_plan: dict) -> dict:
    """One entry per kernel. The forward's times and bounds are at the
    evaluation's 20,000 rows, its launches the evaluation's; ``serving_tick``
    keeps its figures at the controller's 1,000 rows, ``trained_weights`` its
    launches in phase ``train`` and its error there on the weights the port
    trained, ``serve`` its times at the serve cell's 32,768 rows, and
    ``weight_loads`` the resident kernel's CTAs and the rows each CTA's
    weight load serves at the three sizes. The head is timed at 1,000 rows,
    the shape of its check.
    ``variants`` gives the launches of each variant: the resident kernel's
    on the main path at width 128 (the evaluation's launches less its
    streamed ones, with the tile and device launches per forward that
    ``main_plan``, the kernel library's plan at the evaluation's dims,
    gives), the streamed one's in phase widths' driver cell; ``widths``
    phase widths' checks at ``WIDTH_ROWS`` and its wide head."""
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
            main, recs = seed_batch, recs + [seed_batch, seed_batch["serve"]]
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
        if name == "nl_head":
            out[-1]["widths"] = {k: widths["head"][k] for k in ("Hx", "B", "max_rel_err", "ms", "plain_ms", "bound_ms")}
        if name == "nl_forward":
            out[-1]["trained_weights"] = {"launches": launches["train"][name],
                                          "max_rel_err": training["kernel_on_trained_weights"],
                                          "max_cond_err": training["kernel_cond_on_trained_weights"]}
            out[-1]["serve"] = {"B": SERVE_ROWS, **{k: seed_batch["serve"][k] for k in timed + ("eager_ms",)}}
            out[-1]["weight_loads"] = [{k: r[k] for k in ("B", "ctas", "cluster", "tile_rows", "rows_per_weight_load")}
                                       for r in (small, seed_batch, seed_batch["serve"])]
            out[-1]["table"] = {"launches": launches["table"], "rows": SEED_ROWS}
            out[-1]["driver"] = {"launches": launches["driver"]}
            out[-1]["change_goal"] = {"launches": launches["change_goal"]}
            out[-1]["deploy"] = {"launches": launches["deploy"]}
            out[-1]["precision"] = {"launches": launches["precision"], "rows": [
                {k: precision_rows[k] for k in ("B", "max_rel_err")}]}
            out[-1]["entry"] = {"launches": entry_launches}
            wl = widths["driver"]["launches"]
            out[-1]["variants"] = {
                "resident": {"launches": launches["eval"][name] - launches["eval"]["nl_forward_streamed"],
                             "rows": SEED_ROWS, "tile": main_plan["tile"],
                             "launches_per_forward": main_plan["launches"],
                             "source": "nl_kernels.cu::nl_forward_kernel", "phase": "eval"},
                "streamed": {"launches": wl["streamed"], "rows": wl["streamed_rows"] // max(1, wl["streamed"]),
                             "tile": widths["driver"]["forward_plan"]["tile"],
                             "launches_per_forward": widths["driver"]["forward_plan"]["launches"],
                             "source": "nl_kernels.cu::nl_wide_gemm_kernel and the nl_wide_* stage kernels",
                             "phase": "widths"},
            }
            out[-1]["widths"] = [{k: r[k] for k in ("width", "weights", "B", "variant", "tile",
                                                    "launches_per_forward", "smem_bytes",
                                                    "kernel_cond", "kernel_vs_plain", "kernel_vs_plain64", "resolved",
                                                    "ms", "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms",
                                                    "bound_tc_ms", "share_of_bound_tc") if k in r}
                                 for r in widths["checks"] if r["B"] in WIDTH_ROWS]
            out[-1]["shard"] = {"launches": launches["shard"], "rows": [
                {k: r[k] for k in ("B", "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by", "bound_share")
                 if k in r} for r in shard_rows]}
    return {"kernels": out}


# phases that need no earlier phase's output, for --phase
ALONE = {
    "kernels": lambda device, smi, tmp: (check_kernels(device), check_forward_seed_batch(device)),
    "controller": lambda device, smi, tmp: run_controller(device, smi),
    "eval": lambda device, smi, tmp: run_eval(device, smi),
    "ilt": lambda device, smi, tmp: run_ilt(device),
    "research": run_research,
    "table": run_table,
    "widths": run_widths,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    parser.add_argument("--phase", action="append", choices=sorted(ALONE),
                        help="run only the build and this phase (repeatable); every phase when absent")
    args = parser.parse_args(argv)
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

    if args.phase:
        with tempfile.TemporaryDirectory() as tmp:
            for name in args.phase:
                with phase(name):
                    ALONE[name](device, smi, tmp)
        print(smi, flush=True)
        return 0

    with phase("kernels"):
        records = check_kernels(device)
        seed_batch = check_forward_seed_batch(device)

    with tempfile.TemporaryDirectory() as tmp:
        # the table first: a torch.profiler trace (phase controller's is the
        # first) leaves the host's eager ops slower for the rest of the
        # process, and the table's oracle cells are host-bound
        with phase("table"):
            tabling = run_table(device, smi, tmp)

        with phase("controller"):
            result = run_controller(device, smi)

        with phase("eval"):
            evaluation = run_eval(device, smi)

        with phase("collect"):
            run_collect(device, tmp)

        with phase("deploy"):
            deploying = run_deploy(device, smi, tmp, result["tick_ms_mean"])

        with phase("ilt"):
            run_ilt(device)

        with phase("train"):
            training = run_train(device, smi, tmp)

        with phase("baselines"):
            run_baselines(device, smi, tmp, training["eval_results"])

        with phase("precision"):
            precision = run_precision(device, smi, evaluation["nl_returns"])

        with phase("research"):
            run_research(device, smi, tmp)

        with phase("driver"):
            driving = run_driver(device, smi, tmp)

        with phase("entry"):
            entry = run_entry(device, smi, tmp, tabling["results"])

        with phase("widths"):
            widths = run_widths(device, smi, tmp)

        with phase("shard"):
            sharding = run_shard(device, smi, evaluation["nl_returns"], tmp)

    total = time.perf_counter() - t_start
    print(f"total {total:.3f} s", flush=True)
    print("phase seconds " + json.dumps({**{k: round(v, 3) for k, v in PHASE_SECONDS.items()},
                                          "parts": {k: round(v, 3) for k, v in PART_SECONDS.items()},
                                          "budget": TOTAL_BUDGET_S, "within_budget": total <= TOTAL_BUDGET_S}),
          flush=True)
    launches = {"controller": result["launches"], "eval": evaluation["launches"],
                "change_goal": evaluation["change_goal"]["launches"], "deploy": deploying["launches_total"],
                "train": training["launches"], "driver": driving["launches"], "shard": sharding["launches"],
                "precision": precision["launches"], "table": tabling["launches"]}
    print(json.dumps(kernels_line(records, seed_batch, launches, training, sharding["kernel_checks"],
                                  precision["kernel_check"], entry["launches"], widths,
                                  evaluation["forward_plan"])), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

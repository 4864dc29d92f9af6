"""Configuration for the port: the JAX package's ``Config`` and ``parse_args``.

Same fields, names and defaults as ``neurallaplacecontrol_tpu/config.py``, a
frozen dataclass with real booleans built from CLI arguments by
``parse_args``. A field whose non-default value the port cannot honour
raises where it is read (``nl_compute_dtype="bfloat16"``). Some fields are read
by nothing, in the JAX package either: they are kept so that a command line
or a config dict that names them means the same in both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Config:
    # experiment grid (the driver's seeds are range(seed_start, seed_start + seed_runs))
    seed_runs: int = 20
    seed_start: int = 0
    baselines: Sequence[str] = (  # read by nothing; not on the command line
        "nl",
        "oracle",
        "random",
        "delta_t_rnn",
        "node",
        "latent_ode",
    )
    dt: float = 0.05

    # training
    learning_rate: float = 1e-4
    training_epochs: int = 10_000_000
    training_batch_size: int = 16
    iters_per_log: int = 500
    clip_grad_norm: float = 0.1
    # reject-don't-clip guard: an update whose batch loss exceeds this factor
    # times the previous segment's median loss (or is non-finite) leaves the
    # params and the Adam state untouched; None or 0 disables the factor cap
    # (non-finite losses are always skipped)
    training_loss_skip_factor: Optional[float] = 100.0
    normalize: bool = True
    normalize_time: bool = True
    train_dt_multiple: float = 1.0
    ts_grid: str = "exp"  # ['fixed', 'uniform', 'exp']
    train_samples_per_dim: int = 10
    weight_decay: float = 0.0
    lr_scheduler_step_size: int = 20
    lr_scheduler_gamma: float = 0.1
    use_lr_scheduler: bool = False
    iters_per_evaluation: float = 1e15
    end_training_after_seconds: Optional[float] = 180.0
    sweep_mode: bool = False  # read by nothing
    training_use_only_samples: Optional[int] = None
    train_with_expert_trajectories: bool = True
    rand_sample: bool = True
    reuse_state_actions_when_sampling_times: bool = False

    # expert data collection
    collect_expert_samples: float = 1e6
    collect_expert_ts_grid: str = "exp"
    collect_expert_force_generate_new_data: bool = False
    collect_expert_random_action_noise: Optional[float] = 1.0
    # the reference's sampler pool sizes: read by nothing (collection runs
    # its episodes as one seed batch)
    collect_expert_cores_per_env_sampler: int = 20
    collect_expert_episodes_per_sampler_task: int = 1

    # models
    nl_ilt_algorithm: str = "fourier"
    nl_hidden_units: int = 128
    nl_s_recon_terms: int = 17
    nl_compute_dtype: str = "float32"
    node_method: str = "euler"
    node_augment_dim: int = 1
    node_hidden_units: int = 270
    rnn_hidden_units: int = 160
    latent_ode_hidden_units: int = 128
    latent_ode_obsrv_std: float = 0.01

    # MPPI planner
    mppi_roll_outs: int = 1000
    mppi_time_steps: int = 40
    mppi_lambda: float = 1.0
    mppi_sigma: float = 1.0
    # the JAX planner's lax.scan unroll factor, which leaves results as they
    # are; the port's horizon is an eager Python loop, so it has no effect
    mppi_scan_unroll: int = 1
    # run the NL planner dynamics through the fused forward kernel
    # (ops.pallas_nl); fourier ILT only
    fused_nl_planner: bool = False
    # encode every NL planner window in one call before the horizon loop
    # (the planner's window_encoder); the fused planner takes precedence
    nl_planner_precompute: bool = False

    # episode / env protocol
    encode_obs_time: bool = False
    action_buffer_size: int = 4
    observation_noise: float = 0.0
    friction: bool = False

    # bookkeeping
    saved_models_path: str = "./saved_models/"
    offline_datasets_path: str = "./offlinedata/"
    log_folder: str = "logs"  # the driver's log files
    save_video: bool = False  # evaluation writes the first seed's episode (envs.render)
    model_seed: int = 0
    multi_process_results: bool = True  # read by nothing
    retrain: bool = False
    force_retrain: bool = False
    start_from_checkpoint: bool = True
    print_settings: bool = False  # read by nothing

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool):
    parser.add_argument(f"--{name}", type=lambda v: v.lower() in ("true", "1", "yes"), default=default)


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    """A ``Config`` from CLI arguments: every scalar field is a flag named as
    the field (``baselines`` is not on the command line). A bool flag is true
    for ``true``, ``1`` or ``yes`` in any case; an Optional field keeps its
    scalar type (``--training_use_only_samples 1000`` is an int). Arguments
    that name no field are left for the caller."""
    defaults = Config()
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        default = getattr(defaults, f.name)
        if isinstance(default, bool):
            _add_bool_flag(parser, f.name, default)
        elif isinstance(default, (int, float, str)):
            parser.add_argument(f"--{f.name}", type=type(default), default=default)
        elif default is None:
            parser.add_argument(f"--{f.name}", type=int if "int" in str(f.type) else float, default=None)
    ns, _ = parser.parse_known_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(ns).items() if k in known})


def cme_reconstruction_terms() -> tuple:
    """Valid CME term counts (reference: config.py:278-418): odd orders
    assembled from the published table."""
    base = tuple(range(3, 76))
    mid = tuple(range(101, 212, 10)) + (216,) + tuple(range(221, 392, 10)) + (396,)
    high = tuple(range(401, 482, 20)) + tuple(range(501, 1002, 20))
    return base + mid + high


def snap_cme_terms(s_recon_terms: int) -> int:
    """Snap a requested term count to a valid CME order (w_nl.py:86-88)."""
    terms = np.asarray(cme_reconstruction_terms())
    return int(terms[np.argmin(terms < s_recon_terms) - 2])

"""The port's Config and parse_args against the JAX package's: the same
fields and defaults, and parse_args gives the same value for every field."""

import dataclasses

import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.config import parse_args as jax_parse_args
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.config import parse_args

torch.set_num_threads(1)

ARGVS = {
    "defaults": [],
    "driver_mini": ["--dt", "0.5", "--mppi_roll_outs", "8", "--mppi_time_steps", "3", "--retrain", "true",
                    "--force_retrain", "TRUE", "--train_with_expert_trajectories", "false",
                    "--train_samples_per_dim", "3", "--iters_per_log", "50", "--saved_models_path", "/tmp/x/",
                    "--log_folder", "/tmp/x", "--seed_runs", "2", "--seed_start", "3"],
    "optional_scalars": ["--training_use_only_samples", "1000", "--end_training_after_seconds", "12",
                         "--collect_expert_random_action_noise", "0.25", "--training_loss_skip_factor", "0"],
    "bool_spellings": ["--fused_nl_planner", "1", "--normalize", "no", "--friction", "Yes",
                       "--start_from_checkpoint", "0", "--sweep_mode", "yes", "--print_settings", "true"],
    "unknown_left_alone": ["--envs", "oderl-pendulum", "--dt", "0.25", "--shard", "none",
                           "--mppi_scan_unroll", "4", "--collect_expert_samples", "4000"],
}


def test_same_fields_and_defaults():
    """Every field of the JAX Config, in its order, with its default."""
    assert [f.name for f in dataclasses.fields(TConfig)] == [f.name for f in dataclasses.fields(JConfig)]
    assert TConfig().as_dict() == JConfig().as_dict()


@pytest.mark.parametrize("argv", list(ARGVS.values()), ids=list(ARGVS))
def test_parse_args_matches_jax(argv):
    got, exp = parse_args(argv).as_dict(), jax_parse_args(argv).as_dict()
    assert got == exp
    for name, value in exp.items():
        assert type(got[name]) is type(value), name


def test_parse_args_types():
    cfg = parse_args(ARGVS["optional_scalars"])
    assert cfg.training_use_only_samples == 1000 and isinstance(cfg.training_use_only_samples, int)
    assert cfg.end_training_after_seconds == 12.0 and isinstance(cfg.end_training_after_seconds, float)
    cfg = parse_args(ARGVS["bool_spellings"])
    assert cfg.fused_nl_planner and not cfg.normalize and cfg.friction and not cfg.start_from_checkpoint
    assert parse_args([]) == TConfig() and parse_args(["--baselines", "nl"]).baselines == TConfig().baselines


def test_replace_and_as_dict():
    cfg = TConfig().replace(dt=0.5, mppi_scan_unroll=2)
    assert cfg.dt == 0.5 and cfg.as_dict()["mppi_scan_unroll"] == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.dt = 1.0

"""A run with the timed path broken underneath comes out not correct: each
fault that the cells can have, planted in the port for the run (on the CPU,
at a tiny size, the look for a card skipped)."""

import inspect
import textwrap

import pytest
import torch

from neurallaplacecontrol_tpu_torch.envs import cartpole as port_cartpole
from neurallaplacecontrol_tpu_torch.planners import mppi_delay
from neurallaplacecontrol_tpu_torch.training import rollout

from .test_portbench_run import run_cpu

torch.set_num_threads(1)
core = mppi_delay.mppi_command_core


def plan_unchanged(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise, **kw):
    """A step that returns its state unchanged: the plan comes back as it went in."""
    core(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise, **kw)
    return U[..., 0, :] * cfg.u_scale, U, {}


def half_the_rollouts(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise, **kw):
    """Half of the batch left out: the softmax mean over the first K/2 rollouts."""
    return core(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer,
                noise[..., : noise.shape[-3] // 2, :, :], **kw)


def action_altered(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise, **kw):
    """An answer altered where it is produced: the action 20% of its bound off."""
    action, U, aux = core(cfg, params, dynamics_fn, running_cost_fn, U, obs, action_buffer, noise, **kw)
    return action + 0.2 * cfg.u_max, U, aux


def frozen_plant(friction):
    """The plant's step returns the state unchanged."""
    return lambda state, action: torch.zeros_like(state)


def state_not_advanced():
    """``make_episode_fn`` with ``raw = raw_next`` left out of its loop: every
    tick starts from the plant state the episode started in."""
    src = textwrap.dedent(inspect.getsource(rollout.make_episode_fn))
    assert src.count("raw = raw_next\n") == 1
    namespace = dict(vars(rollout))
    exec(compile(src.replace("raw = raw_next\n", "pass\n"), rollout.__file__, "exec"), namespace)
    return namespace["make_episode_fn"]


PLANNER_FAULTS = [plan_unchanged, half_the_rollouts, action_altered]


@pytest.mark.parametrize("cell", ["nl128-eval-s20", "nl128-serve-k32768", "nl512-eval-s10"])
@pytest.mark.parametrize("fault", PLANNER_FAULTS, ids=lambda f: f.__name__)
def test_planner_fault_is_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(mppi_delay, "mppi_command_core", fault)
    result = run_cpu(cell)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["nl128-eval-s20", "nl512-eval-s10"])
def test_frozen_plant_is_not_correct(monkeypatch, cell):
    monkeypatch.setattr(port_cartpole, "make_rhs", frozen_plant)
    result = run_cpu(cell)
    assert result["correct"] is False
    assert result["checks"]["transition_gap"]["value"] > result["checks"]["transition_gap"]["limit"]


@pytest.mark.parametrize("cell", ["nl128-eval-s20", "nl512-eval-s10"])
def test_state_not_advanced_is_not_correct(monkeypatch, cell):
    monkeypatch.setattr(rollout, "make_episode_fn", state_not_advanced())
    result = run_cpu(cell)
    assert result["correct"] is False
    assert result["checks"]["transition_gap"]["value"] > result["checks"]["transition_gap"]["limit"]


def test_sound_run_is_correct():
    assert run_cpu("nl128-eval-s20")["correct"] is True

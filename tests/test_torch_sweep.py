"""The port's MPPI sweep (training.sweep) against the JAX package's: the same
trials from the same seed, and, with one deterministic scorer patched into
both packages' evaluate_policy, the same rung records and best trial; then a
small sweep through the port's real evaluate_policy on the CPU."""

import json

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.training import sweep as jsweep
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.training import sweep as tsweep

torch.set_num_threads(1)

SPECS = {
    "default": {},
    "smoke": dict(n_trials=3, base_seeds=2, max_seeds=6, roll_outs=(256, 1000, 4096), time_steps=(20, 40)),
    "eta2": dict(n_trials=10, eta=2, base_seeds=1, max_seeds=8, lambdas=(0.1, 1.0), sigmas=(0.5, 1.0)),
}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_trials_match_jax(spec, seed):
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    t_spec, j_spec = tsweep.SweepSpec(**SPECS[spec]), jsweep.SweepSpec(**SPECS[spec])
    got = [tsweep._sample_trial(rng_t, t_spec) for _ in range(t_spec.n_trials)]
    exp = [jsweep._sample_trial(rng_j, j_spec) for _ in range(j_spec.n_trials)]
    assert got == exp
    assert all(type(got[0][k]) is type(exp[0][k]) for k in exp[0])


def scorer(calls):
    """A deterministic stand-in for evaluate_policy: the mean return is a
    fixed function of the trial and its seeds."""

    def evaluate(model_name, env_name, delay, seeds, config, roll_outs, time_steps, **kw):
        seeds = list(seeds)
        calls.append((roll_outs, time_steps, config.mppi_lambda, config.mppi_sigma, tuple(seeds)))
        r = -abs(np.log10(config.mppi_sigma) + 0.3) * 100 - abs(np.log10(config.mppi_lambda)) * 10
        r += np.log2(roll_outs) + 0.1 * time_steps + 0.01 * sum(seeds)
        return {"total_reward": float(r)}

    return evaluate


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_halving_matches_jax(spec, monkeypatch, tmp_path):
    t_calls, j_calls = [], []
    monkeypatch.setattr(tsweep, "evaluate_policy", scorer(t_calls))
    monkeypatch.setattr(jsweep, "evaluate_policy", scorer(j_calls))
    got = tsweep.run_mppi_sweep("nl", "oderl-cartpole", 1, TConfig(), tsweep.SweepSpec(**SPECS[spec]), seed=3,
                                results_path=str(tmp_path / "t.jsonl"), device="cpu")
    exp = jsweep.run_mppi_sweep("nl", "oderl-cartpole", 1, spec=jsweep.SweepSpec(**SPECS[spec]), seed=3,
                                results_path=str(tmp_path / "j.jsonl"))
    assert got == exp and t_calls == j_calls
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    rungs = sorted({r["rung"] for r in got["trials"]})
    assert rungs == list(range(len(rungs))) and len(got["trials"]) == len(t_calls)


def test_sweep_runs_evaluate_policy(tmp_path):
    """The counterpart of tests/test_render_sweep.py::test_mppi_sweep_halving
    on the port's evaluate_policy: a 3-trial oracle sweep on 20-step
    episodes; halving keeps the best trial and every evaluation writes a
    record."""
    spec = tsweep.SweepSpec(roll_outs=(8, 16), time_steps=(3, 5), lambdas=(1.0,), sigmas=(1.0,), n_trials=3,
                            base_seeds=1, max_seeds=2)
    path = tmp_path / "sweep.jsonl"
    best = tsweep.run_mppi_sweep("oracle", "oderl-pendulum", 0, TConfig(dt=0.5), spec, results_path=str(path),
                                 device="cpu")
    assert best["mppi_roll_outs"] in (8, 16) and np.isfinite(best["total_reward"])
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == len(best["trials"]) == 4  # 3 trials at rung 0, the best at rung 1
    assert [r["n_seeds"] for r in lines] == [1, 1, 1, 2]
    assert max(lines[:3], key=lambda r: r["total_reward"])["mppi_roll_outs"] == best["mppi_roll_outs"]

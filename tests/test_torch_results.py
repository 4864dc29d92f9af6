"""The port's results tools against the JAX package's on the same records:
latex_table, the summarize CLI with and without --ci, parse_log_file (with
the nan/inf case), results_table and the JSONL sink; and the plots render."""

import json
import math

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.results import process as jprocess
from neurallaplacecontrol_tpu.results import summarize as jsummarize
from neurallaplacecontrol_tpu.utils import logging as jlogging
from neurallaplacecontrol_tpu_torch.results import process as tprocess
from neurallaplacecontrol_tpu_torch.results import summarize as tsummarize
from neurallaplacecontrol_tpu_torch.utils import logging as tlogging

torch.set_num_threads(1)


def grid_records():
    """A 2-env x 2-delay grid of 5-seed records with an errored cell, a cell
    with no baselines of its own at delay 2 (skipped) and one at delay 1
    (the reference constants)."""
    rng = np.random.default_rng(0)
    recs = []
    for env in ("oderl-pendulum", "oderl-acrobot"):
        for delay in (0, 1, 2):
            models = ("nl", "oracle", "random", "rnn") if delay < 2 or env == "oderl-acrobot" else ("nl",)
            for model in models:
                if env == "oderl-acrobot" and delay == 1 and model in ("oracle", "random"):
                    continue
                base = {"oracle": -120.0, "random": -600.0, "nl": -150.0, "rnn": -500.0}[model]
                rewards = (base + 40.0 * rng.standard_normal(5)).tolist()
                recs.append({"env_name": env, "model_name": model, "delay": delay, "seeds": list(range(5)),
                             "total_rewards": rewards, "total_reward": float(np.mean(rewards)),
                             "total_reward_std": float(np.std(rewards)), "errored": False})
    recs.append({"env_name": "oderl-pendulum", "model_name": "node", "delay": 0, "errored": True})
    return recs


@pytest.mark.parametrize("agg", ["std", "ci95"])
@pytest.mark.parametrize("subset", ["all", "one_env", "given_axes"])
def test_latex_table_matches_jax(agg, subset):
    recs = [r for r in grid_records() if not r.get("errored")]
    kw = {}
    if subset == "one_env":
        recs = [r for r in recs if r["env_name"] == "oderl-pendulum"]
    elif subset == "given_axes":
        kw = dict(models=["rnn", "nl", "absent"], envs=["oderl-acrobot"], delays=[1, 0])
    got = tprocess.latex_table(recs, agg=agg, **kw)
    assert got == jprocess.latex_table(recs, agg=agg, **kw)
    assert got.startswith("\\begin{tabular}") and "\\pm" in got


SIX_MODELS = ("nl", "oracle", "random", "delta_t_rnn", "node", "latent_ode")


@pytest.mark.parametrize("agg,models", [("std", SIX_MODELS[:3]), ("ci95", SIX_MODELS[:3]), ("std", SIX_MODELS),
                                        ("ci95", SIX_MODELS)],
                         ids=["std", "ci95", "six_models_std", "six_models_ci95"])
def test_paper_table_matches_jax(agg, models):
    """The paper's 12 cells from the JAX package's full-run records, the
    pendulum d0 NL record last, as the driver's age-channel call appends it
    to the file: {nl, oracle, random} (36 records), and the six models of
    the paper's table (all 72). The scores and the table equal the JAX
    package's, with every cell present and a row for each model."""
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "artifacts" / "results_full_r5.jsonl"
    recs = [r for r in map(json.loads, path.read_text().splitlines()) if r["model_name"] in models]
    age = [r for r in recs if (r["env_name"], r["delay"], r["model_name"]) == ("oderl-pendulum", 0, "nl")]
    recs = [r for r in recs if r not in age] + age
    assert len(recs) == 12 * len(models)
    got = tprocess.normalized_scores(recs, agg=agg)
    assert got == jprocess.normalized_scores(recs, agg=agg) and len(got) == len(recs)
    table = tprocess.latex_table(recs, agg=agg)
    assert table == jprocess.latex_table(recs, agg=agg)
    assert table.count("(d=") == 12 and "--" not in table
    assert [line.split(" & ")[0] for line in table.splitlines()[4:-2]] == sorted(models)


@pytest.mark.parametrize("ci", [False, True], ids=["std", "ci"])
def test_summarize_matches_jax(ci, tmp_path, capsys):
    path = tmp_path / "results.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in grid_records()) + "\n\n")
    argv = [str(path)] + (["--ci"] if ci else [])
    tsummarize.main(argv)
    got = capsys.readouterr().out
    jsummarize.main(argv)
    exp = capsys.readouterr().out
    assert got == exp
    assert ("ci95, n=5" if ci else "std, n=5") in got and "node" not in got


LOG = (
    "08:00:00,1 root INFO [trained oderl-pendulum nl d=0] loss=0.1 (12s)\n"
    "08:01:00,2 root INFO [Model Completed evaluation mppi] {'model_name': 'nl', 'env_name': "
    "'oderl-pendulum', 'delay': 0, 'total_reward': -130.0, 'total_reward_std': 4.0}\n"
    "08:02:00,3 root INFO [Model Completed evaluation mppi] not-a-dict\n"
    "08:03:00,4 root INFO [Model Completed evaluation mppi] {'model_name': 'rnn', 'env_name': "
    "'oderl-pendulum', 'delay': 1, 'total_reward': nan, 'total_reward_std': inf}\n"
    "08:04:00,5 root INFO [Model Completed evaluation mppi] {'model_name': 'node', 'env_name': "
    "'oderl-acrobot', 'delay': 2, 'total_reward': -inf, 'total_reward_std': nan}\n"
    "08:05:00,6 root INFO [Model Completed evaluation mppi] [1, 2]\n"
)


def test_parse_log_file_matches_jax(tmp_path):
    """The same records as JAX's parser, nan and +-inf kept as floats."""
    log = tmp_path / "run_log.txt"
    log.write_text(LOG)
    got, exp = tprocess.parse_log_file(log), jprocess.parse_log_file(log)
    assert len(got) == len(exp) == 3
    for g, e in zip(got, exp):
        assert set(g) == set(e)
        for k in e:
            if isinstance(e[k], float) and math.isnan(e[k]):
                assert math.isnan(g[k]), k
            else:
                assert g[k] == e[k], k
    assert math.isnan(got[1]["total_reward"]) and got[1]["total_reward_std"] == math.inf
    assert got[2]["total_reward"] == -math.inf


def test_results_table_and_jsonl_writer_match_jax(tmp_path):
    flat = [{"env_name": r["env_name"], "model_name": r["model_name"], "delay": r["delay"],
             "total_reward": x} for r in grid_records() if not r.get("errored") for x in r["total_rewards"]]
    assert tlogging.results_table(flat) == jlogging.results_table(flat)
    writer = tlogging.JsonlWriter(str(tmp_path / "sub" / "r.jsonl"))
    assert writer.read_all() == []
    for r in grid_records():
        writer.write(r)
    writer.write({"x": np.float32(1.5)})  # numpy scalars go through float
    assert writer.read_all() == jlogging.JsonlWriter(str(tmp_path / "sub" / "r.jsonl")).read_all()
    assert writer.read_all()[-1] == {"x": 1.5}


def test_plots_render(tmp_path):
    """The three plots write their files; the trajectory plot reads tensors."""
    from neurallaplacecontrol_tpu_torch.results import plotting

    recs = [r for r in grid_records() if not r.get("errored")]
    assert plotting.plot_matrix_scores(recs, path=str(tmp_path / "m.png")) == str(tmp_path / "m.png")
    assert plotting.plot_episode_returns(grid_records(), path=str(tmp_path / "e.png")) == str(tmp_path / "e.png")
    ts = torch.linspace(0.0, 1.0, 10)
    traj = torch.stack([torch.sin(ts), torch.cos(ts)], dim=-1)
    out = plotting.plot_trajectories(ts, traj[None], traj + 0.1, path=str(tmp_path / "t.png"), title="x")
    assert out == str(tmp_path / "t.png")
    for name in ("m.png", "e.png", "t.png"):
        assert (tmp_path / name).stat().st_size > 1000
    fig = plotting.plot_trajectories(ts.numpy(), traj.numpy(), dims=[1])
    assert len(fig.axes) == 1
    plotting._plt().close(fig)

"""The port's experiment driver (run_exp_multi_torch.main) on miniature grids
on the CPU (dt 0.5, K=8, T=3, narrow models, a second or two of training):
train -> gate -> evaluate -> JSONL -> the normalized table; the gates'
reseeding, the quarantine, the refusals, and the record's keys against the
JAX package's evaluate_policy."""

import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.training.eval import evaluate_policy as jax_evaluate
from neurallaplacecontrol_tpu_torch.results import latex_table, parse_log_file
from neurallaplacecontrol_tpu_torch.results import summarize

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import run_exp_multi_torch as driver  # noqa: E402

torch.set_num_threads(1)


def argv(tmp_path, *extra, seeds=2):
    return [
        "--envs", "oderl-pendulum", "--results", str(tmp_path / "results.jsonl"), "--device", "cpu",
        "--seed_runs", str(seeds), "--dt", "0.5", "--mppi_roll_outs", "8", "--mppi_time_steps", "3",
        "--train_with_expert_trajectories", "false", "--train_samples_per_dim", "3", "--iters_per_log", "50",
        "--nl_hidden_units", "16", "--rnn_hidden_units", "32", "--saved_models_path", str(tmp_path) + "/",
        "--log_folder", str(tmp_path), *extra,
    ]


def read(tmp_path):
    return [json.loads(line) for line in (tmp_path / "results.jsonl").read_text().splitlines()]


TRAIN = ("--retrain", "true", "--force_retrain", "true", "--train_seconds", "1")


def test_driver_mini_grid(tmp_path, capsys):
    """The port's counterpart of tests/test_driver.py::test_driver_mini_grid:
    nl trained and evaluated beside random; every record finite, with the
    keys of the JAX package's evaluate_policy and ``errored``; the log's
    result lines parse back; summarize over the JSONL prints the table of
    the records main returns."""
    out = driver.main(argv(tmp_path, "--delays", "0", "--models", "nl,random", *TRAIN, "--train_gate", "none"))
    recs = read(tmp_path)
    assert recs == out["records"] and out["gates"] == []
    assert {r["model_name"] for r in recs} == {"nl", "random"}
    exp_keys = set(jax_evaluate("random", "oderl-pendulum", 0, [0], JConfig(dt=0.5), roll_outs=8, time_steps=3))
    for r in recs:
        assert set(r) == exp_keys | {"errored"} and not r["errored"]
        assert len(r["total_rewards"]) == 2 and np.isfinite(r["total_reward"])
    assert any(f.startswith("nl_") and f.endswith(".npz") for f in os.listdir(tmp_path))
    logs = list(tmp_path.glob("run_exp_multi_torch-*_log.txt"))
    parsed = [r for log in logs for r in parse_log_file(log)]
    assert [(r["model_name"], r["total_reward"]) for r in parsed] == [
        (r["model_name"], r["total_reward"]) for r in recs]
    capsys.readouterr()
    summarize.main([str(tmp_path / "results.jsonl")])
    assert capsys.readouterr().out.rstrip().endswith(latex_table(recs))


def test_driver_train_gate_reseeds_planted_bad_draw(tmp_path, monkeypatch):
    """The counterpart of tests/test_driver.py::
    test_driver_train_gate_reseeds_planted_bad_individual_draw: the first
    gate check's return is planted at -1e9 and the second's at +1e9, so
    exactly one retrain runs, with model_seed + 1, from the init, and the
    final evaluation is the honest one. Gate checks run on 2 seeds, the
    final evaluation on 3."""
    reseeded, gate_evals = [], []
    real_train, real_eval = driver.train_model, driver.evaluate_policy

    def counting_train(model_name, env_name, config, **kw):
        if kw.get("force_retrain") and not kw.get("start_from_checkpoint", True):
            reseeded.append((model_name, kw.get("delay"), kw.get("model_seed")))
        return real_train(model_name, env_name, config, **kw)

    def planted_eval(model_name, env_name, delay, **kw):
        r = real_eval(model_name, env_name, delay, **kw)
        if model_name == "rnn" and "params" in kw and len(kw["seeds"]) == 2:
            gate_evals.append(kw["seeds"])
            r = dict(r, total_reward=-1e9 if len(gate_evals) == 1 else 1e9)
        return r

    monkeypatch.setattr(driver, "train_model", counting_train)
    monkeypatch.setattr(driver, "evaluate_policy", planted_eval)
    out = driver.main(argv(tmp_path, "--delays", "0", "--models", "rnn,random", *TRAIN, "--train_gate", "rnn",
                           "--train_gate_retries", "2", "--ensemble_gate_seeds", "2", "--ensemble_gate_margin", "0",
                           "--model_seed", "7", seeds=3))
    assert reseeded == [("rnn", 0, 8)] and len(gate_evals) == 2
    assert [(g["attempt"], g["model_seed"], g["ok"]) for g in out["gates"]] == [(0, 7, False), (1, 8, True)]
    gate = out["gates"][0]
    assert gate["threshold"] == gate["random_return"] and gate["model_return"] == -1e9
    by_model = {r["model_name"]: r for r in read(tmp_path) if not r["errored"]}
    assert set(by_model) == {"rnn", "random"} and by_model["rnn"]["total_reward"] > -1e8


def test_driver_train_gate_none_skips_control_eval(tmp_path, monkeypatch):
    """--train_gate none spends no control evaluation: the only
    evaluate_policy call is the cell's own."""
    calls = []
    real_eval = driver.evaluate_policy

    def spying_eval(model_name, env_name, delay, **kw):
        calls.append(model_name)
        return real_eval(model_name, env_name, delay, **kw)

    monkeypatch.setattr(driver, "evaluate_policy", spying_eval)
    driver.main(argv(tmp_path, "--delays", "0", "--models", "rnn", *TRAIN, "--train_gate", "none"))
    assert calls == ["rnn"]


def test_driver_quarantines_a_failing_cell(tmp_path):
    """A cell that raises (rnn at delay 2 has no checkpoint under this
    saved_models_path and nothing trains it) records {"errored": true} and
    the grid goes on to the next cell."""
    out = driver.main(argv(tmp_path, "--delays", "2", "--models", "rnn,oracle"))
    recs = read(tmp_path)
    assert recs == out["records"]
    assert recs[0] == {"model_name": "rnn", "env_name": "oderl-pendulum", "delay": 2, "errored": True}
    assert recs[1]["model_name"] == "oracle" and not recs[1]["errored"]
    log = next(tmp_path.glob("run_exp_multi_torch-*_log.txt")).read_text()
    assert "eval FAILED oderl-pendulum rnn d=2" in log and "No checkpoint" in log


def test_driver_takes_latent_ode_ref_as_jax_does(tmp_path):
    """``--models latent_ode_ref``: JAX's parser takes any name (its MODELS
    is only the default), and the port's now evaluates this family, so the
    cell runs; with no checkpoint under saved_models_path and nothing
    training it, it is recorded as errored, as JAX's quarantine records it."""
    out = driver.main(argv(tmp_path, "--delays", "1", "--envs", "oderl-cartpole",
                           "--models", "latent_ode_ref,oracle"))
    recs = read(tmp_path)
    assert recs == out["records"]
    assert recs[0] == {"model_name": "latent_ode_ref", "env_name": "oderl-cartpole", "delay": 1, "errored": True}
    assert recs[1]["model_name"] == "oracle" and not recs[1]["errored"]
    log = next(tmp_path.glob("run_exp_multi_torch-*_log.txt")).read_text()
    assert "eval FAILED oderl-cartpole latent_ode_ref d=1" in log and "No checkpoint" in log


@pytest.mark.parametrize("extra,message", [
    (("--shard", "grid:2"), "grid:NSxNK"),
    (("--shard", "grid:0x2"), "grid:NSxNK"),
    (("--shard", "grid:2xk"), "grid:NSxNK"),
    (("--shard", "bogus"), "none|seeds|rollouts"),
    (("--models", "nl,latent_ode_refs"), "latent_ode_ref"),  # a name no family has
    (("--models", "bogus"), "bogus"),
    (("--multihost", "127.0.0.1:1,2", "--ensemble_delays", "true", "--delays", "0,1"), "incompatible"),
    (("--multihost", "127.0.0.1:1"), "coordinator_host:port,N"),
])
def test_driver_refuses_before_any_work(extra, message, tmp_path, monkeypatch, capsys):
    """Refusals are parser errors before any work: nothing evaluated, no
    log, no results file. A malformed --shard never falls back to an
    unsharded run."""
    monkeypatch.setattr(driver, "evaluate_policy", lambda *a, **k: pytest.fail("evaluated"))
    args = argv(tmp_path / "run", "--delays", "0", "--models", "oracle")
    with pytest.raises(SystemExit) as exc:
        driver.main(args + list(extra))
    assert exc.value.code == 2 and message in capsys.readouterr().err
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("extra,message,world", [
    (("--multihost", "127.0.0.1:1,2", "--shard", "seeds"), "pass one", 2),
    ((), "evaluates with --shard", 2),
    (("--shard", "seeds", "--ensemble_delays", "true", "--delays", "0,1"), "--ensemble_delays", 4),
], ids=["multihost_and_torchrun", "several_ranks_unsharded", "ensemble_on_several_ranks"])
def test_driver_refuses_under_torchrun(extra, message, world, tmp_path, monkeypatch, capsys):
    """Under torchrun's environment (hosts of 2 ranks) the refusals come
    before the process group is joined: two names for the group, ranks that
    would all run the same unsharded cells, and ensemble training over a
    group of several hosts (2 of 2 ranks here; one host of several ranks
    trains it on its first rank: tests/test_torch_multihost.py)."""
    for key, value in dict(RANK="0", WORLD_SIZE=str(world), LOCAL_RANK="0", LOCAL_WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(driver.multihost, "initialize", lambda *a, **k: pytest.fail("joined a group"))
    args = argv(tmp_path / "run", "--delays", "0", "--models", "oracle")
    with pytest.raises(SystemExit) as exc:
        driver.main(args + list(extra))
    assert exc.value.code == 2 and message in capsys.readouterr().err
    assert not (tmp_path / "run").exists()


def test_driver_needs_cuda_or_cpu(tmp_path, monkeypatch):
    """The default --device cuda raises where CUDA is absent; nothing drops to
    the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in argv(tmp_path / "run", "--delays", "0", "--models", "oracle") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(args)
    assert not (tmp_path / "run").exists()


def test_driver_ensemble_with_gate_and_profile_trace(tmp_path, monkeypatch):
    """The counterparts of tests/test_driver.py's ensemble tests: rnn trains
    as a 2-delay ensemble; its first gate check is planted to fail, so that
    delay alone is retrained per delay from the init; both delays end up
    evaluated. --profile_trace_dir writes a Chrome trace per cell."""
    ensembled, retrains = [], []
    real_ens, real_train, real_eval = driver.train_model_ensemble, driver.train_model, driver.evaluate_policy

    def spy_ensemble(model_name, env_name, config, **kw):
        ensembled.append((model_name, tuple(kw["delays"])))
        return real_ens(model_name, env_name, config, **kw)

    def spy_train(model_name, env_name, config, **kw):
        retrains.append((model_name, kw.get("delay"), kw.get("start_from_checkpoint")))
        return real_train(model_name, env_name, config, **kw)

    def planted_eval(model_name, env_name, delay, **kw):
        r = real_eval(model_name, env_name, delay, **kw)
        if model_name == "rnn" and "params" in kw and not retrains:
            r = dict(r, total_reward=-1e9)
        return r

    monkeypatch.setattr(driver, "train_model_ensemble", spy_ensemble)
    monkeypatch.setattr(driver, "train_model", spy_train)
    monkeypatch.setattr(driver, "evaluate_policy", planted_eval)
    traces = tmp_path / "traces"
    out = driver.main(argv(tmp_path, "--delays", "0,1", "--models", "rnn,random", *TRAIN, "--ensemble_delays", "true",
                           "--ensemble_gate", "rnn", "--ensemble_gate_seeds", "2", "--ensemble_gate_margin", "0",
                           "--profile_trace_dir", str(traces)))
    assert ensembled == [("rnn", (0, 1))]
    assert retrains[0] == ("rnn", 0, False) and out["gates"][0]["gate"] == "ensemble"
    assert not out["gates"][0]["ok"] and out["gates"][1]["delay"] == 1
    cells = {(r["model_name"], r["delay"]) for r in read(tmp_path) if not r["errored"]}
    assert cells == {("rnn", 0), ("rnn", 1), ("random", 0), ("random", 1)}
    for cell in ("oderl-pendulum_rnn_d0", "oderl-pendulum_random_d1"):
        found = list((traces / cell).glob("*.pt.trace.json"))
        assert len(found) == 1 and "traceEvents" in json.loads(found[0].read_text())


def test_driver_ensemble_excludes_flagship_by_default(tmp_path, monkeypatch):
    """--ensemble_exclude defaults to nl: under --ensemble_delays the
    flagship trains per delay and never reaches the ensemble trainer."""
    individual = []
    real_train = driver.train_model

    def spy_train(model_name, env_name, config, **kw):
        individual.append((model_name, kw.get("delay")))
        return real_train(model_name, env_name, config, **kw)

    def no_ensemble(*a, **kw):
        raise AssertionError("the flagship must not reach the ensemble trainer")

    monkeypatch.setattr(driver, "train_model", spy_train)
    monkeypatch.setattr(driver, "train_model_ensemble", no_ensemble)
    driver.main(argv(tmp_path, "--delays", "0,1", "--models", "nl", *TRAIN, "--train_gate", "none",
                     "--ensemble_delays", "true"))
    assert {("nl", 0), ("nl", 1)} <= set(individual)
    assert all(not r["errored"] for r in read(tmp_path))


TABLE_CELLS = [(e, d) for e in ("oderl-pendulum", "oderl-cartpole", "oderl-acrobot") for d in range(4)]


def test_chip_smoke_nl_reference_is_pinned_to_the_loaded_checkpoint(tmp_path, monkeypatch):
    """chip_smoke.py holds the table's NL cells to the JAX package's run
    recorded in artifacts/port/jax_eval_table.json: for each of the 12 cells
    that run's checkpoint is the tracked file the table loads (path and
    sha256) and its encode_obs_time is the table's (on only at pendulum d0,
    whose checkpoint takes the age channel); a reference made on other
    weights, or under the other flag, is refused rather than compared."""
    import chip_smoke

    for env, delay in TABLE_CELLS:
        age = (env, delay) == chip_smoke.AGE_CHANNEL_CELL
        assert chip_smoke.nl_config(env, delay).encode_obs_time == age
        assert chip_smoke.jax_cell_returns(env, delay, "nl", encode_obs_time=age).shape == (20,)
        with pytest.raises(RuntimeError, match="under encode_obs_time"):
            chip_smoke.jax_cell_returns(env, delay, "nl", encode_obs_time=not age)
    ref = json.loads(chip_smoke.JAX_TABLE_REFERENCE.read_text())
    ref["cells"]["oderl-pendulum/1/nl"]["checkpoint"]["sha256"] = "0" * 64
    ref["cells"]["oderl-acrobot/3/nl"]["config"]["encode_obs_time"] = True
    moved = tmp_path / "ref.json"
    moved.write_text(json.dumps(ref))
    monkeypatch.setattr(chip_smoke, "JAX_TABLE_REFERENCE", moved)
    with pytest.raises(RuntimeError, match="the grid loads"):
        chip_smoke.jax_cell_returns("oderl-pendulum", 1, "nl")
    with pytest.raises(RuntimeError, match="under encode_obs_time=True"):
        chip_smoke.jax_cell_returns("oderl-acrobot", 3, "nl")
    assert chip_smoke.jax_cell_returns("oderl-acrobot", 1, "nl").shape == (20,)


def test_jax_eval_table_reproduces_the_d1_references():
    """The table's JAX reference re-ran the three d1 cells at HEAD: their
    returns equal the earlier d1 artifacts' bit for bit, each cell ran on its tracked
    checkpoint under the Config it records, and pendulum d0 is the one cell
    under the age channel."""
    import chip_smoke

    port_dir = chip_smoke.ROOT / "artifacts" / "port"
    ref = json.loads(chip_smoke.JAX_TABLE_REFERENCE.read_text())
    assert sorted(ref["cells"]) == sorted(f"{e}/{d}/nl" for e, d in TABLE_CELLS)
    for key, cell in ref["cells"].items():
        env, delay, _ = key.split("/")
        assert len(cell["total_rewards"]) == 20 and cell["delay"] == int(delay)
        assert cell["config"] == {"saved_models_path": "artifacts/checkpoints/",
                                  "encode_obs_time": (env, int(delay)) == chip_smoke.AGE_CHANNEL_CELL}
        assert cell["checkpoint"]["path"].startswith("artifacts/checkpoints/nl_" + env)
    driver_d1 = json.loads((port_dir / "jax_eval_driver_d1.json").read_text())
    for env in ("oderl-pendulum", "oderl-acrobot"):
        old = driver_d1["cells"][f"{env}/nl"]
        assert ref["cells"][f"{env}/1/nl"]["total_rewards"] == old["total_rewards"]
        assert ref["cells"][f"{env}/1/nl"]["checkpoint"] == old["checkpoint"]
    cartpole_d1 = json.loads((port_dir / "jax_eval_cartpole_d1.json").read_text())["policies"]["nl"]
    assert ref["cells"]["oderl-cartpole/1/nl"]["total_rewards"] == cartpole_d1["total_rewards"]


def table_records(chip_smoke, shift=None):
    """The table's 36 records made of the JAX package's returns, as the
    driver writes them; ``shift`` = ((env, delay, model), amount) moves one
    cell's returns."""
    recorded = {(r["env_name"], r["delay"], r["model_name"]): r["total_rewards"]
                for r in map(json.loads, chip_smoke.JAX_RESULTS.read_text().splitlines())}
    recs = []
    for env, delay in TABLE_CELLS:
        for model in chip_smoke.TABLE_MODELS:
            age = model == "nl" and (env, delay) == chip_smoke.AGE_CHANNEL_CELL
            got = np.asarray(recorded[(env, delay, model)] if model == "random"
                             else chip_smoke.jax_cell_returns(env, delay, model, encode_obs_time=age), dtype=np.float64)
            if shift and shift[0] == (env, delay, model):
                got = got + shift[1]
            recs.append({"env_name": env, "delay": delay, "model_name": model, "total_rewards": got.tolist(),
                         "total_reward": float(got.mean()), "episode_elapsed_time": 4.0, "errored": False})
    return recs


def test_chip_smoke_table_gate_refuses_a_shifted_nl_cell():
    """Phase table's holds: the JAX package's own returns pass every cell;
    one NL cell's returns moved by twice its 3-sigma limit, an errored or a
    missing record, and an NL cell's forward launches off 8,040 at 20,000
    rows each fail, naming the cell."""
    import chip_smoke

    steps = (chip_smoke.EVAL_STEPS + 1) * chip_smoke.T
    launches = {c: (steps, steps * chip_smoke.SEED_ROWS) for c in TABLE_CELLS}
    cells, failures = chip_smoke.table_cells(table_records(chip_smoke), launches)
    assert failures == [] and len(cells) == 36
    assert all(c["gap_to_jax"] == 0.0 for k, c in cells.items() if not k.endswith("random"))
    limit = cells["oderl-cartpole/2/nl"]["limit"]
    _, failures = chip_smoke.table_cells(
        table_records(chip_smoke, (("oderl-cartpole", 2, "nl"), 2.0 * limit)), launches)
    assert len(failures) == 1 and failures[0].startswith("oderl-cartpole d2 nl: mean")
    recs = table_records(chip_smoke)
    recs[0] = {**{k: recs[0][k] for k in ("env_name", "delay", "model_name")}, "errored": True}
    _, failures = chip_smoke.table_cells(recs[:-1], launches)
    assert len(failures) == 1 and "1 errored" in failures[0] and "acrobot', 3, 'random" in failures[0]
    _, failures = chip_smoke.table_cells(table_records(chip_smoke),
                                         {**launches, ("oderl-pendulum", 0): (steps, steps * 1000)})
    assert failures == [f"oderl-pendulum d0 nl: the forward kernel launched {steps} times over {steps * 1000} rows, "
                        f"expected {steps} at {chip_smoke.SEED_ROWS}"]


def test_chip_smoke_table_calls_cover_the_grid_once():
    """The table's driver calls run each of the 36 cells once, and only the
    age-channel checkpoint's NL cell under --encode_obs_time true."""
    import chip_smoke

    cells = [(e, d, m, extra) for envs, delays, models, extra in chip_smoke.table_calls()
             for e in envs for d in delays for m in models]
    assert sorted(c[:3] for c in cells) == sorted((e, d, m) for e, d in TABLE_CELLS
                                                  for m in chip_smoke.TABLE_MODELS)
    assert [c[:3] for c in cells if c[3]] == [("oderl-pendulum", 0, "nl")]
    assert all(c[3] == ("--encode_obs_time", "true") for c in cells if c[3])


def families_table_script():
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import port_families_table

    return port_families_table


def hold(script, recs, expected):
    """The script's holds of a file's records: chip_smoke.hold_records over its grid."""
    import chip_smoke

    return chip_smoke.hold_records(recs, expected, script.GRID, script.HELD)


def families_records(script, shift=None):
    """The families table's records (every cell of the script's grid) made
    of the JAX package's returns; ``shift`` = ((env, delay, model), amount)
    moves one cell's returns."""
    import chip_smoke

    recorded = {(r["env_name"], r["delay"], r["model_name"]): r["total_rewards"]
                for r in map(json.loads, chip_smoke.JAX_RESULTS.read_text().splitlines())}
    recs = []
    for env, delay, model in script.GRID:
        age = model == "nl" and (env, delay) == chip_smoke.AGE_CHANNEL_CELL
        got = np.asarray(recorded[(env, delay, model)] if model == "random"
                         else chip_smoke.jax_cell_returns(env, delay, model, encode_obs_time=age), dtype=np.float64)
        if shift and shift[0] == (env, delay, model):
            got = got + shift[1]
        recs.append({"env_name": env, "delay": delay, "model_name": model, "total_rewards": got.tolist(),
                     "total_reward": float(got.mean()), "episode_elapsed_time": 10.0, "errored": False})
    return recs


def test_families_table_gate_refuses_a_shifted_family_cell(tmp_path, monkeypatch):
    """scripts/port_families_table.py's holds: the JAX package's own returns
    pass every cell; one family cell's returns moved by twice its 3-sigma
    limit, an errored record, a missing record, a cell recorded twice, a cell
    of 19 returns and a cell whose JAX record is gone each fail, naming the
    cell."""
    import chip_smoke

    script = families_table_script()
    cells, failures = hold(script, families_records(script), script.GRID)
    assert failures == [] and len(cells) == 74
    assert all(c["gap_to_jax"] == 0.0 for k, c in cells.items() if not k.endswith("random"))
    limit = cells["oderl-acrobot/2/latent_ode"]["limit"]
    shifted = families_records(script, (("oderl-acrobot", 2, "latent_ode"), 2.0 * limit))
    _, failures = hold(script, shifted, script.GRID)
    assert len(failures) == 1 and failures[0].startswith("oderl-acrobot d2 latent_ode: mean")
    recs = families_records(script)
    first = tuple(recs[0][k] for k in ("env_name", "delay", "model_name"))
    recs[0] = {**dict(zip(("env_name", "delay", "model_name"), first)), "errored": True}
    outside = {**recs[1], "env_name": "oderl-cartpole", "delay": 5, "model_name": "random"}
    _, failures = hold(script, recs[:-1] + recs[:1] + [outside], script.GRID)
    assert failures == [f"75 records, 1 errored [{first}], missing [('oderl-pendulum', 3, 'random')], extra "
                        f"[('oderl-cartpole', 5, 'random')], recorded twice [{first}]"]
    recs = families_records(script)
    short = next(i for i, r in enumerate(recs) if (r["env_name"], r["delay"], r["model_name"]) ==
                 ("oderl-cartpole", 1, "node"))
    recs[short]["total_rewards"] = recs[short]["total_rewards"][:19]
    assert hold(script, recs, script.GRID)[1] == ["oderl-cartpole d1 node: 19 returns, expected 20"]
    recs = families_records(script)
    empty = tmp_path / "rnn.jsonl"
    empty.write_text("")
    monkeypatch.setattr(chip_smoke, "JAX_RNN_RESULTS", empty)
    assert hold(script, recs, script.GRID)[1] == [
        f"oderl-pendulum d{d} rnn: {empty} has no record of oderl-pendulum d{d} rnn" for d in (0, 1)]


def test_families_table_calls_cover_the_tracked_checkpoints_once():
    """The script's driver calls run each cell of its grid once: the 38
    tracked family checkpoints (each with a JAX record), the oracle and
    random on the 12 cells, and nl as phase table runs it (through the
    forward kernel, only pendulum d0 under --encode_obs_time true)."""
    import chip_smoke

    script = families_table_script()
    tracked = sorted((f, e, d) for f, e, d in (
        (m[1], m[2], int(m[3])) for m in map(re.compile(
            r"^(rnn|delta_t_rnn|node|latent_ode)_(oderl-\w+)_delay-(\d)_ts-grid-exp_0_train-with-expert-trajectories-"
            r"True\.npz$").match, os.listdir(chip_smoke.ROOT / "artifacts" / "checkpoints")) if m))
    assert len(tracked) == 38 and sorted(chip_smoke.family_table_cells()) == tracked
    calls = script.driver_calls(script.MODELS, chip_smoke.ENVS, chip_smoke.TABLE_DELAYS)
    cells = [(e, d, m, extra) for envs, delays, models, extra in calls for e in envs for d in delays for m in models]
    assert sorted(c[:3] for c in cells) == script.GRID and len(cells) == len(set(c[:3] for c in cells)) == 74
    assert sorted((m, e, d) for e, d, m, _ in cells if m not in ("nl", "oracle", "random")) == tracked
    for family, env, delay in tracked:
        assert chip_smoke.jax_cell_returns(env, delay, family).shape == (20,)
    assert [c[:3] for c in cells if "--encode_obs_time" in c[3]] == [("oderl-pendulum", 0, "nl")]
    assert all(("--fused_nl_planner", "true") == c[3][:2] for c in cells if c[2] == "nl")
    assert all(c[3] == () for c in cells if c[2] != "nl")
    assert script.driver_calls(["latent_ode", "rnn"], ["oderl-cartpole"], [2, 3]) == [
        (("oderl-cartpole",), (2, 3), ("latent_ode",), ())]


def test_families_table_h100_holds_every_cell():
    """The committed run of the script on the card holds the whole grid: the
    38 family cells, the oracle, random and NL on the 12 cells, once each,
    none errored, 20 returns each, every held cell within 3 sigma of its JAX
    record; each line names the card and its power limit."""
    script = families_table_script()
    recs = script.read_records(script.RESULTS)
    cells, failures = hold(script, recs, script.GRID)
    assert failures == [] and len(recs) == len(cells) == len(script.GRID) == 74
    assert sum(r["model_name"] in ("oracle", "random") for r in recs) == 24
    assert all(re.fullmatch(r"NVIDIA H100 .*, \d+\.\d\d W", r["card"]) for r in recs)


def test_families_table_runs_only_on_a_card(tmp_path, monkeypatch):
    """The script runs its grid on a CUDA device only: without one it stops
    before any driver call and writes no record."""
    script = families_table_script()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="runs on a CUDA device"):
        script.main(["--models", "rnn", "--results", str(tmp_path / "t.jsonl")])
    assert not (tmp_path / "t.jsonl").exists()


@pytest.mark.parametrize("field,value", [("roll_outs", 500), ("time_steps", 20), ("seeds", list(range(5))),
                                         ("delay", 2)])
def test_chip_smoke_refuses_a_jax_record_of_another_protocol(field, value, tmp_path, monkeypatch):
    """jax_cell_returns reads rnn's records from its own runs' file and
    refuses a record made under other rollouts, horizon or seeds than the
    run's, whichever file it comes from; NL's run at HEAD also under another
    delay than its key's (a JSONL record is found by its delay)."""
    import chip_smoke

    assert chip_smoke.jax_cell_returns("oderl-pendulum", 0, "rnn").shape == (20,)
    for path_name, model in (("JAX_RNN_RESULTS", "rnn"), ("JAX_RESULTS", "node")):
        if field == "delay":
            continue
        recs = [json.loads(line) for line in getattr(chip_smoke, path_name).read_text().splitlines()]
        for r in recs:
            if (r["env_name"], r["delay"], r["model_name"]) == ("oderl-pendulum", 1, model):
                r[field] = value
        moved = tmp_path / f"{model}.jsonl"
        moved.write_text("\n".join(json.dumps(r) for r in recs))
        monkeypatch.setattr(chip_smoke, path_name, moved)
        with pytest.raises(RuntimeError, match=f"ran oderl-pendulum d1 {model} under {field}="):
            chip_smoke.jax_cell_returns("oderl-pendulum", 1, model)
        assert chip_smoke.jax_cell_returns("oderl-pendulum", 0, model).shape == (20,)
    ref = json.loads(chip_smoke.JAX_TABLE_REFERENCE.read_text())
    if field == "seeds":
        ref["seeds"] = value
    else:
        ref["cells"]["oderl-cartpole/1/nl"][field] = value
    moved = tmp_path / "table.json"
    moved.write_text(json.dumps(ref))
    monkeypatch.setattr(chip_smoke, "JAX_TABLE_REFERENCE", moved)
    with pytest.raises(RuntimeError, match=f"ran oderl-cartpole d1 NL under {field}="):
        chip_smoke.jax_cell_returns("oderl-cartpole", 1, "nl")

"""The port's bench scripts (scripts/bench_*_torch.py) run end to end on the
CPU at tiny sizes, with ``--device cpu``: their harnesses, JSON keys and
finite numbers. They assert no throughput (the CPU says nothing of the
card's); bench_train_torch keeps the function names that
tests/test_bench_scripts.py imports from the JAX script."""

import json
import math
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

torch.set_num_threads(1)

CARD = {"device": "cpu", "power_limit_w": None}


def finite(rec):
    return all(math.isfinite(v) for v in rec.values() if isinstance(v, float))


def test_bench_episode_batch_torch():
    from scripts import bench_episode_batch_torch as b

    rows = b.main(["--counts", "1,2", "--k", "8", "--t", "3", "--dt", "2.5", "--device", "cpu"])
    assert [r["episodes"] for r in rows] == [1, 2]
    for r in rows:
        assert {"mppi_rollouts_per_sec", "episode_elapsed_time"} <= set(r) and r["mppi_rollouts_per_sec"] > 0
        assert {k: r[k] for k in CARD} == CARD and finite(r)


def test_bench_scaling_torch():
    from scripts import bench_scaling_torch as b

    rows = b.main(["--ks", "8,16", "--t", "3", "--reps", "1", "--device", "cpu"])
    assert [(r["route"], r["K"]) for r in rows] == [("kernel", 8), ("kernel", 16), ("plain", 8), ("plain", 16)]
    for r in rows:
        assert r["rollouts_per_s"] > 0 and math.isclose(r["model_forwards_per_s"], r["rollouts_per_s"] * 3)
        assert finite(r)


def test_bench_train_torch_measures_both_families():
    from neurallaplacecontrol_tpu_torch.config import Config
    from scripts.bench_train_torch import bench_latent_ode, bench_nl, main

    cfg = Config(training_batch_size=4, iters_per_log=3, nl_hidden_units=16, latent_ode_hidden_units=16)
    for fn in (bench_nl, bench_latent_ode):
        steps_per_sec, seg_len = fn(cfg, rows=60, batch_size=4, segments=1, device="cpu")
        assert seg_len == 3 and math.isfinite(steps_per_sec) and steps_per_sec > 0
    rows = main(["--models", "nl", "--batches", "4", "--rows", "40", "--segments", "1", "--iters_per_log", "2",
                 "--device", "cpu"])
    assert set(rows[0]) >= {"model", "batch_size", "steps_per_sec", "sec_per_iter", "samples_per_sec",
                            "table_rows", "seg_len", "segments_timed", "device", "power_limit_w"}


def test_bench_pallas_torch_writes_its_records(tmp_path):
    from scripts import bench_pallas_torch as b

    out = b.main(["--device", "cpu", "--out", str(tmp_path / "k.json"), "--head_sizes", "8", "--forward_sizes", "8",
                  "--ks", "8", "--reps", "1"])
    assert [r["level"] for r in out["results"]] == ["head", "forward", "planner"]
    assert json.loads((tmp_path / "k.json").read_text()) == out
    head, fwd, plan = out["results"]
    # on the CPU the kernels' wrappers compute their plain versions: the head
    # the same function, the forward its folded float32 form (the kernels'
    # tolerance against the model's apply, chip_smoke's KERNEL_TOL)
    assert head["maxdiff"] == 0.0 and fwd["max_rel_diff"] < 1e-3 and plan["action_diff"] < 1e-2


def test_bench_mxu_sweep_torch_measure_one():
    from scripts.bench_mxu_sweep_torch import main, measure_one

    for route in ("plain", "kernel"):
        row = measure_one("oderl-cartpole", hidden=32, dtype="float32", batch=16, chain=3, reps=1, route=route,
                          device="cpu")
        assert row["hidden"] == 32 and row["params"] > 0 and row["flops_per_forward"] > 0 and row["finite"]
        assert row["per_forward_us"] > 0 and row["forwards_per_sec"] > 0 and row["mfu_vs_dtype_peak"] >= 0
    rows = main(["--widths", "16,256", "--dtypes", "float32,bfloat16", "--batch", "8", "--chain", "2", "--reps",
                 "1", "--device", "cpu"])
    assert [(r["hidden"], r["dtype"], r["route"]) for r in rows] == [
        (16, "float32", "plain"), (16, "float32", "kernel"), (16, "bfloat16", "plain"), (256, "float32", "plain"),
        (256, "bfloat16", "plain")]
    assert all(r["mfu_vs_bf16_peak"] <= r["mfu_vs_dtype_peak"] for r in rows)

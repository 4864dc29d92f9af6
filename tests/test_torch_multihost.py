"""The port's multi-process orchestration (parallel.multihost): the grid's
split by process against the JAX package's, the out-of-band barrier between
threads, and a real two-process gloo run of the port's driver that splits a
grid, meets at the barrier and merges the shards."""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.parallel import multihost as jmultihost
from neurallaplacecontrol_tpu_torch.config import Config
from neurallaplacecontrol_tpu_torch.parallel import multihost
from neurallaplacecontrol_tpu_torch.training import evaluate_policy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_items,count", [(0, 2), (7, 1), (11, 3), (12, 4), (3, 5)])
def test_process_slice_matches_jax(n_items, count):
    items = [("oderl-pendulum", d, m) for d in range(n_items) for m in ("nl",)]
    shares = [multihost.process_slice(items, p, count) for p in range(count)]
    assert shares == [jmultihost.process_slice(items, p, count) for p in range(count)]
    assert sorted(x for s in shares for x in s) == sorted(items)


def test_single_process_passes_through():
    """Outside a process group: process 0 of 1, the whole list, a barrier
    that returns at once, and an initialize without arguments that does
    nothing."""
    multihost.initialize()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.process_slice([1, 2, 3]) == [1, 2, 3]
    multihost.barrier("alone", timeout_s=0.1)


def run_hosts(monkeypatch, n, behaviours, timeout_s=10.0):
    """``behaviours``: process index -> fn(multihost, addr, timeout) run in a
    thread of its own, with process_count patched to ``n`` and
    process_index to the thread's index. Returns {index: exception}."""
    port = free_port()
    addr = f"127.0.0.1:{port - 1}"  # the barrier listens on port + 1
    index = {}
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(multihost, "process_index", lambda: index[threading.get_ident()])
    errs = {}

    def host(pid, fn):
        index[threading.get_ident()] = pid
        try:
            fn(multihost, addr, timeout_s)
        except Exception as e:  # noqa: BLE001 -- collected for the asserts
            errs[pid] = e

    threads = [threading.Thread(target=host, args=item) for item in behaviours.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "barrier thread hung"
    return errs


def test_barrier_releases_all(monkeypatch):
    done = []

    def arrive(m, a, t):
        m.barrier("b1", timeout_s=t, coordinator_address=a)
        done.append(1)

    assert not run_hosts(monkeypatch, 3, {0: arrive, 1: arrive, 2: arrive}) and len(done) == 3


def test_barrier_name_mismatch_fails_loudly(monkeypatch):
    errs = run_hosts(monkeypatch, 2, {
        0: lambda m, a, t: m.barrier("left", timeout_s=t, coordinator_address=a),
        1: lambda m, a, t: m.barrier("right", timeout_s=t, coordinator_address=a),
    })
    assert isinstance(errs[0], RuntimeError) and "mismatch" in str(errs[0])
    assert isinstance(errs[1], TimeoutError)  # process 0 closed without an ack


def test_barrier_missing_peer_times_out(monkeypatch):
    errs = run_hosts(monkeypatch, 3, {
        0: lambda m, a, t: m.barrier("b", timeout_s=2.0, coordinator_address=a),
        1: lambda m, a, t: m.barrier("b", timeout_s=2.0, coordinator_address=a),
    }, timeout_s=2.0)  # process 2 never arrives
    assert isinstance(errs[0], TimeoutError) and "1/2 peers" in str(errs[0])
    assert isinstance(errs[1], TimeoutError)


def test_barrier_needs_an_address(monkeypatch):
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    monkeypatch.setattr(multihost, "_coordinator_address", None)
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.barrier("b", timeout_s=0.1)


def test_two_process_gloo_driver_grid(tmp_path):
    """Two processes of run_exp_multi_torch.py --multihost on the CPU (gloo):
    they split a 4-cell oracle/random grid round-robin, meet at the barrier,
    and process 0 merges the shards into --results and removes them. Each
    merged record equals an in-process evaluate_policy of its cell."""
    port = free_port()
    results = tmp_path / "results.jsonl"
    base = [sys.executable, str(REPO / "run_exp_multi_torch.py"), "--multihost", f"127.0.0.1:{port},2",
            "--device", "cpu", "--envs", "oderl-pendulum", "--delays", "0,1", "--models", "oracle,random",
            "--results", str(results), "--seed_runs", "3", "--dt", "0.5", "--mppi_roll_outs", "8",
            "--mppi_time_steps", "3", "--log_folder", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(base + ["--process_id", str(pid)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert "process 1/2 owns 2/4 grid cells" in outs[1] and "merged 4 records from 2 shards" in outs[0]
    assert not any(tmp_path.glob("results.jsonl.p*"))
    recs = [json.loads(line) for line in results.read_text().splitlines()]
    assert sorted((r["model_name"], r["delay"]) for r in recs) == [
        ("oracle", 0), ("oracle", 1), ("random", 0), ("random", 1)]
    cfg = Config(dt=0.5, mppi_roll_outs=8, mppi_time_steps=3)
    for r in recs:
        assert not r["errored"]
        ref = evaluate_policy(r["model_name"], r["env_name"], r["delay"], range(3), cfg, device="cpu")
        np.testing.assert_allclose(r["total_rewards"], ref["total_rewards"], rtol=1e-6,
                                   err_msg=f"{r['model_name']} d={r['delay']}")


def test_two_rank_host_trains_the_ensemble(tmp_path):
    """Two ranks of torchrun's environment run the driver with
    ``--ensemble_delays true --delays 0,1 --shard seeds`` on the CPU (gloo):
    rank 0 trains the rnn delay ensemble, broadcasts each delay's members to
    rank 1, and the two ranks evaluate every cell's seeds in halves. The
    records equal a one-process run's (``--shard none``) of the same flags."""
    sys.path.insert(0, str(REPO))
    import run_exp_multi_torch as driver

    def argv(run, shard):
        return ["--device", "cpu", "--envs", "oderl-pendulum", "--delays", "0,1", "--models", "rnn,random",
                "--ensemble_delays", "true", "--ensemble_gate", "none", "--shard", shard, "--retrain", "true",
                "--force_retrain", "true", "--train_seconds", "1000", "--training_epochs", "1",
                "--train_with_expert_trajectories", "false", "--train_samples_per_dim", "2", "--iters_per_log", "20",
                "--rnn_hidden_units", "8", "--seed_runs", "4", "--dt", "0.5", "--mppi_roll_outs", "8",
                "--mppi_time_steps", "3", "--results", str(tmp_path / run / "results.jsonl"),
                "--saved_models_path", str(tmp_path / run) + "/", "--log_folder", str(tmp_path / run)]

    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); import run_exp_multi_torch as d; "
            "torch.set_num_threads(1); d.main(sys.argv[2:])")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(REPO)] + argv("ranks", "seeds"),
                              env=dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
                              cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ref = driver.main(argv("one", "none"))["records"]
    written = [json.loads(x) for x in (tmp_path / "ranks" / "results.jsonl").read_text().splitlines()]
    assert "(ensemble" in outs[0] and "[trained" not in outs[1]
    assert [(r["model_name"], r["delay"]) for r in written] == [(r["model_name"], r["delay"]) for r in ref]
    assert {(r["model_name"], r["delay"]) for r in written} == {(m, d) for m in ("rnn", "random") for d in (0, 1)}
    for got, want in zip(written, ref):
        assert not got["errored"] and got["shard"] == "seeds" and got["shard_group_size"] == 2
        np.testing.assert_array_equal(got["total_rewards"], want["total_rewards"],
                                   err_msg=f"{got['model_name']} d={got['delay']}")

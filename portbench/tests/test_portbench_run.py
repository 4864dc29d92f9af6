"""A whole run on the CPU at a tiny size (the look for a card skipped): the
result line's keys, the checks, and the look for JAX in ``sys.modules``."""

import io
import json
import sys
from pathlib import Path

import pytest
import torch

from portbench import cell as cells
from portbench import harness

torch.set_num_threads(1)
TINY = {
    "nl128-eval-s20": {"seeds": 3, "rollouts": 16, "horizon": 6, "episode_ticks": 8, "warmup_ticks": 1,
                       "check": {"seeds": 2, "all_seed_ticks": 2}},
    "nl512-eval-s10": {"seeds": 2, "rollouts": 8, "horizon": 4, "episode_ticks": 5, "warmup_ticks": 1,
                       "check": {"seeds": 1, "all_seed_ticks": 2}},
    "nl128-serve-k32768": {"rollouts": 16, "horizon": 6, "episode_ticks": 8, "warmup_ticks": 1},
}


def run_cpu(cell, seed=3_000_000_001, seconds=0.2, capsys=None):
    out = io.StringIO()
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"],
                      device="cpu", require_cuda=False, traffic_overrides=TINY[cell], out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", sorted(TINY))
def test_result_line(cell, capsys):
    result = run_cpu(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    bench = cells.benchmark()
    want = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == want and "setup_s" in want
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    limits = cells.load(cell).limits
    assert set(result["checks"]) == set(limits)
    for name, check in result["checks"].items():
        assert check["value"] <= check["limit"] == limits[name]
    err = capsys.readouterr().err.strip().splitlines()
    assert [line.split()[1] for line in err[-len(limits):]] == sorted(limits)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = io.StringIO()
    rc = harness.main(["--workload", "nl128-eval-s20", "--seed", "1", "--seconds", "1"], out=out)
    assert rc != 0 and out.getvalue() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    for name in ("neurallaplacecontrol_tpu_torch", "jaxtyping", "flaxen", "jax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "neurallaplacecontrol_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "neurallaplacecontrol_tpu"]


def test_run_refuses_a_loaded_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys)
    out = io.StringIO()
    rc = harness.main(["--workload", "nl128-serve-k32768", "--seed", "4", "--seconds", "0.1"], device="cpu",
                      require_cuda=False, traffic_overrides=TINY["nl128-serve-k32768"], out=out)
    assert rc != 0 and out.getvalue() == ""


def test_run_refuses_jax_loaded_by_a_reader(monkeypatch, capsys):
    """A metric's reader runs after the window: a module it loads is looked for too."""
    def load_jax(kind, name):
        def read(run):
            monkeypatch.setitem(sys.modules, "jax.numpy", sys)
            return 1.0
        return read

    monkeypatch.setattr(harness, "reader", load_jax)
    out = io.StringIO()
    rc = harness.main(["--workload", "nl128-serve-k32768", "--seed", "4", "--seconds", "0.1"], device="cpu",
                      require_cuda=False, traffic_overrides=TINY["nl128-serve-k32768"], out=out)
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in capsys.readouterr().err.strip().splitlines()[-1]


def test_reader_falls_back_to_the_name_without_its_suffix():
    assert harness.reader("metrics", "mfu.wide").__module__ == harness.reader("metrics", "mfu").__module__
    assert harness.reader("e2e", "rollouts_per_s.wide").__doc__ == harness.reader("e2e", "rollouts_per_s").__doc__


def test_sources_import_no_jax():
    import ast

    for path in sorted(Path(cells.BENCH_DIR).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ()
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("cell", ["nl128-eval-s20", "nl128-serve-k32768"])
def test_traced_run_covers_its_ticks(cell, capsys):
    """A ``--trace 1`` run on the CPU, which traces nothing (no CUDA device):
    the result line has its shape, and only the host's metric reads."""
    out = io.StringIO()
    over = dict(TINY[cell], episode_ticks=20, trace={"start_tick": 4, "ticks": 6})
    rc = harness.main(["--workload", cell, "--seed", "5", "--seconds", "0.01", "--trace", "1"], device="cpu",
                      require_cuda=False, traffic_overrides=over, out=out)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks" and "breakdown" in result
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] == result["device"]["busy_s"] == 0
    name = "host_issue_ms." + ("serve" if "serve" in cell else "eval")
    assert set(result["metrics"]) == {name} and result["metrics"][name]["value"] > 0

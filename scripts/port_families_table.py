"""The paper's baseline table on the card: every tracked family checkpoint
through the grid driver, each cell held to the JAX package.

    python3 scripts/port_families_table.py [--models delta_t_rnn,node] [--envs oderl-acrobot] \\
        [--delays 0,1] [--results artifacts/port/families_table_h100.jsonl]

Runs ``run_exp_multi_torch.main`` on the card with ``--saved_models_path
artifacts/checkpoints/ --seed_runs 20`` at the paper's protocol (K=1,000,
T=40, 200 steps of dt 0.05, f32) over the part of ``GRID`` that
``--models/--envs/--delays`` pick: the oracle and random on all 12 (env,
delay) cells, for the normalization; nl on all 12 as phase ``table`` of
``chip_smoke.py`` runs it (the forward kernel, pendulum d0 under
``--encode_obs_time true``); delta_t_rnn, node and the latent ODE (planning
with carried history) on all 12; rnn on pendulum d0 and d1, its only tracked
checkpoints. The driver runs the product of its lists, so the part runs as
the calls of ``driver_calls``. Each record is appended to ``--results`` as the
driver wrote it, with the card's name and power limit (``card``) and this
command (``call``), so a grid too long for one session is run in parts into
one file.

Then every cell of the file is held as ``chip_smoke.hold_records`` holds
phase ``table``'s: each family, nl and oracle cell by the 3-sigma rule of
``chip_smoke.three_sigma`` to the JAX package's returns
(``chip_smoke.jax_cell_returns``: the recorded runs, nl's run at HEAD); a
cell of the part missing from the file, a cell recorded twice, an errored
record, a cell with other than 20 returns or without a JAX record fails the
run. One ``families <env>/<delay>/<model>
{...}`` line per cell gives its mean, std, normalized score against the
file's own oracle and random, batch seconds and ticks/s, and
``results.summarize`` over the file prints the table of every model in it.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import tempfile
import time
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from neurallaplacecontrol_tpu_torch.results import latex_table, summarize  # noqa: E402

RESULTS = ROOT / "artifacts" / "port" / "families_table_h100.jsonl"
MODELS = ("oracle", "random", "nl", "rnn", "delta_t_rnn", "node", "latent_ode")  # the order a part runs in
HELD = ("oracle", "nl", "rnn", "delta_t_rnn", "node", "latent_ode")  # random has no hold, as in phase table
GRID = sorted({(e, d, m) for e in chip_smoke.ENVS for d in chip_smoke.TABLE_DELAYS
               for m in ("oracle", "random", "nl")}
              | {(e, d, f) for f, e, d in chip_smoke.family_table_cells()})


def driver_calls(models, envs, delays) -> list:
    """The driver calls that run the cells of ``GRID`` in models x envs x
    delays, each once, as (envs, delays, models, extra flags): one call per
    model over the envs and delays it has, the oracle and random together;
    nl as ``chip_smoke.table_calls`` splits it, with the forward kernel."""
    calls = []
    for group in (("oracle", "random"),) + tuple((m,) for m in MODELS[2:]):
        group = tuple(m for m in group if m in models)
        if not group:
            continue
        if group == ("nl",):
            for c_envs, c_delays, _, extra in chip_smoke.table_calls()[1:]:
                c_envs = tuple(e for e in c_envs if e in envs)
                c_delays = tuple(d for d in c_delays if d in delays)
                if c_envs and c_delays:
                    calls.append((c_envs, c_delays, group, ("--fused_nl_planner", "true", *extra)))
            continue
        c_envs = tuple(e for e in envs if any((e, d, group[0]) in GRID for d in delays))
        c_delays = tuple(d for d in delays if any((e, d, group[0]) in GRID for e in envs))
        if c_envs and c_delays:
            calls.append((c_envs, c_delays, group, ()))
    return calls


def read_records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()] if path.exists() else []


def report(path: Path, expected) -> list:
    """Hold and print every cell of the file, then ``summarize``'s table of
    it; returns the failures."""
    recs = read_records(path)
    cells, failures = chip_smoke.hold_records(recs, expected, GRID, HELD)
    for key, cell in cells.items():
        print(f"families {key} " + json.dumps(cell), flush=True)
    stdout = io.StringIO()
    with redirect_stdout(stdout):
        summarize.main([str(path)])
    print(stdout.getvalue(), end="", flush=True)
    if not stdout.getvalue().rstrip().endswith(latex_table([r for r in recs if not r.get("errored")])):
        failures.append("summarize over the file does not print the latex_table of its records")
    return failures


def run(calls, results: Path, argv) -> dict:
    """The driver calls on the card, each call's records appended to
    ``results`` with the card and the command; seconds per call."""
    import torch

    import run_exp_multi_torch as driver

    if not torch.cuda.is_available():
        raise SystemExit("port_families_table.py runs on a CUDA device, and torch sees none")
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    seconds = {}
    results.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        for envs, delays, models, extra in calls:
            t0 = time.perf_counter()
            out = driver.main(["--device", "cuda", "--results", str(Path(tmp) / "results.jsonl"),
                               "--log_folder", str(Path(tmp) / "logs"), "--envs", ",".join(envs),
                               "--delays", ",".join(map(str, delays)), "--models", ",".join(models),
                               "--seed_runs", str(len(chip_smoke.EVAL_SEEDS)),
                               "--saved_models_path", str(ROOT / "artifacts" / "checkpoints") + "/", *extra])
            torch.cuda.synchronize()
            with results.open("a") as f:
                for r in out["records"]:
                    f.write(json.dumps({**r, "card": smi, "call": " ".join(argv)}) + "\n")
            part = f"{','.join(models)} x {','.join(envs)} x d{','.join(map(str, delays))}"
            seconds[part] = time.perf_counter() - t0
            print(f"families call {json.dumps({'part': part, 'seconds': seconds[part]})}", flush=True)
    return seconds


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--envs", default=",".join(chip_smoke.ENVS))
    ap.add_argument("--delays", default=",".join(map(str, chip_smoke.TABLE_DELAYS)))
    ap.add_argument("--results", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    models, envs = args.models.split(","), args.envs.split(",")
    delays = [int(d) for d in args.delays.split(",")]
    unknown = sorted(set(models) - set(MODELS)) + sorted(set(envs) - set(chip_smoke.ENVS))
    if unknown:
        ap.error(f"not in the grid: {unknown}")
    calls = driver_calls(models, envs, delays)
    expected = [(e, d, m) for c_envs, c_delays, c_models, _ in calls for e in c_envs for d in c_delays for m in c_models]
    seconds = run(calls, args.results, ["scripts/port_families_table.py", *argv])
    print("families " + json.dumps({"seconds": seconds, "results": str(args.results)}), flush=True)
    failures = report(args.results, expected)
    if failures:
        print("families FAILED: " + "; ".join(failures), flush=True)
        return 1
    print(f"families ok: {len(expected)} cells held", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

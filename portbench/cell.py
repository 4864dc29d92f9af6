"""One cell of ``BENCHMARK.json``: its configuration, its traffic mix and its
limits, each read from the file its name points to."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json: number name -> limit

    @property
    def rollouts(self) -> int:
        return int(self.traffic.get("rollouts", self.config["mppi_roll_outs"]))

    @property
    def horizon(self) -> int:
        return int(self.traffic.get("horizon", self.config["mppi_time_steps"]))

    @property
    def dims(self) -> dict:
        """The forward's dims, as ``flops`` takes them."""
        c = self.config
        return {"n_obs": c["n_obs"], "m_act": c["m"], "width": c["nl_hidden_units"],
                "gru_hidden": c["nl_hidden_units"] // 2, "terms": c["nl_s_recon_terms"],
                "actions": c["action_buffer_size"], "gru_layers": c["gru_layers"]}


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load(name: str, root: Path = ROOT, traffic_overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; ``traffic_overrides``
    replaces keys of its traffic mix (the tests' small sizes)."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    traffic.update(traffic_overrides or {})
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else {}
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits)

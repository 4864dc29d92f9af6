"""Structured logging (port of ``utils/logging.py``; pure stdlib, as there).

The reference's "database" is its log file: result dicts are printed into log
lines and re-parsed with ast.literal_eval (reference
process_results/process_logs.py:145-157). Here results are written as JSONL
records next to a human log, so downstream processing never parses prose.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from pathlib import Path
from typing import Iterable


def setup_logger(name: str, log_folder: str = "logs") -> logging.Logger:
    """The root logger at INFO, writing to the console and to
    ``<log_folder>/<name>-<date>-<time>_log.txt``."""
    Path(log_folder).mkdir(parents=True, exist_ok=True)
    run_name = "{}-{}".format(os.path.basename(name).split(".py")[0], time.strftime("%Y%m%d-%H%M%S"))
    logging.basicConfig(
        format="%(asctime)s,%(msecs)d %(name)s %(levelname)s %(message)s",
        handlers=[
            logging.FileHandler(f"{log_folder}/{run_name}_log.txt"),
            logging.StreamHandler(),
        ],
        datefmt="%H:%M:%S",
        level=logging.INFO,
        # basicConfig does nothing once the root logger has handlers (a second
        # setup_logger call in one process): force replaces them, so the
        # run's file handler always lands
        force=True,
    )
    return logging.getLogger()


class JsonlWriter:
    """Append-only JSONL result sink (one dict per line)."""

    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read_all(self) -> list:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def results_table(records: Iterable[dict], group_keys=("env_name", "model_name", "delay")) -> dict:
    """Episode records aggregated into mean, std (n - 1) and count per group,
    the pandas groupby of reference process_logs.py:166 without pandas;
    normalized scores live in ``results.process``."""
    groups: dict = {}
    for r in records:
        k = tuple(r.get(g) for g in group_keys)
        groups.setdefault(k, []).append(float(r["total_reward"]))
    out = {}
    for k, vals in groups.items():
        n = len(vals)
        mean = sum(vals) / n
        var = sum((v - mean) ** 2 for v in vals) / max(n - 1, 1)
        out[k] = {"mean": mean, "std": math.sqrt(var), "n": n}
    return out

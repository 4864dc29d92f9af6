"""Results processing: normalized-return scores (port of ``results/process.py``).

Headline score (reference process_logs.py:183-190):
    normalized = 100 * (R - R_random) / (R_oracle - R_random), clipped >= 0
aggregated as mean +/- spread over seeds. The functions are the JAX
module's, copied: they work on plain result dicts and numpy, and on the
driver's log files (``parse_log_file``).
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from typing import Iterable, Optional

import numpy as np

# reference normalization constants for delays 0/1 (plot_util.py:1-26);
# used as fallback when a run lacks its own oracle/random baselines
REFERENCE_BASELINES = {
    0: {
        "oderl-acrobot": (-2948.64, -571.11),  # (random, oracle)
        "oderl-cartpole": (-14246.30, -139.69),
        "oderl-pendulum": (-616.77, -121.05),
    },
    1: {
        "oderl-acrobot": (-2910.50, -558.76),
        "oderl-cartpole": (-9713.19, -146.26),
        "oderl-pendulum": (-575.98, -123.44),
    },
}


_LOG_MARKER = "[Model Completed evaluation mppi]"
_SENTINELS = {"__nan__": float("nan"), "__inf__": float("inf"), "__ninf__": float("-inf")}


def parse_log_file(path) -> list:
    """The result dicts of a log's ``[Model Completed evaluation mppi] {...}``
    lines (the reference's log-as-database flow, process_logs.py:145-157),
    from this package's driver, the JAX package's or the reference's.

    ``nan``, ``inf`` and ``-inf`` (a diverged run), which ``literal_eval``
    refuses, are swapped for quoted sentinels and mapped back to floats, so
    such a record is kept. The payload is only ever ``literal_eval``-ed,
    never ``eval``-ed: a log file is untrusted input."""
    records = []
    with open(path) as f:
        for line in f:
            if _LOG_MARKER not in line:
                continue
            payload = line.split(_LOG_MARKER, 1)[1].strip()
            try:
                rec = ast.literal_eval(payload)
            except (ValueError, SyntaxError):
                sub = re.sub(r"\b(nan|inf)\b", r"'__\1__'", payload).replace("-'__inf__'", "'__ninf__'")
                try:
                    rec = ast.literal_eval(sub)
                except (ValueError, SyntaxError):
                    continue
                if isinstance(rec, dict):
                    rec = {k: _SENTINELS.get(v, v) if isinstance(v, str) else v for k, v in rec.items()}
            if isinstance(rec, dict):
                records.append(rec)
    return records


def mean_confidence_interval(data, confidence: float = 0.95):
    """(mean, half-width) Student-t interval
    (process_logs.mean_confidence_interval)."""
    a = np.asarray(data, dtype=float)
    n = a.size
    m = float(np.mean(a))
    if n < 2:
        return m, 0.0
    se = float(np.std(a, ddof=1)) / np.sqrt(n)
    try:
        from scipy import stats

        h = se * float(stats.t.ppf((1 + confidence) / 2.0, n - 1))
    except ImportError:  # normal approximation fallback
        h = se * 1.96
    return m, h


def expand_records(records: Iterable[dict]) -> list:
    """evaluate_policy returns one record per task with per-seed rewards;
    expand to one row per (task, seed)."""
    rows = []
    for r in records:
        rewards = r.get("total_rewards", [r.get("total_reward")])
        seeds = r.get("seeds") or [None] * len(rewards)
        for s, tr in zip(seeds, rewards):
            rows.append(
                {
                    "env_name": r["env_name"],
                    "model_name": r["model_name"],
                    "delay": r["delay"],
                    "seed": s,
                    "total_reward": tr,
                }
            )
    return rows


def normalized_scores(
    records: Iterable[dict], clip: bool = True, agg: str = "std"
) -> dict:
    """{(delay, env, model): (mean, spread, n)} of normalized returns.

    ``agg`` picks the spread statistic: "std" (population std over seeds,
    the reference's table convention, process_logs.py:183-190) or "ci95"
    (Student-t 95% half-width via mean_confidence_interval)."""
    if agg not in ("std", "ci95"):
        raise ValueError(f"agg must be 'std' or 'ci95', got {agg!r}")
    rows = expand_records(records)
    by_task = defaultdict(list)
    for r in rows:
        by_task[(r["delay"], r["env_name"], r["model_name"])].append(r["total_reward"])

    def baseline(delay, env):
        rand = by_task.get((delay, env, "random"))
        orac = by_task.get((delay, env, "oracle"))
        if rand and orac:
            return float(np.mean(rand)), float(np.mean(orac))
        # reference constants cover delays 0/1 only; cells with no usable
        # baseline are skipped
        return REFERENCE_BASELINES.get(delay, {}).get(env)

    out = {}
    for (delay, env, model), vals in by_task.items():
        ref = baseline(delay, env)
        if ref is None:
            continue
        r_rand, r_orac = ref
        denom = r_orac - r_rand
        scores = [100.0 * (v - r_rand) / denom for v in vals]
        if clip:
            scores = [max(0.0, s) for s in scores]
        if agg == "ci95":
            mean, spread = mean_confidence_interval(scores)
        else:
            mean, spread = float(np.mean(scores)), float(np.std(scores))
        out[(delay, env, model)] = (mean, spread, len(scores))
    return out


def latex_table(records: Iterable[dict], models: Optional[list] = None, envs: Optional[list] = None,
                delays: Optional[list] = None, agg: str = "std") -> str:
    """The paper's LaTeX table (process_logs.py:196-233): a row per model,
    column groups delays x envs, each cell mean +/- spread of the normalized
    score (``agg`` as in ``normalized_scores``), "--" where a cell has none."""
    scores = normalized_scores(records, agg=agg)
    delays = delays or sorted({k[0] for k in scores})
    envs = envs or sorted({k[1] for k in scores})
    models = models or sorted({k[2] for k in scores})

    header = "Model & " + " & ".join(f"{env.replace('oderl-', '')} (d={d})" for d in delays for env in envs)
    lines = ["\\begin{tabular}{l" + "c" * (len(delays) * len(envs)) + "}", "\\toprule", header + " \\\\",
             "\\midrule"]
    for m in models:
        cells = []
        for d in delays:
            for env in envs:
                v = scores.get((d, env, m))
                cells.append("--" if v is None else f"${v[0]:.1f} \\pm {v[1]:.1f}$")
        lines.append(f"{m} & " + " & ".join(cells) + " \\\\")
    lines += ["\\bottomrule", "\\end{tabular}"]
    return "\n".join(lines)

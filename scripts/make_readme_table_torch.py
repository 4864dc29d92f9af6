"""Render a results JSONL (the driver's records) as the README's markdown
tables through the port's ``results.process`` (the port's counterpart of
``scripts/make_readme_table.py``).

    python3 scripts/make_readme_table_torch.py logs/results.jsonl

Prints (1) the 6-model x (env x delay) normalized-return table in the shape
of the paper's Table 1 (normalized = 100 * (R - R_rand) / (R_orac - R_rand),
clipped >= 0, scored against the run's own 20-seed oracle and random cells),
and (2) the raw returns of the oracle and random anchors beside the
reference's recorded constants. ``main`` returns the printed text.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neurallaplacecontrol_tpu_torch.results.process import (  # noqa: E402
    REFERENCE_BASELINES,
    normalized_scores,
)

MODELS = ["nl", "delta_t_rnn", "node", "latent_ode", "oracle", "random"]
ENVS = ["oderl-pendulum", "oderl-cartpole", "oderl-acrobot"]
DELAYS = [0, 1, 2, 3]


def main(path) -> str:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    recs = [r for r in recs if not r.get("errored")]
    scores = normalized_scores(recs)
    lines = []

    cols = [f"{e.split('-')[1]} d={d}" for e in ENVS for d in DELAYS]
    lines.append("| Model | " + " | ".join(cols) + " |")
    lines.append("|" + "---|" * (len(cols) + 1))
    for m in MODELS:
        row = [f"**{m}**" if m == "nl" else m]
        for e in ENVS:
            for d in DELAYS:
                v = scores.get((d, e, m))
                row.append(f"{v[0]:.1f} ± {v[1]:.1f}" if v else "")
        lines.append("| " + " | ".join(row) + " |")

    lines += ["", "Raw-return anchors (20 seeds) vs the reference's recorded constants:", "",
              "| env | delay | oracle here | oracle ref | random here | random ref |", "|---|---|---|---|---|---|"]
    by = {}
    for r in recs:
        by.setdefault((r["delay"], r["env_name"], r["model_name"]), r)
    for e in ENVS:
        for d in DELAYS:
            o = by.get((d, e, "oracle"))
            ra = by.get((d, e, "random"))
            ref = REFERENCE_BASELINES.get(d, {}).get(e)  # (random, oracle)
            cells = [
                f"{o['total_reward']:.1f}" if o else "",
                f"{ref[1]:.2f}" if ref else "—",
                f"{ra['total_reward']:.1f}" if ra else "",
                f"{ref[0]:.2f}" if ref else "—",
            ]
            lines.append(f"| {e.split('-')[1]} | {d} | " + " | ".join(cells) + " |")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "logs/results.jsonl")

"""CLI: summarize a results JSONL file into the normalized-return table
(port of ``results/summarize.py``).

    python -m neurallaplacecontrol_tpu_torch.results.summarize logs/results.jsonl
    python -m neurallaplacecontrol_tpu_torch.results.summarize logs/results.jsonl --ci

--ci swaps the spread column from the reference's per-seed std to the
Student-t 95% confidence half-width (process.mean_confidence_interval): use
it whenever the table backs a claim of parity or quality, since at 20 seeds
or fewer a gap between two means smaller than the CI is seed noise.
Records marked ``errored`` are left out.
"""

import argparse
import json

from .process import latex_table, normalized_scores


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", default="logs/results.jsonl")
    ap.add_argument("--ci", action="store_true", help="report Student-t 95%% CI half-widths instead of per-seed std")
    args = ap.parse_args(argv)
    agg = "ci95" if args.ci else "std"
    with open(args.path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    records = [r for r in records if not r.get("errored")]
    for key, (mean, spread, n) in sorted(normalized_scores(records, agg=agg).items()):
        print(f"delay={key[0]} {key[1]:18s} {key[2]:12s} {mean:7.1f} +/- {spread:5.1f} ({agg}, n={n})")
    print()
    print(latex_table(records, agg=agg))


if __name__ == "__main__":
    main()

"""The flagship pipeline from nothing on the GPU: expert data, NL training,
MPPI evaluation (the port's counterpart of ``scripts/e2e_nl_pendulum.py``).

    python3 scripts/e2e_nl_pendulum_torch.py [--device cuda] [--budget 600]

The same steps and budget as the JAX script: ``collect_expert_data`` for
pendulum with delay 1 (200,000 transitions, in chunks of 250 episodes), which
reads the tracked buffer ``artifacts/offlinedata/...pendulum_delay-1...npz``
(the JAX run's 200,000 rows) and writes nothing there (the script refuses to
run without it, and records its sha256); ``train_model`` for NL
from its init for 600 s (``retrain=True, force_retrain=True``), with its
checkpoints under ``artifacts/port/e2e/`` (never the JAX run's
``artifacts/saved_models/``); then ``evaluate_policy`` for NL through the
forward kernel (``Config.fused_nl_planner``), the oracle and random over
seeds 0-4, and the normalized score.

Prints one JSON line, also written to ``--out``
(``artifacts/port/e2e_nl_pendulum_h100.json``): the JAX script's ``nl``,
``oracle``, ``random`` (mean, std) and ``normalized_score``, and the
updates reached, updates/s, ``best_val_loss`` (``train_model``'s best
segment loss), the train loss at every 500th update (``curve``), the card,
the kernel's launches, and ``band``: the curve against the JAX package's
runs of the same training (``artifacts/port/jax_e2e_pendulum_d1.json``, made
by ``scripts/port_jax_e2e_reference.py``) at the counts of ``CHECK_COUNTS``
and the last count both reached. The script exits 1 if the curve leaves the
band there or the run's numbers are not finite.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_CURVE = os.path.join(ROOT, "artifacts", "port", "jax_e2e_pendulum_d1.json")
OUT = os.path.join(ROOT, "artifacts", "port", "e2e_nl_pendulum_h100.json")
ENV, DELAY = "oderl-pendulum", 1
WINDOW = 500  # updates a curve point averages: the JAX package's segment
CHECK_COUNTS = (5_000, 10_000, 20_000)
# Early f32 training is chaotic: JAX's own three inits span up to 8.6x at a
# count (artifacts/port/jax_e2e_pendulum_d1.json, 20k-40k updates), so a
# port run is held to a band a factor BAND_FACTOR beyond their min and max
BAND_FACTOR = 3.0


def window_means(segments, window: int = WINDOW) -> dict:
    """{updates: mean loss over the ``window`` updates that end there} from
    ``train_model``'s ``segment_losses`` ([updates at a segment's end, its
    mean loss], segments that tile the windows)."""
    out, acc, start = {}, [], 0
    for end, mean in segments:
        acc.append((end - start, mean))
        start = end
        if end % window == 0:
            n = sum(k for k, _ in acc)
            if n == window:
                out[int(end)] = sum(k * m for k, m in acc) / n
            acc = []
    return out


def read_jax_curve(path: str = JAX_CURVE) -> dict:
    """{updates: [each JAX run's mean loss over the window ending there]}."""
    with open(path) as f:
        ref = json.load(f)
    runs = list(ref["runs"].values())
    ends = runs[0]["updates_at_segment_end"]
    return {int(c): [r["segment_mean_loss"][i] for r in runs] for i, c in enumerate(ends)}


def curve_band(jax_curve: dict, counts, factor: float = BAND_FACTOR) -> dict:
    """{count: (low, high)}: ``factor`` below the JAX runs' least loss and
    above their largest at each count."""
    return {c: (min(jax_curve[c]) / factor, max(jax_curve[c]) * factor) for c in counts}


def check_curve(curve: dict, jax_curve: dict, counts=CHECK_COUNTS, factor: float = BAND_FACTOR) -> dict:
    """The port's ``curve`` ({updates: loss}) against the band at each of
    ``counts`` it reached and at the last count both curves reached.
    ``inside`` is True when every checked point lies in the band."""
    shared = sorted(set(curve) & set(jax_curve))
    checked = sorted({c for c in counts if c in shared} | ({shared[-1]} if shared else set()))
    band = curve_band(jax_curve, checked, factor)
    points = [{"updates": c, "port": curve[c], "jax": jax_curve[c], "low": band[c][0], "high": band[c][1],
               "inside": bool(band[c][0] <= curve[c] <= band[c][1])} for c in checked]
    every = [c for c in shared if min(jax_curve[c]) / factor <= curve[c] <= max(jax_curve[c]) * factor]
    return {"factor": factor, "points": points, "inside": bool(points) and all(p["inside"] for p in points),
            "matched_counts": len(shared), "inside_at_every_matched_count": len(every)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--budget", type=float, default=600.0, help="train_model's seconds")
    ap.add_argument("--seeds", type=int, default=5, help="evaluation seeds 0..n-1")
    ap.add_argument("--nl_hidden_units", type=int, default=None)
    ap.add_argument("--roll_outs", type=int, default=None)
    ap.add_argument("--time_steps", type=int, default=None)
    ap.add_argument("--saved_models_path", default=os.path.join(ROOT, "artifacts", "port", "e2e") + "/")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from neurallaplacecontrol_tpu_torch.config import Config
    from neurallaplacecontrol_tpu_torch.data import collect_expert_data, replay_buffer_filename
    from neurallaplacecontrol_tpu_torch.ops import pallas_nl
    from neurallaplacecontrol_tpu_torch.training import evaluate_policy, train_model
    from neurallaplacecontrol_tpu_torch.utils.device import card, resolve_device

    device = resolve_device(args.device)
    cfg = Config(
        collect_expert_samples=2e5,  # 1000 episodes (the reference uses 1e6)
        saved_models_path=args.saved_models_path,
        offline_datasets_path=os.path.join(ROOT, "artifacts", "offlinedata") + "/",
        fused_nl_planner=True,
    )
    if args.nl_hidden_units:
        cfg = cfg.replace(nl_hidden_units=args.nl_hidden_units)
    # the JAX run's 200,000 rows: the buffer must be there, so that the call
    # below reads it and collects (and writes) nothing
    buffer = os.path.join(cfg.offline_datasets_path, replay_buffer_filename(ENV, DELAY))
    if not os.path.isfile(buffer):
        raise FileNotFoundError(f"the tracked expert buffer {buffer} is missing")
    with open(buffer, "rb") as f:
        buffer_sha256 = hashlib.sha256(f.read()).hexdigest()
    t0 = time.perf_counter()
    s0, _, _, _ = collect_expert_data(ENV, DELAY, config=cfg, chunk_episodes=250, device=device)
    rows, collect_s = int(s0.shape[0]), time.perf_counter() - t0
    print(f"collected {rows} transitions in {collect_s:.0f}s", flush=True)

    t0 = time.perf_counter()
    model, params, res = train_model("nl", ENV, cfg, delay=DELAY, retrain=True, force_retrain=True,
                                     end_training_after_seconds=args.budget, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    updates = res["segment_losses"][-1][0] if res["segment_losses"] else 0
    print(f"trained: best_loss={res['best_val_loss']:.5f} in {train_wall:.0f}s, {updates} updates", flush=True)

    out = {}
    pallas_nl.nl_forward_fused.launches = 0
    for name, extra in [("nl", dict(model_apply=model.apply, params=params)), ("oracle", {}), ("random", {})]:
        r = evaluate_policy(name, ENV, DELAY, list(range(args.seeds)), cfg, roll_outs=args.roll_outs,
                            time_steps=args.time_steps, device=device, **extra)
        out[name] = (r["total_reward"], r["total_reward_std"])
        print(name, out[name], flush=True)
    launches = pallas_nl.nl_forward_fused.launches
    score = 100 * (out["nl"][0] - out["random"][0]) / (out["oracle"][0] - out["random"][0])

    curve = window_means(res["segment_losses"])
    record = {
        "nl": out["nl"], "oracle": out["oracle"], "random": out["random"], "normalized_score": score,
        "env": ENV, "delay": DELAY, "rows": rows, "data_file": os.path.relpath(buffer, ROOT),
        "data_sha256": buffer_sha256, "collect_s": collect_s, "budget_s": args.budget,
        "updates": updates, "train_seconds": res["train_seconds"], "train_wall_s": train_wall,
        # the first segment runs outside the budget (train_model's set-up)
        "updates_per_s": (updates - res["segment_losses"][0][0]) / res["train_seconds"],
        "best_val_loss": res["best_val_loss"],
        "train_loss": res["train_loss"], "curve": {str(c): v for c, v in curve.items()},
        "nl_forward_launches": launches, "eval_seeds": args.seeds, "card": card(device),
        "config": {"nl_hidden_units": cfg.nl_hidden_units, "training_batch_size": cfg.training_batch_size,
                   "iters_per_log": cfg.iters_per_log, "roll_outs": args.roll_outs or cfg.mppi_roll_outs,
                   "time_steps": args.time_steps or cfg.mppi_time_steps},
        "command": "python3 scripts/e2e_nl_pendulum_torch.py " + " ".join(argv if argv is not None else sys.argv[1:]),
        "band": check_curve(curve, read_jax_curve()),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record), flush=True)
    return record


def cli(argv=None) -> int:
    record = main(argv)
    finite = all(math.isfinite(x) for x in (*record["nl"], *record["oracle"], *record["random"],
                                             record["best_val_loss"]))
    return 0 if finite and record["band"]["inside"] else 1


if __name__ == "__main__":
    sys.exit(cli())

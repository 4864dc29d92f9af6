"""MPPI hyperparameter search with successive-halving early termination
(port of ``training/sweep.py``).

Rebuild of the reference's wandb bayes sweep over the planner knobs
(mppi_optim.yaml: mppi_roll_outs / mppi_time_steps / mppi_lambda /
mppi_sigma, maximizing total_reward, hyperband early-terminate). Trials are
local ``evaluate_policy`` calls, each a seed-batched episode on the device,
pruned by successive halving: every rung triples the seed budget (eta=3,
like the reference's hyperband eta) and keeps the top 1/eta of trials by
mean return. The trials are drawn from ``np.random.default_rng(seed)`` as in
the JAX package, so both packages draw the same trials.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..utils.device import resolve_device
from .eval import evaluate_policy

logger = logging.getLogger(__name__)

# Search space (mppi_optim.yaml:7-31), capped at the JAX package's ranges
ROLL_OUTS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
TIME_STEPS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
LAMBDAS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1000.0)
SIGMAS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 0.8, 1.0, 1.5, 2.0, 10.0, 100.0, 1000.0)


@dataclass
class SweepSpec:
    roll_outs: Sequence[int] = ROLL_OUTS
    time_steps: Sequence[int] = TIME_STEPS
    lambdas: Sequence[float] = LAMBDAS
    sigmas: Sequence[float] = SIGMAS
    n_trials: int = 27  # hyperband max_iter in the reference spec
    eta: int = 3
    base_seeds: int = 2  # seeds per trial at the first rung
    max_seeds: int = 18
    results: list = field(default_factory=list)


def _sample_trial(rng: np.random.Generator, spec: SweepSpec) -> dict:
    return {
        "mppi_roll_outs": int(rng.choice(spec.roll_outs)),
        "mppi_time_steps": int(rng.choice(spec.time_steps)),
        "mppi_lambda": float(rng.choice(spec.lambdas)),
        "mppi_sigma": float(rng.choice(spec.sigmas)),
    }


def run_mppi_sweep(
    model_name: str,
    env_name: str,
    delay: int,
    config: Config = Config(),
    spec: Optional[SweepSpec] = None,
    model_apply=None,
    params=None,
    seed: int = 0,
    results_path: Optional[str] = None,
    dtype=torch.float32,
    device="cuda",
) -> dict:
    """Random search with successive halving; returns the best trial with its
    mean return and every rung's records (``trials``).

    Rung r evaluates the surviving trials with ``evaluate_policy`` on
    ``base_seeds * eta**r`` fresh seeds (at most ``max_seeds``) and keeps
    the top 1/eta by mean return; each record is also appended to
    ``results_path`` as a JSON line. Under ``Config.fused_nl_planner`` an NL
    trial plans through the forward kernel.
    """
    device = resolve_device(device)
    spec = spec or SweepSpec()
    rng = np.random.default_rng(seed)
    trials = [_sample_trial(rng, spec) for _ in range(spec.n_trials)]
    scores = {}

    rung, n_seeds, seed0 = 0, spec.base_seeds, 0
    alive = list(range(len(trials)))
    while alive:
        for i in alive:
            t = trials[i]
            cfg = config.replace(mppi_lambda=t["mppi_lambda"], mppi_sigma=t["mppi_sigma"])
            res = evaluate_policy(
                model_name, env_name, delay,
                seeds=range(seed0, seed0 + n_seeds),
                config=cfg,
                model_apply=model_apply, params=params,
                roll_outs=t["mppi_roll_outs"], time_steps=t["mppi_time_steps"],
                dtype=dtype, device=device,
            )
            scores[i] = res["total_reward"]
            rec = {**t, "rung": rung, "n_seeds": n_seeds, "total_reward": res["total_reward"]}
            spec.results.append(rec)
            logger.info("[sweep %s %s d=%d] %s", model_name, env_name, delay, rec)
            if results_path:
                with open(results_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
        alive.sort(key=lambda i: scores[i], reverse=True)
        keep = max(1, len(alive) // spec.eta)
        if len(alive) == 1 or n_seeds >= spec.max_seeds:
            alive = alive[:1]
            break
        alive = alive[:keep]
        seed0 += n_seeds
        n_seeds = min(n_seeds * spec.eta, spec.max_seeds)
        rung += 1

    best = trials[alive[0]]
    return {**best, "total_reward": scores[alive[0]], "trials": spec.results}

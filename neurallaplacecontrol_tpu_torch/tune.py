"""Execution tuning: the port's measured knobs as an API (port of ``tune.py``).

The reference tunes only MPPI hyperparameters, through a wandb sweep
(mppi_optim.yaml). The port has execution knobs whose best setting depends
on the workload: the planner's NL route (the fused forward kernel, the
window-encoder precompute, or the plain forward), the compute dtype and
multi-device sharding. Two entry points:

- ``recommend(...)`` costs nothing: it sets each knob from what was
  measured on the card (``PERF.md``), or leaves it at the base config
  where nothing was measured, and says which in its rationale.
- ``autotune(...)`` measures: it times each candidate config through the
  same ``training.evaluate_policy`` users run (whose clock starts after the
  kernel build and a warm-up tick) and returns the fastest whose episode
  return stays within a tolerance of the base config's, with a
  JSON-serializable trial log.

What ``recommend`` rests on (NVIDIA H100 80GB HBM3, 700 W; ``PERF.md`` §6,
``chip_smoke.py`` phases ``kernels``, ``widths`` and ``precision``): the
forward kernel takes 0.0253 ms a launch against 0.2399 ms for the plain
forward at 1,000 rows, and 0.45 against 1.11 ms at 20,000 rows, both timed
in CUDA graphs; above width 128 it runs the streamed variant (a chain of
stage kernels tiled over rows and columns), which beats the plain forward at
1,000 rows at every width measured, up to 4,096 (``KERNEL_MAX_WIDTH``);
one plan through the kernel takes 10-22 ms at K=1,000 and 60-61 ms at
65,536, against 72-161 and 82-153 ms on the plain route in bfloat16 or
float32 (``scripts/bench_int8_torch.py --mode perf``, phase ``precision``).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

from .config import Config

BF16_RATIONALE = (
    "float32: the bfloat16 plain route is slower than the kernel route at every K measured (one plan "
    "72-161 against 10-22 ms at K=1,000, 82-153 against 60-61 ms at K=65,536; NVIDIA H100 80GB HBM3, "
    "700 W; PERF.md section 6), and the kernel runs float32 whatever the compute dtype"
)
FUSED_RATIONALE = (
    "on: the forward kernel takes 0.0253 ms against 0.2399 ms for the plain forward at 1,000 rows "
    "and 0.45 against 1.11 ms at 20,000 rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6)"
)
# the three planner routes of the NL model (training.eval.build_planner)
NL_ROUTES = (
    {"fused_nl_planner": True, "nl_planner_precompute": False},
    {"fused_nl_planner": False, "nl_planner_precompute": True},
    {"fused_nl_planner": False, "nl_planner_precompute": False},
)


@dataclass(frozen=True)
class Recommendation:
    """A tuned config plus why each knob landed where it did."""

    config: Config
    shard_rollouts: bool
    rationale: dict = field(default_factory=dict)  # knob -> one-line reason

    def summary(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in sorted(self.rationale.items()))


# the widest nl_hidden_units at which the card measured the forward kernel against the plain f32
# forward at 1,000 rows (K=1,000): faster by more than 10% at every width measured (24 to 4,096),
# so on up to it; past it unmeasured, so as the base config
KERNEL_MAX_WIDTH = 4096
WIDE_RATIONALE = (
    "the streamed forward kernel beats the plain f32 forward at 1,000 rows at every width measured up "
    "to nl_hidden_units=4,096 (160: 0.0965 against 0.2708 ms; 200: 0.1084 against 0.2905; 256: 0.1208 "
    "against 0.3045; 512: 0.2037 against 0.4890; 1,024: 0.5142 against 0.8992 with 64-row GRU tiles; "
    "2,048: 1.6102 against 2.6665; 4,096: 5.5284 against 8.0485; NVIDIA H100 80GB HBM3, 700 W; "
    "chip_smoke.py phase widths and scripts/port_wide_check.py, PERF.md section 6) and is unmeasured "
    "past it"
)


def kernel_takes(config: Config) -> bool:
    """Whether the fused forward kernel takes ``config``'s NL model: the
    fourier ILT, at any width."""
    return config.nl_ilt_algorithm == "fourier"


def recommend(base: Config = Config(), *, roll_outs: Optional[int] = None, n_devices: int = 1) -> Recommendation:
    """Set the execution knobs for a workload from the card's measurements.

    ``roll_outs`` defaults to ``base.mppi_roll_outs``; ``n_devices`` is how
    many devices the planner may shard K over.
    """
    roll_outs = roll_outs or base.mppi_roll_outs
    rationale, overrides = {}, {}

    if base.nl_compute_dtype != "float32":
        overrides["nl_compute_dtype"] = "float32"
    rationale["nl_compute_dtype"] = BF16_RATIONALE

    width = base.nl_hidden_units
    if kernel_takes(base) and width <= KERNEL_MAX_WIDTH:
        if not base.fused_nl_planner:
            overrides["fused_nl_planner"] = True
        rationale["fused_nl_planner"] = FUSED_RATIONALE if width <= 128 else f"on: {WIDE_RATIONALE}"
        rationale["nl_planner_precompute"] = (
            "as the base config: unmeasured on the card, and the fused planner takes precedence over it")
    else:
        why = (f"nl_hidden_units={width}: {WIDE_RATIONALE}" if kernel_takes(base) else
               f"the kernel takes the fourier ILT only, and this config has {base.nl_ilt_algorithm}")
        rationale["fused_nl_planner"] = f"as the base config: {why}"
        rationale["nl_planner_precompute"] = "as the base config: unmeasured on the card"

    rationale["shard_rollouts"] = (
        f"off: {n_devices} device(s), {roll_outs} rollouts; the speed of the K-sharded planner across cards "
        "is unmeasured (PERF.md section 7)")

    cfg = base.replace(**overrides) if overrides else base
    return Recommendation(config=cfg, shard_rollouts=False, rationale=rationale)


def autotune(
    model_name: str,
    env_name: str,
    action_delay: int,
    *,
    base: Config = Config(),
    candidates: Optional[list] = None,
    model_apply=None,
    params=None,
    seeds=(0, 1),
    return_tolerance: float = 0.15,
    results_path: Optional[str] = None,
    evaluate=None,
    device="cuda",
) -> tuple:
    """Measure candidate configs; return ``(best_config, trials)``.

    Each candidate is a dict of ``Config.replace`` overrides; the base
    config runs first (``{}`` is prepended if absent), overrides equal to
    the base are dropped and duplicates run once. A candidate wins only if
    its mean episode return stays within ``return_tolerance`` (relative,
    against the base's |return|): a faster config that plans measurably
    worse is a regression. ``candidates=None`` probes the NL planner's
    three routes (fused kernel, precompute, plain) for ``model_name ==
    "nl"``, and nothing but the base for other models, whose planner reads
    none of these knobs.

    A candidate that sets ``nl_compute_dtype`` (``{"nl_compute_dtype":
    "bfloat16"}``) plans with the NL model rebuilt at that compute dtype,
    as in the JAX package. ``evaluate`` is injectable (the signature of
    ``training.evaluate_policy``); ``device`` goes to it.
    """
    if evaluate is None:
        from .training import evaluate_policy as evaluate

    if candidates is None:
        candidates = [dict(r) for r in NL_ROUTES] if model_name == "nl" else []
    seen, norm = set(), []
    for c in [{}] + list(candidates):
        c = {k: v for k, v in c.items() if getattr(base, k) != v}
        key = tuple(sorted(c.items()))
        if key not in seen:
            seen.add(key)
            norm.append(c)

    trials = []
    for overrides in norm:
        cfg = base.replace(**overrides) if overrides else base
        trial_apply = model_apply
        if model_name == "nl" and model_apply is not None and "nl_compute_dtype" in overrides:
            # the compute dtype is fixed when the model is made, and the
            # planner runs the caller's apply: rebuild it from the trial's
            # config (the same tree, so the caller's params load unchanged)
            from .envs import make_env
            from .models import make_model

            spec = make_env(env_name, dt=cfg.dt).spec
            trial_apply = make_model(model_name, env_name, spec.n_obs, spec.m, spec.action_high, cfg,
                                     device=device).apply
        t0 = time.perf_counter()
        res = evaluate(model_name, env_name, action_delay, seeds=list(seeds), config=cfg,
                       model_apply=trial_apply, params=params, device=device)
        trials.append({
            "overrides": dict(overrides),
            "rollouts_per_sec": res["mppi_rollouts_per_sec"],
            "total_reward": res["total_reward"],
            "episode_elapsed_s": res["episode_elapsed_time"],
            "wall_incl_setup_s": time.perf_counter() - t0,
        })

    baseline = trials[0]
    floor = baseline["total_reward"] - return_tolerance * abs(baseline["total_reward"])
    eligible = [t for t in trials if t["total_reward"] >= floor]
    best = max(eligible, key=lambda t: t["rollouts_per_sec"])
    for t in trials:
        t["eligible"] = t in eligible
        t["best"] = t is best

    if results_path:
        with open(results_path, "w") as f:
            for t in trials:
                f.write(json.dumps(t) + "\n")

    best_cfg = base.replace(**best["overrides"]) if best["overrides"] else base
    return best_cfg, trials

"""The port's tuning API (neurallaplacecontrol_tpu_torch.tune), after
tests/test_tune.py: ``recommend`` sets each knob from the card's
measurements or leaves it, carries none of the JAX package's TPU thresholds
and picks no bfloat16, which the card measured slower; ``autotune`` picks the fastest candidate that does
not regress the return, through an injected evaluator and through one real
tiny CPU run of ``evaluate_policy``."""

import json

import pytest
import torch

from neurallaplacecontrol_tpu import tune as jtune
from neurallaplacecontrol_tpu_torch import tune
from neurallaplacecontrol_tpu_torch.config import Config

torch.set_num_threads(1)


def test_recommend_reference_shape_takes_the_kernel():
    """K=1000, hidden=128 (the paper's shape): the fused kernel, float32, one device."""
    rec = tune.recommend(Config())
    assert rec.config.fused_nl_planner and rec.config.nl_compute_dtype == "float32"
    assert not rec.shard_rollouts
    assert "H100" in rec.rationale["fused_nl_planner"] and "0.0253 ms" in rec.rationale["fused_nl_planner"]
    assert set(rec.rationale) == {"nl_compute_dtype", "fused_nl_planner", "nl_planner_precompute", "shard_rollouts"}


@pytest.mark.parametrize("cfg,roll_outs,jax_bf16", [
    (Config(mppi_roll_outs=65536), None, True), (Config(nl_hidden_units=1024), None, True),
    (Config(), 262144, True), (Config(nl_compute_dtype="bfloat16"), None, False)])
def test_recommend_never_picks_bfloat16(cfg, roll_outs, jax_bf16):
    """Shapes where the JAX package's v5e thresholds pick bfloat16 stay at
    float32, and a bfloat16 base is put back: on the card the bfloat16 plain
    route plans no faster than the float32 one and slower than the kernel
    route at K=1,000 and 65,536, and the rationale says so."""
    rec = tune.recommend(cfg, roll_outs=roll_outs)
    assert rec.config.nl_compute_dtype == "float32"
    assert rec.rationale["nl_compute_dtype"] == tune.BF16_RATIONALE and "H100" in tune.BF16_RATIONALE
    jax_dtype = jtune.recommend(cfg.replace(nl_compute_dtype="float32"), roll_outs=roll_outs).config.nl_compute_dtype
    assert (jax_dtype == "bfloat16") == jax_bf16


def test_recommend_carries_no_tpu_threshold():
    """None of the JAX module's v5e constants, and no rationale that cites
    its TPU artifacts."""
    for name in ("BF16_MIN_ROLLOUTS", "BF16_MIN_HIDDEN", "SHARD_MIN_ROLLOUTS_PER_DEVICE"):
        assert not hasattr(tune, name)
    for cfg in (Config(), Config(nl_hidden_units=512, fused_nl_planner=True, nl_planner_precompute=True)):
        text = tune.recommend(cfg, n_devices=8).summary()
        for word in ("v5e", "TPU", "artifacts/bench", "XLA", "MXU"):
            assert word not in text


def test_recommend_leaves_what_the_kernel_does_not_take():
    """An ILT the kernel does not take and widths past the widest where the
    card measured the kernel against the plain f32 forward at K=1,000
    (8,192, past 4,096) leave fused_nl_planner at the base config, and say
    why; every wide width up to it (160 to 4,096, where the card measured
    the streamed kernel faster) turns the kernel on, citing the times."""
    for cfg in (Config(nl_hidden_units=8192), Config(nl_ilt_algorithm="dehoog")):
        rec = tune.recommend(cfg)
        assert rec.config.fused_nl_planner is False
        assert rec.rationale["fused_nl_planner"].startswith("as the base config")
    assert tune.KERNEL_MAX_WIDTH == 4096
    assert "nl_hidden_units=8192: the streamed forward kernel" in tune.recommend(
        Config(nl_hidden_units=8192)).rationale["fused_nl_planner"]
    for width in (160, 256, 384, 512, 1024, 4096):
        rec = tune.recommend(Config(nl_hidden_units=width))
        assert rec.config.fused_nl_planner is True
        assert "512: 0.2037 against 0.4890" in rec.rationale["fused_nl_planner"]
    rec = tune.recommend(Config(nl_planner_precompute=True, nl_hidden_units=256))
    assert rec.config.nl_planner_precompute is True


def test_recommend_never_shards():
    """Multi-card speed is unmeasured: K-sharding stays off at any device count."""
    for n in (1, 2, 4, 8):
        rec = tune.recommend(Config(mppi_roll_outs=16384), n_devices=n)
        assert not rec.shard_rollouts and "unmeasured" in rec.rationale["shard_rollouts"]


def _fake_evaluate(table, calls=None):
    """Evaluator keyed by the planner route the trial config selects."""

    def evaluate(model_name, env_name, delay, seeds, config, **kw):
        if calls is not None:
            calls.append(kw["device"])
        rps, reward = table[(config.fused_nl_planner, config.nl_planner_precompute)]
        return {"mppi_rollouts_per_sec": rps, "total_reward": reward, "episode_elapsed_time": 1.0}

    return evaluate


def test_autotune_picks_fastest_nonregressing(tmp_path):
    """The fastest candidate wins only while its return holds; when it
    regresses past tolerance the next fastest eligible one wins."""
    good = {(False, False): (1000.0, -150.0), (True, False): (3000.0, -152.0), (False, True): (1200.0, -150.0)}
    path = str(tmp_path / "trials.jsonl")
    calls = []
    best, trials = tune.autotune("nl", "oderl-cartpole", 1, base=Config(), evaluate=_fake_evaluate(good, calls),
                                 results_path=path, device="cpu")
    assert best.fused_nl_planner and calls == ["cpu"] * 3
    assert [t["overrides"] for t in trials] == [{}, {"fused_nl_planner": True}, {"nl_planner_precompute": True}]
    assert [t["best"] for t in trials] == [False, True, False]
    logged = [json.loads(line) for line in open(path)]
    assert len(logged) == 3 and logged[1]["best"]

    bad = dict(good)
    bad[(True, False)] = (3000.0, -400.0)  # fast but plans much worse
    best2, trials2 = tune.autotune("nl", "oderl-cartpole", 1, base=Config(), evaluate=_fake_evaluate(bad))
    assert not best2.fused_nl_planner and best2.nl_planner_precompute
    assert not trials2[1]["eligible"]


def test_autotune_baseline_first_and_no_duplicates():
    """The base config runs first and is always eligible; a candidate equal
    to the base, or to another candidate, runs once; a base with the kernel
    on probes the other two routes."""
    table = {(False, False): (500.0, -100.0), (True, False): (400.0, -100.0), (False, True): (450.0, -100.0)}
    best, trials = tune.autotune("nl", "oderl-cartpole", 1, base=Config(),
                                 candidates=[{"fused_nl_planner": True}, {"fused_nl_planner": True},
                                             {"fused_nl_planner": False}], evaluate=_fake_evaluate(table))
    assert [t["overrides"] for t in trials] == [{}, {"fused_nl_planner": True}]
    assert trials[0]["eligible"] and best == Config()
    _, trials2 = tune.autotune("nl", "oderl-cartpole", 1, base=Config(fused_nl_planner=True),
                               evaluate=_fake_evaluate(table))
    assert [t["overrides"] for t in trials2] == [
        {}, {"fused_nl_planner": False, "nl_planner_precompute": True}, {"fused_nl_planner": False}]


def test_autotune_probes_nothing_for_models_without_the_knobs():
    table = {(False, False): (500.0, -100.0)}
    best, trials = tune.autotune("oracle", "oderl-cartpole", 1, base=Config(), evaluate=_fake_evaluate(table))
    assert len(trials) == 1 and trials[0]["best"] and best == Config()


def test_autotune_runs_evaluate_policy_on_the_cpu(tmp_path):
    """One real tiny run: the three NL routes through ``evaluate_policy`` on
    the tracked cartpole-d1 checkpoint, 2 seeds, on the CPU."""
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    base = Config(dt=2.5, mppi_roll_outs=8, mppi_time_steps=2)
    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)),
                         device="cpu")
    model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, base, device="cpu")
    best, trials = tune.autotune("nl", "oderl-cartpole", 1, base=base, model_apply=model.apply, params=params,
                                 device="cpu", results_path=str(tmp_path / "t.jsonl"))
    assert len(trials) == 3 and sum(t["best"] for t in trials) == 1
    assert all(t["rollouts_per_sec"] > 0 and t["wall_incl_setup_s"] > 0 for t in trials)
    # the three routes plan the same model: returns agree to f32 accuracy
    returns = [t["total_reward"] for t in trials]
    assert max(returns) - min(returns) < 1e-2 * abs(returns[0])
    assert isinstance(best, Config)


def test_autotune_rebuilds_the_apply_for_a_compute_dtype():
    """A ``{"nl_compute_dtype": "bfloat16"}`` candidate, as the JAX package's
    autotune takes it: the trial plans with the NL model rebuilt at that
    dtype (the caller's apply is f32), on the caller's params."""
    from neurallaplacecontrol_tpu_torch.models import make_model
    from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name, resolve_checkpoint

    params = load_pytree(resolve_checkpoint(model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)),
                         device="cpu")
    f32 = make_model("nl", "oderl-cartpole", 5, 1, 3.0, Config(), device="cpu")
    bf16 = make_model("nl", "oderl-cartpole", 5, 1, 3.0, Config(nl_compute_dtype="bfloat16"), device="cpu")
    x = (torch.randn(6, 5, generator=torch.Generator().manual_seed(0)), torch.zeros(6, 4, 1), torch.full((6, 1), 0.05))
    seen = {}

    def evaluate(model_name, env_name, delay, seeds, config, model_apply=None, params=None, **kw):
        seen[config.nl_compute_dtype] = model_apply(params, *x)
        return {"mppi_rollouts_per_sec": 2.0 if config.nl_compute_dtype == "bfloat16" else 1.0,
                "total_reward": -100.0, "episode_elapsed_time": 1.0}

    best, trials = tune.autotune("nl", "oderl-cartpole", 1, base=Config(), model_apply=f32.apply, params=params,
                                 candidates=[{"nl_compute_dtype": "bfloat16"}], evaluate=evaluate, device="cpu")
    assert best.nl_compute_dtype == "bfloat16" and [t["overrides"] for t in trials] == [
        {}, {"nl_compute_dtype": "bfloat16"}]
    assert torch.equal(seen["float32"], f32.apply(params, *x))
    assert torch.equal(seen["bfloat16"], bf16.apply(params, *x))
    assert not torch.equal(seen["bfloat16"], seen["float32"])

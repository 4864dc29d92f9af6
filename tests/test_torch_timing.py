"""The port's spans (``neurallaplacecontrol_tpu_torch.utils.timing``): off by
default, their nesting, parents and tick identifiers when on, the bounded
buffer, the spans an NL episode and a controller tick record, the same
outputs with the recorder on and off, and the exported step unaffected."""

import io

import pytest
import torch

from neurallaplacecontrol_tpu_torch import serving
from neurallaplacecontrol_tpu_torch.config import Config
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.training.eval import build_planner
from neurallaplacecontrol_tpu_torch.training.rollout import EpisodeSettings, SeedDraws, make_episode_fn
from neurallaplacecontrol_tpu_torch.utils import timing
from neurallaplacecontrol_tpu_torch.utils.checkpoint import (
    load_pytree,
    model_checkpoint_name,
    tracked_checkpoint_path,
)

torch.set_num_threads(1)

K, T, TICKS = 8, 3, 3
PHASES = ["plan.perturb", "plan.rollout", "plan.weigh"]


@pytest.fixture
def recorder():
    """Stops the recorder after the test, whatever it left running."""
    yield timing
    timing.stop()


def nl_fused(device="cpu"):
    cfg = Config(fused_nl_planner=True)
    model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, cfg, dtype=torch.float32, device=device)
    params = load_pytree(tracked_checkpoint_path(model_checkpoint_name("nl", "oderl-cartpole", 1, "exp", 0, True)),
                         device=device, dtype=torch.float32)
    return cfg, model, params


def run_episode():
    cfg, model, params = nl_fused()
    env, mppi_cfg, mppi_params, dynamics, carry, encoder = build_planner(
        "nl", "oderl-cartpole", 1, cfg, model_apply=model.apply, params=params, roll_outs=K, time_steps=T,
        device="cpu")
    episode = make_episode_fn(env, dynamics, mppi_cfg, mppi_params, EpisodeSettings(delay=1, n_steps=TICKS),
                              dynamics_carry_init=carry, window_encoder=encoder)
    return episode(SeedDraws([3, 4], device="cpu"))


def controller():
    cfg, model, params = nl_fused()
    return serving.make_controller("nl", "oderl-cartpole", 1, cfg, model_apply=model.apply, params=params,
                                   roll_outs=K, time_steps=T, device="cpu")


def controller_ticks(ctrl):
    g = torch.Generator().manual_seed(5)
    state, out = ctrl.reset(0), []
    for _ in range(TICKS):
        action, state = ctrl.step(state, torch.randn(5, generator=g), noise=torch.randn((K, T, 1), generator=g))
        out.append((action, *state))
    return out


def test_off_records_nothing(recorder):
    recorder.start()
    recorder.stop()
    with recorder.span("tick"):
        with recorder.span("plan"):
            pass
    assert recorder.records() == [] and recorder.dropped() == 0
    assert recorder.span("a") is recorder.span("b")  # the one shared null context


def test_nesting_parents_ticks_and_dropped(recorder, monkeypatch):
    monkeypatch.setattr(recorder, "CAPACITY", 6)
    recorder.start()
    with recorder.span("outside"):
        pass
    for _ in range(2):
        with recorder.span("tick"):
            with recorder.span("plan"):
                with recorder.span("fwd.plain"):
                    pass
    recorder.stop()
    recs = recorder.records()
    assert [r.name for r in recs] == ["outside", "tick", "plan", "fwd.plain", "tick", "plan"]
    assert [r.parent for r in recs] == [-1, -1, 1, 2, -1, 4]
    assert [r.tick for r in recs] == [-1, 1, 1, 1, 4, 4]
    assert recorder.dropped() == 1  # the second tick's forward found the buffer full
    for r in recs:
        assert 0 < r.start_ns <= r.end_ns
    for r in recs[1:4]:
        assert recs[1].start_ns <= r.start_ns and r.end_ns <= recs[1].end_ns
    assert recs[4].start_ns >= recs[1].end_ns


def test_a_span_open_at_stop_closes_into_its_recorder(recorder):
    recorder.start()
    with recorder.span("tick"):
        recorder.stop()
        with recorder.span("plan"):  # opened after the stop: not recorded
            pass
    (tick,) = recorder.records()
    assert tick.name == "tick" and tick.end_ns >= tick.start_ns


def test_start_begins_a_new_recorder(recorder, monkeypatch):
    """``start()`` allocates ``CAPACITY`` slots afresh: the spans and the
    dropped count of the recorder before are gone."""
    monkeypatch.setattr(recorder, "CAPACITY", 2)
    recorder.start()
    for name in ("a", "b", "c"):
        with recorder.span(name):
            pass
    assert [r.name for r in recorder.records()] == ["a", "b"] and recorder.dropped() == 1
    recorder.start()
    with recorder.span("d"):
        pass
    assert [r.name for r in recorder.records()] == ["d"] and recorder.dropped() == 0


def test_episode_spans_and_outputs(recorder):
    """Per tick of a CPU episode on the fused NL's plain route: one ``tick``,
    one ``plan`` in it, the plan's three phases, and T ``fwd.plain`` spans in
    the rollout; returns and records bitwise equal with the recorder off."""
    total_off, records_off = run_episode()
    recorder.start()
    total_on, records_on = run_episode()
    recorder.stop()
    assert torch.equal(total_on, total_off)
    for a, b in zip(records_on, records_off):
        assert torch.equal(a, b)
    recs = recorder.records()
    ticks = [i for i, r in enumerate(recs) if r.name == "tick"]
    assert len(ticks) == TICKS and recorder.dropped() == 0
    for t in ticks:
        mine = [r for r in recs if r.tick == t]
        assert [r.name for r in mine] == ["tick", "plan", *PHASES[:2], *["fwd.plain"] * T, PHASES[2]]
        plan = recs.index(mine[1])
        assert mine[1].parent == t and all(r.parent == plan for r in mine if r.name in PHASES)
        rollout = recs.index(mine[3])
        assert all(r.parent == rollout for r in mine if r.name == "fwd.plain")


def test_controller_spans_and_outputs(recorder):
    ctrl = controller()
    off = controller_ticks(ctrl)
    recorder.start()
    on = controller_ticks(ctrl)
    recorder.stop()
    for a, b in zip(on, off):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    names = [r.name for r in recorder.records()]
    assert names.count("tick") == names.count("plan") == TICKS
    assert names.count("fwd.plain") == TICKS * T and all(names.count(p) == TICKS for p in PHASES)


def test_export_with_the_recorder_on(recorder, tmp_path):
    """Exported while the recorder runs, the program is the one exported with
    it off (same graph), tracing records no span, and the loaded step ticks
    as ``Controller.step`` does."""
    ctrl = controller()
    graph_off = str(torch.export.load(io.BytesIO(serving.export_controller(ctrl))).graph)
    recorder.start()
    before = len(recorder.records())
    blob = serving.export_controller(ctrl, path=str(tmp_path / "c.pt2"))
    program = torch.export.load(io.BytesIO(blob))
    assert str(program.graph) == graph_off
    # the export's one eager step on zeros records its spans; its trace none
    names = [r.name for r in recorder.records()[before:]]
    assert names.count("tick") == 1 and names.count("fwd.plain") == T
    step = serving.load_controller_step(tmp_path / "c.pt2")
    exp, got = controller_ticks(ctrl), []
    g = torch.Generator().manual_seed(5)
    state = ctrl.reset(0)
    for _ in range(TICKS):
        action, state = step(state, torch.randn(5, generator=g), noise=torch.randn((K, T, 1), generator=g))
        got.append((action, *state))
    recorder.stop()
    for a, b in zip(exp, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)

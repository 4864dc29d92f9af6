"""The model adapters (``portbench/models/``), on the CPU: the load stops at a
model with no adapter or with an adapter that lacks an entry, NL's judge
reads what it read before the adapters existed, ``reference.mppi.tick``
threads a model's carry, both drivers plan through what the adapter's
``planner_apply`` names (the port's latent ODE carries its history as the
port's own path does), and the files of the core name no model."""

import json
import re
import types

import pytest
import torch

from portbench import calibrate, drivers, harness, inputs, models, trace
from portbench import cell as cells
from portbench.drivers import episodes, plant
from portbench.reference import mppi

from .test_portbench_run import TINY
from .test_portbench_trace import FakeTracer, X

torch.set_num_threads(1)
F64 = torch.float64


def bench_with_model(tmp_path, model):
    """A copy of ``BENCHMARK.json`` under ``tmp_path`` with one more cell,
    ``other-eval``, whose configuration names ``model``."""
    bench = cells.benchmark()
    config = json.loads((cells.ROOT / bench["configs"][0]["file"]).read_text())
    config["model"] = model
    (tmp_path / "other.json").write_text(json.dumps(config))
    bench["configs"].append(dict(bench["configs"][0], name="other", file="other.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="other-eval", config="other"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("model", ["no_such_model", "no.such"])
def test_a_model_without_an_adapter_stops_the_load(tmp_path, model):
    bench_with_model(tmp_path, model)
    with pytest.raises(SystemExit, match=re.escape(f"portbench/models/{model}.py is missing")):
        cells.load("other-eval", root=tmp_path)


def test_a_model_with_an_adapter_loads(tmp_path):
    bench_with_model(tmp_path, "nl")
    assert cells.load("other-eval", root=tmp_path).model is models.adapter("nl")


ADAPTERS = sorted(p.stem for p in models.MODELS_DIR.glob("*.py") if p.stem != "__init__")


@pytest.mark.parametrize("name", ADAPTERS)
def test_each_adapter_defines_every_entry(name):
    module = models.adapter(name)
    for entry in models.ENTRIES:
        value = getattr(module, entry, None)
        assert value is not None, f"portbench/models/{name}.py lacks {entry}"
        assert callable(value) or entry == "port_config_keys", entry


def test_an_adapter_without_planner_apply_stops_the_load(monkeypatch):
    monkeypatch.delattr(models.adapter("nl"), "planner_apply")
    with pytest.raises(SystemExit, match="the adapter for the model 'nl' lacks planner_apply"):
        models.adapter("nl")


def test_nl_adapter():
    nl = models.adapter("nl")
    assert nl.__name__ == "portbench.models.nl"
    assert len(nl.port_config_keys) == 9 and len(set(nl.port_config_keys)) == 9
    port_model = drivers.port_setup(cells.load("nl128-eval-s20"), torch.device("cpu"))[1]
    assert nl.planner_apply(port_model) is port_model.apply
    assert cells.load("nl512-eval-s10").dims == {"n_obs": 5, "m_act": 1, "width": 512, "gru_hidden": 256,
                                                 "terms": 17, "actions": 4, "gru_layers": 2}
    dims = cells.load("nl128-eval-s20").dims
    assert nl.flops_per_row(**dims) == 384_338  # test_portbench_flops' count at width 128
    assert nl.least_seconds(20_000, **dims) == pytest.approx(20_000 * 384_338 / 495e12)
    assert nl.is_forward_op("(anonymous namespace)::nl_forward_kernel(float const*)")
    assert nl.is_forward_op("void (anonymous namespace)::nl_wide_gemm_kernel<3, 4>(GemmArgs)")
    assert not nl.is_forward_op("void at::native::add_kernel") and not nl.is_forward_op("Memcpy DtoH")


@pytest.mark.parametrize("name", ["nl128-eval-s20", "nl512-eval-s10"])
def test_port_config_from_the_adapters_keys(name):
    cell = cells.load(name)
    cfg, model = drivers.port_setup(cell, torch.device("cpu"))
    for key in cell.model.port_config_keys:
        assert getattr(cfg, key) == cell.config[key], key
    assert model is not None


# The tiny judge's readings (``calibrate.readings`` at ``TINY``'s sizes on the
# CPU, one thread; the port's run from seed 3,000,000,001, the control's from
# 3,000,000,002) as the harness of commit da93889, before the adapters, gave
# them with PyTorch 2.13 on an x86-64 CPU (another CPU or PyTorch build may
# round differently). The control's plan_gap is exactly 0: on the CPU, TF32
# changes nothing, so the control's planner is the judge's.
PARENT = {
    "nl128-eval-s20": {"port": {"plan_gap": 1.8328428268432617e-06, "transition_gap": 6.379086414654012e-08},
                       "control": {"plan_gap": 0.0, "transition_gap": 0.006880101747810841}},
    "nl512-eval-s10": {"port": {"plan_gap": 1.1324882507324219e-06, "transition_gap": 6.120547624277606e-08},
                       "control": {"plan_gap": 0.0, "transition_gap": 0.006435004062950611}},
    "nl128-serve-k32768": {"port": {"plan_gap": 1.6490618387858074e-06}, "control": {"plan_gap": 0.0}},
}


@pytest.mark.parametrize("name", sorted(PARENT))
def test_nl_judge_reads_as_before_the_adapters(name):
    r = calibrate.readings(name, [3_000_000_001], [3_000_000_002], device="cpu", traffic_overrides=TINY[name])
    for side, seed in (("port", 3_000_000_001), ("control", 3_000_000_002)):
        got = {k: v for k, v in r[side][seed].items() if k != "seconds"}
        assert got == pytest.approx(PARENT[name][side], rel=1e-7, abs=0), side


class Counting:
    """A stand-in model that carries its own count of steps: each rollout's
    carry starts at a value of its own and grows by one a step, and the
    state moves by the step's input scaled by the carry."""

    def __init__(self):
        self.carries = []

    def init_carry(self, rows):
        return 0.5 * torch.arange(rows, dtype=F64)

    def prepare(self, windows):  # [N, T, A, nu] -> [N, T]
        return windows.sum(dim=(2, 3))

    def step(self, state, x, carry):
        self.carries.append(carry.clone())
        return state + 0.1 * torch.tanh(x[:, None] * (1.0 + carry[:, None])), carry + 1.0


def cost_fn(state, action):
    return (state ** 2).sum(-1) + (action ** 2).sum(-1)


def tick_by_hand(U_prev, obs, buffer, noise, sigma_inv, u_scale, u_min, u_max, lam):
    """The same tick, one rollout at a time, with the stand-in's steps written out."""
    S, K, T, nu = noise.shape
    A = buffer.shape[1]
    U = torch.cat([U_prev[:, 1:], torch.zeros_like(U_prev[:, :1])], dim=1)
    U_new = U.clone()
    for s in range(S):
        costs, eps_all = [], []
        for k in range(K):
            perturbed = torch.clamp((U[s] + noise[s, k]) * u_scale, u_min, u_max) / u_scale
            eps = perturbed - U[s]
            scaled = perturbed * u_scale
            joined = torch.cat([buffer[s, 1:], scaled])
            state, carry, cost = obs[s].clone(), 0.5 * (s * K + k), 0.0
            for t in range(T):
                x = joined[t:t + A].sum()
                state = state + 0.1 * torch.tanh(x * (1.0 + carry))
                carry += 1.0
                cost = cost + cost_fn(state, scaled[t])
            cost = cost + lam * sum(U[s, t] @ (eps[t] @ sigma_inv) for t in range(T))
            costs.append(cost)
            eps_all.append(eps)
        costs = torch.stack(costs)
        w = torch.exp(-(costs - costs.min()) / lam)
        U_new[s] = U[s] + sum(w[k] / w.sum() * eps_all[k] for k in range(K))
    return U_new[:, 0] * u_scale, U_new


def test_tick_threads_the_carry_of_each_rollout():
    g = torch.Generator().manual_seed(11)
    S, K, T, A, nu, n = 2, 3, 5, 4, 2, 3
    U_prev = torch.randn((S, T, nu), generator=g, dtype=F64)
    obs = torch.randn((S, n), generator=g, dtype=F64)
    buffer = torch.randn((S, A, nu), generator=g, dtype=F64)
    noise = 1.5 * torch.randn((S, K, T, nu), generator=g, dtype=F64)  # some clip at the bound
    sigma_inv = torch.tensor([[1.5, -0.5], [-0.5, 1.5]], dtype=F64)
    args = (U_prev, obs, buffer, noise, sigma_inv, 2.0, -3.0, 3.0, 0.7)
    model = Counting()
    action, U = mppi.tick(model, cost_fn, *args)
    start = model.init_carry(S * K)
    assert len(model.carries) == T
    for t, carry in enumerate(model.carries):
        assert torch.equal(carry, start + t)
    want_action, want_U = tick_by_hand(*args)
    assert torch.allclose(action, want_action, rtol=0, atol=1e-12)
    assert torch.allclose(U, want_U, rtol=0, atol=1e-12)
    assert not torch.allclose(U, torch.cat([U_prev[:, 1:], torch.zeros_like(U_prev[:, :1])], dim=1))


def test_a_model_without_a_kernel_reads_no_forward_time():
    """A model whose forward has no kernel of its own claims no operation:
    the forward's device metrics read nothing, the whole tick's still read."""
    events = [X("cuda_runtime", trace.SYNC, 0, 10),
              X("kernel", "(anonymous namespace)::nl_forward_kernel(float const*)", 20, 30),
              X("kernel", "void at::native::add_kernel", 60, 20),
              X("cuda_runtime", trace.SYNC, 90, 10)]
    t = trace.read(FakeTracer(events), [], cells.load("nl128-eval-s20").dims, lambda name: False)
    assert t.fwd_device_s == 0 and t.other_device_s == pytest.approx(50e-6)
    run = harness.Run(cells.load("nl128-eval-s20"), 0.0, None, t)
    for name in ("fwd_device_ms", "fwd_roofline"):
        assert harness.reader("metrics", name)(run) is None
    for name in ("device_ops_per_tick", "planner_device_ms", "device_idle", "mfu"):
        assert harness.reader("metrics", name)(run) > 0


LODE_CHECKPOINT = ("artifacts/checkpoints/"
                   "latent_ode_oderl-cartpole_delay-1_ts-grid-exp_0_train-with-expert-trajectories-True.npz")
LODE_TINY = {"lode-eval": {"seeds": 2, "horizon": 4, "episode_ticks": 3, "warmup_ticks": 1},
             "lode-serve": {"rollouts": 8, "horizon": 4, "episode_ticks": 3, "warmup_ticks": 1}}
LODE_SEED = 3_000_000_007


def lode_adapter(planner_apply=lambda port_model: port_model):
    """A stand-in adapter for the port's latent ODE: the configuration's keys
    of its ``Config`` (``mppi_roll_outs`` sets the rows of its fixed draw of
    z0's noise), and ``planner_apply``, by default the model itself, as
    ``run_exp_multi_torch._apply_of`` hands it over. It has no judge: its
    ``reference`` raises. Its forward has no kernel and counts nothing."""
    def reference(cell, params, device, dtype):
        raise NotImplementedError("the stand-in has no judge's latent ODE")

    def no_yardstick(*args, **kwargs):
        raise NotImplementedError("the stand-in has no yardstick")

    return types.SimpleNamespace(
        reference=reference, planner_apply=planner_apply, dims=lambda config: {},
        port_config_keys=("latent_ode_hidden_units", "action_buffer_size", "dt", "mppi_roll_outs",
                          "mppi_lambda", "mppi_sigma"),
        flops_per_row=no_yardstick, least_seconds=no_yardstick, counters=lambda: (0, 0),
        is_forward_op=lambda name: False)


def bench_with_lode(root, rollouts):
    """A copy of ``BENCHMARK.json`` under ``root`` with the cells ``lode-eval``
    (episodes) and ``lode-serve`` (plant) of the port's latent ODE on
    cartpole d1 at ``rollouts`` rollouts, its tracked checkpoint and hidden
    units 128."""
    bench = cells.benchmark()
    nl = bench["configs"][0]
    config = json.loads((cells.ROOT / nl["file"]).read_text())
    config.update(model="latent_ode", checkpoint=LODE_CHECKPOINT, latent_ode_hidden_units=128,
                  mppi_roll_outs=rollouts)
    (root / "lode.json").write_text(json.dumps(config))
    bench["configs"].append(dict(nl, name="lode", file="lode.json"))
    bench["workloads"] += [dict(name="lode-eval", config="lode", traffic="eval-s20", chips=1, why="stand-in"),
                           dict(name="lode-serve", config="lode", traffic="serve-k32768", chips=1, why="stand-in")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def load_lode(tmp_path, monkeypatch, name, adapter):
    bench_with_lode(tmp_path, 8)
    real = models.adapter
    monkeypatch.setattr(models, "adapter", lambda model: adapter if model == "latent_ode" else real(model))
    return cells.load(name, root=tmp_path, traffic_overrides=LODE_TINY[name])


def recording_builds(monkeypatch):
    """Every planner the port's ``build_planner`` builds from here on."""
    import neurallaplacecontrol_tpu_torch.training.eval as port_eval

    built, real = [], port_eval.build_planner

    def build_planner(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(port_eval, "build_planner", build_planner)
    return built


def driver_plans(cell, monkeypatch):
    """(plans, observations, carry_init) of the cell's driver: ``setup()``
    and ``window(0.0, None)``, the plans of the window's first batch or
    episode, and the planner's ``dynamics_carry_init``."""
    built = recording_builds(monkeypatch)
    kind = episodes if cell.traffic["kind"] == "episodes" else plant
    driver = kind.Driver(cell, LODE_SEED, "cpu")
    driver.setup()
    driver.window(0.0, None)
    if kind is episodes:
        _, records, plans = driver.batches[0]
        return torch.stack(plans, dim=1), records.s0, built[-1][4]
    _, obs, _, plans = driver.episodes[0]
    assert driver.ctrl.dynamics_carry_init is built[-1][4]
    return plans, obs, built[-1][4]


def port_plans(cell, monkeypatch, observations):
    """The plans of the port's own path on the same draws, the latent ODE
    handed over as the model itself: ``build_planner`` and
    ``make_episode_fn`` (its own call of the planner), or
    ``make_controller``'s ``step`` on the driver's observations."""
    import neurallaplacecontrol_tpu_torch as port
    import neurallaplacecontrol_tpu_torch.training.rollout as rollout
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner

    cpu = torch.device("cpu")
    cfg = port.Config(latent_ode_hidden_units=128, action_buffer_size=4, dt=0.05, mppi_roll_outs=8,
                      mppi_lambda=1.0, mppi_sigma=1.0)
    model = port.make_model("latent_ode", "oderl-cartpole", 5, 1, 3.0, cfg, device=cpu)
    params = inputs.params(cell, LODE_SEED, cpu)
    if cell.traffic["kind"] == "plant":
        ctrl = port.make_controller("latent_ode", "oderl-cartpole", 1, cfg, model_apply=model, params=params,
                                    roll_outs=cell.rollouts, time_steps=cell.horizon, device=cpu)
        draws = inputs.PlantDraws(cell, LODE_SEED, 0, cpu)
        state, plans = ctrl.reset(0)._replace(U=draws.U0), []
        for obs in observations:
            state = ctrl.step(state, obs, noise=draws.noise())[1]
            plans.append(state.U)
        return torch.stack(plans)
    env, mppi_cfg, mppi_params, dynamics, carry, _ = build_planner(
        "latent_ode", "oderl-cartpole", 1, cfg, model_apply=model, params=params, roll_outs=cell.rollouts,
        time_steps=cell.horizon, device=cpu)
    plans, command = [], rollout.mppi_command

    def recording_command(*args, **kwargs):
        out = command(*args, **kwargs)
        plans.append(out[1])
        return out

    monkeypatch.setattr(rollout, "mppi_command", recording_command)
    settings = rollout.EpisodeSettings(delay=1, n_steps=int(cell.traffic["episode_ticks"]), action_buffer_size=4)
    rollout.make_episode_fn(env, dynamics, mppi_cfg, mppi_params, settings, dynamics_carry_init=carry)(
        inputs.EpisodeDraws(cell, LODE_SEED, 0, cpu))
    return torch.stack(plans, dim=1)


@pytest.mark.parametrize("name", sorted(LODE_TINY))
def test_the_drivers_hand_over_what_the_adapter_names(tmp_path, monkeypatch, name):
    """The latent ODE handed over as itself: the planner is built carried and
    plans bit for bit as the port's own path does."""
    cell = load_lode(tmp_path, monkeypatch, name, lode_adapter())
    plans, observations, carry_init = driver_plans(cell, monkeypatch)
    assert carry_init is not None
    want = port_plans(cell, monkeypatch, observations)
    assert plans.shape == want.shape and plans.shape[-2:] == (4, 1)
    assert torch.equal(plans, want)


@pytest.mark.parametrize("name", sorted(LODE_TINY))
def test_a_planted_apply_plans_through_the_tiled_history(tmp_path, monkeypatch, name):
    """An adapter that hands over the latent ODE's ``apply``: the planner is
    built without a carry, and its plans part from the carried path's."""
    cell = load_lode(tmp_path, monkeypatch, name, lode_adapter(lambda port_model: port_model.apply))
    plans, observations, carry_init = driver_plans(cell, monkeypatch)
    assert carry_init is None
    want = port_plans(cell, monkeypatch, observations)
    assert plans.shape == want.shape
    assert not torch.equal(plans, want)
    assert (plans - want).abs().max() > 1e-3


CORE = ["harness.py", "cell.py", "check.py", "trace.py", "spans.py", "calibrate.py", "inputs.py", "run.py",
        "span_run.py", "drivers/*.py", "reference/mppi.py", "metrics/*.py", "e2e/*.py"]
NL_NAMES = re.compile(r"nl_forward_fused|NLModel|nl_hidden_units|nl_s_recon_terms|nl_ilt_algorithm"
                      r"|\bnl_\S*kernel|reference\.nl\b")


@pytest.mark.parametrize("pattern", CORE)
def test_the_core_names_no_model(pattern):
    paths = sorted(cells.BENCH_DIR.glob(pattern))
    assert paths
    for path in paths:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            assert not NL_NAMES.search(line), f"{path.relative_to(cells.ROOT)}:{i}: {line.strip()}"

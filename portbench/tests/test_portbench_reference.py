"""The plain reference agrees with the port's plain route on the same inputs
(float64, on the CPU, at a tiny K and T)."""

import numpy as np
import pytest
import torch

import neurallaplacecontrol_tpu_torch as port
from neurallaplacecontrol_tpu_torch.planners import MPPIConfig, default_noise_sigma, make_mppi_params, mppi_command
from neurallaplacecontrol_tpu_torch.training.rollout import build_learned_dynamics, build_running_cost
from portbench import cell as cells
from portbench import check, inputs
from portbench.reference import cartpole
from portbench.reference.nl import NLModel

torch.set_num_threads(1)
F64 = torch.float64


@pytest.fixture(scope="module")
def setup():
    cell = cells.load("nl128-eval-s20")
    params = inputs.params(cell, 0, "cpu")
    c = cell.config
    cfg = port.Config(nl_hidden_units=128)
    model = port.make_model("nl", c["env"], 5, 1, 3.0, cfg, dtype=F64, device="cpu")
    p64 = {"encoder": {"gru": [{k: v.double() for k, v in layer.items()} for layer in params["encoder"]["gru"]],
                       "out": {k: v.double() for k, v in params["encoder"]["out"].items()}},
           "laplace_rep": [{k: v.double() for k, v in layer.items()} for layer in params["laplace_rep"]]}
    ref = NLModel(params, c["norm"], c["dt"], c["nl_s_recon_terms"], dtype=F64)
    return cell, model, p64, ref


def test_forward_matches_port_plain_route(setup):
    cell, model, p64, ref = setup
    g = torch.Generator().manual_seed(1)
    obs = torch.randn((64, 5), generator=g, dtype=F64) * torch.tensor([1.0, 3.0, 0.7, 0.7, 5.0], dtype=F64)
    windows = 3.0 * (2 * torch.rand((64, 4, 1), generator=g, dtype=F64) - 1)
    got = ref.forward(obs, windows)
    want = model.apply(p64, obs, windows, torch.full((64, 1), 0.05, dtype=F64))
    # the fourier combine cancels terms up to ~1e8 times the output: float64
    # resolves it to ~1e-8 relative, whatever the order of the sums
    assert torch.max(torch.abs(got - want) / (1 + torch.abs(want))) < 1e-7


@pytest.mark.parametrize("K, T", [(8, 5), (16, 3)])
def test_mppi_tick_matches_port(setup, K, T):
    cell, model, p64, ref = setup
    env = port.envs.make_env("oderl-cartpole")
    cfg = MPPIConfig(num_samples=K, horizon=T, nu=1, lambda_=1.0, u_scale=3.0, u_min=-3.0, u_max=3.0, dt=0.05)
    params = make_mppi_params(default_noise_sigma(1, 1.0, dtype=F64))
    dynamics = build_learned_dynamics(model.apply, p64, 0.05)
    g = torch.Generator().manual_seed(K)
    S = 3
    U = torch.randn((S, T, 1), generator=g, dtype=F64)
    obs = env.observe(torch.randn((S, 4), generator=g, dtype=F64))
    buffer = torch.randn((S, 4, 1), generator=g, dtype=F64)
    noise = 1.5 * torch.randn((S, K, T, 1), generator=g, dtype=F64)  # some clip at the bound
    action, U_new, _ = mppi_command(cfg, params, dynamics, build_running_cost(env), U, obs, buffer, noise=noise)
    planner = check.Planner(cell, p64, "cpu", dtype=F64)
    planner.model = ref
    ref_action, ref_U = planner.tick(U, obs, buffer, noise)
    assert torch.max(torch.abs(ref_action - action)) < 1e-7
    assert torch.max(torch.abs(ref_U - U_new)) < 1e-7


def test_cartpole_matches_port():
    env = port.envs.make_env("oderl-cartpole")
    g = torch.Generator().manual_seed(2)
    raw = torch.randn((32, 4), generator=g, dtype=F64) * 3
    act = 4 * torch.randn((32, 1), generator=g, dtype=F64)  # past the clip too
    nxt, r = cartpole.step(raw, act, 0.05)
    want = raw + 0.05 * env.rhs(raw, act)
    assert torch.allclose(nxt, want, rtol=0, atol=1e-12)
    assert torch.allclose(r, env.reward_state(want) + env.reward_action(act), rtol=0, atol=1e-12)
    assert torch.allclose(cartpole.observe(raw), env.observe(raw), rtol=0, atol=1e-15)
    back = cartpole.raw_from_obs(cartpole.observe(raw))
    assert torch.allclose(cartpole.observe(back), cartpole.observe(raw), rtol=0, atol=1e-12)


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    allowed = {"__future__", "math", "torch"}
    for path in sorted((Path(cells.BENCH_DIR) / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names = {(node.module or "").split(".")[0]} if node.level == 0 else set()
            else:
                continue
            assert names <= allowed, f"{path.name} imports {names - allowed}"


def test_widen_keeps_the_checkpoint_and_draws_from_the_seed():
    cell = cells.load("nl512-eval-s10")
    a, b, c = (inputs.params(cell, s, "cpu") for s in (7, 7, 2**40 + 3))
    assert a["laplace_rep"][1]["w"].shape == (512, 512)
    assert a["encoder"]["gru"][1]["w_hh"].shape == (256, 768)
    assert torch.equal(a["laplace_rep"][1]["w"], b["laplace_rep"][1]["w"])
    assert not torch.equal(a["laplace_rep"][1]["w"], c["laplace_rep"][1]["w"])
    base = inputs.params(cells.load("nl128-eval-s20"), 0, "cpu")
    assert torch.equal(a["laplace_rep"][1]["w"][:128, :128], base["laplace_rep"][1]["w"])
    for gate in range(3):  # the r, z, n blocks keep their trained units
        assert torch.equal(a["encoder"]["gru"][0]["w_hh"][:64, gate * 256:gate * 256 + 64],
                           base["encoder"]["gru"][0]["w_hh"][:, gate * 64:(gate + 1) * 64])
    assert np.isclose(float(a["laplace_rep"][1]["w"][128:, 128:].std()), 0.02, rtol=0.05)

"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed, without the
suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Metric: |got - exp| / (1 + |exp|) < 1e-3, the limit chip_smoke.py holds the
kernels to (KERNEL_TOL). tests/test_pallas_nl.py holds the TPU kernel to its
XLA path at 1e-2, but a kernel with __sinf/__cosf in place of sinf/cosf
passes 1e-2 and fails 1e-3.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu_torch import Config, make_controller
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.ops import nl_cuda
from neurallaplacecontrol_tpu_torch.ops import pallas_ilt as tilt
from neurallaplacecontrol_tpu_torch.ops import pallas_nl as tnl
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV_DIMS = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
TOL = 1e-3
RAGGED = [1, 7, 8, 9, 999, 1000, 1001]  # below, at and past the 8-row tile and B
# the seed-batched evaluation's S*K = 20 x 1000 rows, and one ragged past it
SEED_BATCH = [20000, 20003]
# a rank's rows under the K-sharded planner at K=262,144 over two ranks, and over one
SHARD_ROWS = [131072, 262144]
# the resident kernel's walks: the one-tile walk's last B and the cluster walk's first
# (kClusterMinB); on an H100's 39 clusters of 3, whose 78 GRU CTAs take 16 rows a tile,
# 1,248 rows a round: one row under and over ten rounds, ten rounds and five tiles (some
# clusters a tile fewer than others), and the serve cell's K
CLUSTER_ROWS = [10999, 11000, 12479, 12481, 12560, 32768]
DT = 0.05
B = 1000  # the planner's K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_err(got, exp):
    return float(((got - exp).abs() / (1.0 + exp.abs())).max())


def trained(env, device):
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env, 1, "exp", 0, True)
    return load_pytree(path, device=device)


def forward_inputs(env, rows, device, seed=3):
    n, m, high = ENV_DIMS[env]
    fused = make_model("nl", env, n, m, high, device=device).make_fused_planner_apply(trained(env, device), DT)
    rng = np.random.default_rng(seed)
    obs = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=device)
    acts = torch.tensor(rng.uniform(-high, high, (rows, 4 * m)), dtype=torch.float32, device=device)
    return fused, obs, acts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "delay,cfg",
    [(0, Config(encode_obs_time=True)), (1, Config(normalize=False))],
    ids=["age_channel", "unnormalized"],
)
def test_forward_kernel_folds(delay, cfg, cuda_device):
    """The forward's two folds that the d1 checkpoints do not reach: the
    pendulum d0 checkpoint, trained with the age channel (its GRU input is 2
    wide with m = 1: action and age, the age not normalized), and
    normalize=False (actions scaled by 1/3, obs as they are)."""
    env = "oderl-pendulum"
    n, m, high = ENV_DIMS[env]
    in_dim = m + int(cfg.encode_obs_time)
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env, delay, "exp", 0, True)
    params = load_pytree(path, device=cuda_device)
    assert params["encoder"]["gru"][0]["w_ih"].shape[0] == in_dim
    model = make_model("nl", env, n, m, high, cfg, device=cuda_device)
    fused = model.make_fused_planner_apply(params, DT)
    rng = np.random.default_rng(delay)
    obs = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=cuda_device)
    window = rng.uniform(-high, high, (B, 4, in_dim))
    if cfg.encode_obs_time:  # entry ages on the exp grid, newest 0: [d1+d2+d3, d2+d3, d3, 0]
        d = rng.exponential(DT, (B, 3))
        window[:, :3, -1] = np.cumsum(d[:, ::-1], axis=1)[:, ::-1]
        window[:, 3, -1] = 0.0
    acts = torch.tensor(window.reshape(B, 4 * in_dim), dtype=torch.float32, device=cuda_device)
    got = tnl.nl_forward_fused(obs, acts, fused.packed, n, in_dim, terms=17, hopper=fused.hopper)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, in_dim)
    ref = model.apply(params, obs, acts.reshape(B, 4, in_dim), torch.full((B, 1), DT, device=cuda_device))
    torch.cuda.synchronize()
    assert got.shape == (B, n) and bool(torch.isfinite(got).all())
    assert rel_err(got, exp) < TOL
    # the unfused model's complex ILT path, at tests/test_torch_kernels.py's 1e-2
    assert rel_err(got, ref) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_forward_kernel_matches_plain(env, cuda_device):
    n, m, _ = ENV_DIMS[env]
    fused, obs, acts = forward_inputs(env, B, cuda_device)
    # terms=32 reads every column of the padded blocks (the padding adds 0), with
    # the head in two chunks through shared memory
    hopper32 = torch.as_tensor(tnl.repack_nl_forward(fused.packed, n, m, 32), device=cuda_device)
    before = tnl.nl_forward_fused.launches
    got = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=17, hopper=fused.hopper)
    padded = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=32, hopper=hopper32)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, m)
    torch.cuda.synchronize()
    assert tnl.nl_forward_fused.launches == before + 2
    assert got.shape == (B, n) and bool(torch.isfinite(got).all())
    assert rel_err(got, exp) < TOL
    assert rel_err(padded, exp) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", RAGGED + SEED_BATCH + SHARD_ROWS + CLUSTER_ROWS)
def test_forward_kernel_ragged_batches(rows, cuda_device):
    """Batches that fill no tile, exactly one, or one and a bit, up to the
    seed-batched evaluation's 20,000 rows, and across the edges of the
    cluster walk's rounds of tiles: the rows past B are masked on load and
    never stored."""
    n, m, _ = ENV_DIMS["oderl-cartpole"]
    fused, obs, acts = forward_inputs("oderl-cartpole", rows, cuda_device, seed=rows)
    got = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=17, hopper=fused.hopper)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, m)
    out = torch.full((rows + 8, n), 7.0, device=cuda_device)  # 8 guard rows past B
    nl_cuda.launch("nl_forward_launch", (obs, acts, fused.hopper, out),
                   (rows, n, 4, m, 64, 128, n, 17, fused.hopper.numel()))
    torch.cuda.synchronize()
    assert got.shape == (rows, n) and bool(torch.isfinite(got).all())
    assert rel_err(got, exp) < TOL
    assert torch.equal(out[:rows], got) and bool((out[rows:] == 7.0).all())


@pytest.mark.cuda
def test_forward_plan_and_weight_loads_at_the_serve_cell(cuda_device):
    """At the serve cell's dims (cartpole, K = 32,768) the library plans the
    resident kernel's cluster walk: one launch, 16 rows a tile, at most one
    CTA an SM in clusters of 3; each forward adds its CTAs to
    ``nl_forward_fused.weight_loads``, so a weight load serves ~250 rows,
    where at 1,000 rows each CTA of the one-tile walk loads them for 8."""
    n, m, _ = ENV_DIMS["oderl-cartpole"]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for rows, cluster, tile in ((32768, 3, 16), (1000, 1, 8)):
        fused, obs, acts = forward_inputs("oderl-cartpole", rows, cuda_device)
        plan = nl_cuda.forward_plan((rows, n, 4, m, 64, 128, n, 17, fused.hopper.numel()))
        assert plan["variant"] == "resident" and plan["launches"] == 1
        assert plan["cluster"] == cluster and plan["tile"] == (tile, 0)
        roles = tnl.tile_bytes(n, 4, m, 64, 128, n, 17)
        assert plan["smem_bytes"] == (tnl.resident_bytes(n, 4, m, 64, 128, n, 17) if cluster == 1
                                      else max(roles["gru"], roles["trunk_head"]))
        if cluster == 1:
            assert plan["ctas"] == rows // 8
        else:
            assert 0 < plan["ctas"] <= sms and plan["ctas"] % cluster == 0 and rows / plan["ctas"] >= 150
        before = (tnl.nl_forward_fused.weight_loads, tnl.nl_forward_fused.launches)
        for _ in range(2):
            tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=17, hopper=fused.hopper)
        torch.cuda.synchronize()
        assert tnl.nl_forward_fused.weight_loads == before[0] + 2 * plan["ctas"]
        assert tnl.nl_forward_fused.launches == before[1] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_cluster_walk_streams_a_two_chunk_head(env, cuda_device):
    """At 20,000 rows the resident kernel walks row tiles in clusters. At 32
    terms the head (two chunks on acrobot and cartpole, one on pendulum)
    does not fit beside trunk layer 2 in the trunk/head CTA and passes
    through it a chunk at a time for every tile; the padded terms add 0, so
    both term counts match the plain forward."""
    n, m, _ = ENV_DIMS[env]
    fused, obs, acts = forward_inputs(env, 20000, cuda_device)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, m)
    for terms in (17, 32):
        hopper = torch.as_tensor(tnl.repack_nl_forward(fused.packed, n, m, terms), device=cuda_device)
        plan = nl_cuda.forward_plan((20000, n, 4, m, 64, 128, n, terms, hopper.numel()))
        assert plan["cluster"] == 3 and plan["tile"] == (16, 0)
        got = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=terms, hopper=hopper)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and rel_err(got, exp) < TOL, terms


@pytest.mark.cuda
@pytest.mark.parametrize("rows", RAGGED)
def test_head_kernel_matches_plain(rows, cuda_device):
    """Row counts below, at and past the kernel's 8-row tile; at terms=32 the
    head's 192 columns pass through shared memory in two chunks."""
    head = trained("oderl-acrobot", cuda_device)["laplace_rep"][-1]
    packed = tilt.to_device(tilt.pack_head_weights(head["w"], head["b"], 6, 17, 0.125), cuda_device)
    hopper = torch.as_tensor(tilt.repack_head(packed, 6, 17), device=cuda_device)
    hopper32 = torch.as_tensor(tilt.repack_head(packed, 6, 32), device=cuda_device)
    rng = np.random.default_rng(rows)
    x = torch.tensor(np.tanh(rng.standard_normal((rows, 128))), dtype=torch.float32, device=cuda_device)
    before = tilt.nl_head_fused.launches
    got = tilt.nl_head_fused(x, packed, 6, terms=17, hopper=hopper)
    padded = tilt.nl_head_fused(x, packed, 6, terms=32, hopper=hopper32)
    exp = tilt.nl_head_plain(x, packed, 6)
    torch.cuda.synchronize()
    assert tilt.nl_head_fused.launches == before + 2
    assert got.shape == (rows, 6) and bool(torch.isfinite(got).all())
    assert rel_err(got, exp) < TOL
    assert rel_err(padded, exp) < TOL


@pytest.mark.cuda
def test_kernels_reject_bad_operands(cuda_device):
    x = torch.zeros(4, 128, device=cuda_device)
    w = torch.zeros(128, 160, device=cuda_device)
    packed = (w, w, torch.zeros(160, device=cuda_device), torch.zeros(160, device=cuda_device),
              torch.zeros(160, 128, device=cuda_device), torch.zeros(160, 128, device=cuda_device))
    hopper = torch.as_tensor(tilt.repack_head(packed, 5, 17), device=cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        tilt.nl_head_fused(x.double(), packed, 5, terms=17, hopper=hopper)
    with pytest.raises(ValueError, match="contiguous"):
        tilt.nl_head_fused(torch.zeros(128, 4, device=cuda_device).T, packed, 5, terms=17, hopper=hopper)
    with pytest.raises(ValueError, match="repacked"):  # a CUDA tensor never falls back to plain
        tilt.nl_head_fused(x, packed, 5, terms=17)
    with pytest.raises(RuntimeError, match="invalid argument"):  # a buffer of another layout
        nl_cuda.launch("nl_head_launch", (x, hopper, torch.empty(4, 5, device=cuda_device)),
                       (4, 128, 5, 18, hopper.numel()))
    # 10,000 head columns: the combine's scratch alone passes the shared-memory limit
    big = torch.zeros(tilt.head_size(128, 5, 2000), device=cuda_device)
    with pytest.raises(RuntimeError, match="invalid configuration"):
        nl_cuda.launch("nl_head_launch", (x, big, torch.empty(4, 5, device=cuda_device)),
                       (4, 128, 5, 2000, big.numel()))


@pytest.mark.cuda
def test_fused_controller_runs_the_kernel(cuda_device):
    n, m, high = ENV_DIMS["oderl-cartpole"]
    params = trained("oderl-cartpole", cuda_device)
    model = make_model("nl", "oderl-cartpole", n, m, high, device=cuda_device)
    ctrl = make_controller("nl", "oderl-cartpole", 1, Config(fused_nl_planner=True),
                           model_apply=model.apply, params=params, roll_outs=B, time_steps=8,
                           device=cuda_device)
    state = ctrl.reset(0)
    before = tnl.nl_forward_fused.launches
    action, state = ctrl.step(state, torch.zeros(n, device=cuda_device))
    assert tnl.nl_forward_fused.launches == before + 8
    assert bool(torch.isfinite(action).all()) and float(action.abs().max()) <= high


@pytest.mark.cuda
def test_seed_batched_planner_equals_single_ticks(cuda_device):
    """One S=4 planner tick through the kernel gives each seed's S=1 tick on
    the same noise: every horizon step is one launch of 4 x 1000 rows, and
    the softmax reduces over each seed's rollouts only."""
    from neurallaplacecontrol_tpu_torch.planners import mppi_command
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost

    env_name = "oderl-cartpole"
    n, m, high = ENV_DIMS[env_name]
    params = trained(env_name, cuda_device)
    model = make_model("nl", env_name, n, m, high, device=cuda_device)
    env, cfg, mppi_params, dynamics, _, _ = build_planner(
        "nl", env_name, 1, Config(fused_nl_planner=True), model_apply=model.apply, params=params,
        roll_outs=B, time_steps=40, device=cuda_device)
    cost = build_running_cost(env)
    S = 4
    g = torch.Generator(device=cuda_device).manual_seed(0)
    U = torch.randn((S, 40, m), generator=g, device=cuda_device)
    obs = env.observe(env.reset(g).expand(S, -1) + 0.3 * torch.randn((S, 4), generator=g, device=cuda_device))
    buffer = torch.rand((S, 4, m), generator=g, device=cuda_device) * 2 * high - high
    noise = torch.randn((S, B, 40, m), generator=g, device=cuda_device) @ mppi_params.noise_chol.T
    before = tnl.nl_forward_fused.launches
    action, U_new, _ = mppi_command(cfg, mppi_params, dynamics, cost, U, obs, buffer, noise=noise)
    assert tnl.nl_forward_fused.launches == before + 40
    assert action.shape == (S, m) and bool(torch.isfinite(action).all())
    for s in range(S):
        a1, U1, _ = mppi_command(cfg, mppi_params, dynamics, cost, U[s], obs[s], buffer[s], noise=noise[s])
        assert float((action[s] - a1).abs().max()) < TOL
        assert float((U_new[s] - U1).abs().max()) < TOL


def _copy(tree, device):
    from neurallaplacecontrol_tpu_torch.models.common import tree_map

    return tree_map(lambda x: x.to(device), tree)


@pytest.mark.cuda
def test_training_segment_on_card_matches_cpu_f64(cuda_device):
    """50 updates of a narrow NL (nl_hidden_units=16) at f64 on the card and
    on the CPU from the same init, data and batch order: the losses, params,
    moments and count agree at rtol 1e-6 (the card's f64 products add in
    another order; early training's pole-scale losses amplify that over the
    updates). The guard's rejections agree too: one planted spike batch."""
    from neurallaplacecontrol_tpu_torch.models.common import tree_leaves
    from neurallaplacecontrol_tpu_torch.training import make_optimizer, make_train_segment_fn

    cfg = Config(nl_hidden_units=16)
    rng = np.random.default_rng(0)
    n = 400
    data = [rng.standard_normal((n, 3)), rng.uniform(-2.0, 2.0, (n, 4, 1)), None, rng.exponential(0.05, (n, 1))]
    data[2] = data[0] + 0.1 * rng.standard_normal((n, 3))
    idx = rng.permutation(n).reshape(50, 8)
    data[2][idx[10]] = 1e7  # a batch far above the cap
    results = []
    for dev in (torch.device("cpu"), cuda_device):
        model = make_model("nl", "oderl-pendulum", 3, 1, 2.0, cfg, dtype=torch.float64, device=dev)
        params = _copy(model.init(torch.Generator().manual_seed(0)), "cpu") if dev.type == "cpu" else \
            _copy(results[0][3], dev)
        opt = make_optimizer(cfg)
        tensors = [torch.tensor(x, device=dev) for x in data]
        p, state, losses = make_train_segment_fn(model, opt)(params, opt.init(params), *tensors,
                                                              torch.tensor(idx, device=dev), 1e11)
        results.append((_copy(p, "cpu"), _copy([state.mu, state.nu], "cpu"), (int(state.count), losses.cpu()),
                        _copy(params, "cpu")))
    (p_cpu, m_cpu, (c_cpu, l_cpu), _), (p_gpu, m_gpu, (c_gpu, l_gpu), _) = results
    assert c_cpu == c_gpu == 49
    np.testing.assert_allclose(l_gpu.numpy(), l_cpu.numpy(), rtol=1e-6)
    for a, b in zip(tree_leaves([p_gpu, m_gpu]), tree_leaves([p_cpu, m_cpu])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["fourier", "dehoog", "stehfest", "fixed_talbot", "euler", "cme"])
def test_nl_every_ilt_on_card_matches_cpu_f64(algorithm, cuda_device):
    """The NL forward under each ILT and its gradient on the card against the
    CPU at f64 (complex128 on both): rtol 1e-9 (stehfest 1e-5 of the largest
    value: its 3.6e9 weights cancel, and the card adds in another order)."""
    from neurallaplacecontrol_tpu_torch.models.common import tree_leaves

    cfg = Config(nl_hidden_units=16, nl_ilt_algorithm=algorithm)
    rng = np.random.default_rng(1)
    inputs = (rng.standard_normal((32, 3)), rng.uniform(-2.0, 2.0, (32, 4, 1)), rng.uniform(0.02, 0.1, (32, 1)))
    weights = rng.standard_normal((32, 3))
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        model = make_model("nl", "oderl-pendulum", 3, 1, 2.0, cfg, dtype=torch.float64, device=dev)
        params = _copy(model.init(torch.Generator().manual_seed(2)), dev)
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        out = model.apply(params, *(torch.tensor(x, device=dev) for x in inputs))
        grads = torch.autograd.grad(torch.sum(out * torch.tensor(weights, device=dev)), leaves)
        outs.append([out.detach().cpu()] + [g.cpu() for g in grads])
    rtol = 1e-5 if algorithm == "stehfest" else 1e-9
    for got, exp in zip(outs[1], outs[0]):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=rtol, atol=rtol * float(exp.abs().max()))


# ragged, resident, and streamed past shared memory; 200's GRU width (100, padded to 104) leaves
# the last m-tile of 16 columns half live
WIDTHS = [24, 100, 160, 200, 256, 512, 1024, 2048, 3072, 4096]
WIDTH_ROWS = [1, 999, 1001, 20000]
WIDTH_MAX_ROWS = {3072: 1001, 4096: 1001}  # past the old refusal: rows 1, 999 and 1,001


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
def test_fused_planner_refuses_bad_widths_on_card(width, cuda_device):
    """Every width the JAX kernel takes runs the forward kernel on the card
    (widths it refused before: ragged ones padded, wide ones through the
    streamed variant, 3,072 and 4,096 past the width the PR 15 kernel
    refused), at ragged and seed-batch rows, on the port's seeded init:
    within 1e-5 of the f64 forward in units of the fourier terms, and 1e-3
    of the f32 plain forward where f32 resolves the outputs; a launch on the
    counter at every width, the streamed variant's past 128; the layout the
    host packed (``pallas_nl.wide_layout``, the mirror of the library's
    test) is the one the library's plan reads, and below 128 the library's
    shared memory is the mirror's: ``resident_bytes`` for one tile a CTA,
    the larger role of ``tile_bytes`` for the cluster walk (20,000 rows).
    Another ILT than fourier still raises."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    n, m, high = ENV_DIMS["oderl-cartpole"]
    cfg = Config(nl_hidden_units=width)
    model = make_model("nl", "oderl-cartpole", n, m, high, cfg, device=cuda_device)
    fused = model.make_fused_planner_apply(model.init(torch.Generator(device=cuda_device).manual_seed(width)), DT)
    H, hid = fused.packed[1].shape[0], fused.packed[13].shape[0]
    for rows in (r for r in WIDTH_ROWS if r <= WIDTH_MAX_ROWS.get(width, r)):
        dims = (rows, n, 4, m, H, hid, n, 17, fused.hopper.numel())
        plan = nl_cuda.forward_plan(dims)
        assert plan["variant"] == ("streamed" if tnl.wide_layout(n, m, H, hid, n, 17) else "resident") == (
            "streamed" if width > 128 else "resident")
        assert plan["launches"] == (2 * 4 + 4 if width > 128 else 1)
        if width <= 128 and plan["cluster"] == 1:
            assert plan["smem_bytes"] == tnl.resident_bytes(n, 4, m, H, hid, n, 17)
        elif width <= 128:
            roles = tnl.tile_bytes(n, 4, m, H, hid, n, 17)
            assert plan["smem_bytes"] == max(roles["gru"], roles["trunk_head"])
        rng = np.random.default_rng(rows)
        obs = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=cuda_device)
        acts = torch.tensor(rng.uniform(-high, high, (rows, 4 * m)), dtype=torch.float32, device=cuda_device)
        before = (tnl.nl_forward_fused.launches, tnl.nl_forward_fused.streamed_launches)
        got = fused(None, obs, acts.reshape(rows, 4, m), None)
        torch.cuda.synchronize()
        assert tnl.nl_forward_fused.launches == before[0] + 1
        assert tnl.nl_forward_fused.streamed_launches == before[1] + int(width > 128)
        assert got.shape == (rows, n) and bool(torch.isfinite(got).all())
        e = chip_smoke.forward_errors(got, obs, acts, fused.packed, n, m)
        assert e["kernel_cond"] < chip_smoke.WIDTH_COND_LIMIT
        if e["plain_vs_plain64"] < chip_smoke.WIDTH_RESOLVED:  # f32 resolves the outputs
            assert e["kernel_vs_plain"] < TOL
    model = make_model("nl", "oderl-pendulum", 3, 1, 2.0, Config(nl_ilt_algorithm="cme"), device=cuda_device)
    with pytest.raises(ValueError, match="fourier-only"):
        model.make_fused_planner_apply(model.init(torch.Generator().manual_seed(0)), DT)


@pytest.mark.cuda
@pytest.mark.parametrize("terms,actions", [(104, 4), (17, 40)], ids=["terms104", "actions40"])
def test_fused_planner_wide_layout_at_width_128_on_card(terms, actions, cuda_device):
    """At width 128, a head of 104 terms or an action buffer of 40 steps
    puts the resident layout past a block's shared memory: the host packs
    the wide layout (``pallas_nl.wide_layout``), the library plans the
    streamed chain on it (and its resident-layout buffer, packed for 4 steps,
    is refused at 40), and the chain matches the plain forward at rows 1,
    999, 1,001 and 20,000 on the port's seeded init: within 1e-5 of the f64
    forward in units of the fourier terms, and 1e-3 of the f32 plain forward
    where f32 resolves the outputs."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    n, m, high = ENV_DIMS["oderl-cartpole"]
    model = make_model("nl", "oderl-cartpole", n, m, high, Config(nl_s_recon_terms=terms), device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(terms))
    fused = model.make_fused_planner_apply(params, DT, actions)
    H, hid = fused.packed[1].shape[0], fused.packed[13].shape[0]
    assert (H, hid) == (64, 128) and tnl.wide_layout(n, m, H, hid, n, terms, actions)
    if actions != 4:
        short = model.make_fused_planner_apply(params, DT)
        with pytest.raises(ValueError, match="resident layout"):
            nl_cuda.forward_plan((B, n, actions, m, H, hid, n, terms, short.hopper.numel()))
    for rows in (1, 999, 1001, 20000):
        plan = nl_cuda.forward_plan((rows, n, actions, m, H, hid, n, terms, fused.hopper.numel()))
        assert plan["variant"] == "streamed" and plan["launches"] == 2 * actions + 4
        rng = np.random.default_rng(rows)
        obs = torch.tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=cuda_device)
        acts = torch.tensor(rng.uniform(-high, high, (rows, actions * m)), dtype=torch.float32, device=cuda_device)
        before = tnl.nl_forward_fused.streamed_launches
        got = fused(None, obs, acts.reshape(rows, actions, m), None)
        torch.cuda.synchronize()
        assert tnl.nl_forward_fused.streamed_launches == before + 1
        assert got.shape == (rows, n) and bool(torch.isfinite(got).all())
        e = chip_smoke.forward_errors(got, obs, acts, fused.packed, n, m)
        assert e["kernel_cond"] < chip_smoke.WIDTH_COND_LIMIT
        if e["plain_vs_plain64"] < chip_smoke.WIDTH_RESOLVED:  # f32 resolves the outputs
            assert e["kernel_vs_plain"] < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("hx", [100, 512])
def test_head_kernel_at_wide_inputs(hx, cuda_device):
    """The head kernel at input widths other than 128 (its chunks narrowed to
    the stage at 512) against its plain version at 1,000 rows."""
    D, terms = 5, 17
    rng = np.random.default_rng(hx)
    w = rng.standard_normal((hx, 2 * D * terms)) / np.sqrt(hx)
    b = 0.1 * rng.standard_normal(2 * D * terms)
    packed = tilt.to_device(tilt.pack_head_weights(w, b, D, terms, 0.125), cuda_device)
    hopper = torch.as_tensor(tilt.repack_head(packed, D, terms), device=cuda_device)
    x = torch.tensor(np.tanh(rng.standard_normal((B, hx))), dtype=torch.float32, device=cuda_device)
    before = tilt.nl_head_fused.launches
    got = tilt.nl_head_fused(x, packed, D, terms=terms, hopper=hopper)
    torch.cuda.synchronize()
    assert tilt.nl_head_fused.launches == before + 1
    assert rel_err(got, tilt.nl_head_plain(x, packed, D)) < TOL


def family(name, device, dtype=torch.float32):
    """A baseline family on its tracked pendulum-d1 checkpoint."""
    env = "oderl-pendulum"
    n, m, high = ENV_DIMS[env]
    model = make_model(name, env, n, m, high, Config(), dtype=dtype, device=device)
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name(name, env, 1, "exp", 0, True)
    return model, load_pytree(path, like=model.init(torch.Generator(device=device).manual_seed(0)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rnn", "delta_t_rnn", "node", "latent_ode"])
def test_family_forward_on_card_matches_cpu_f64(name, cuda_device):
    """Each baseline family's f32 forward on the card against the port's f64
    forward on the CPU, 1,000 rows of exp-grid horizons (the latent ODE's
    fixed z0 draw is the same on both devices): within 1e-3."""
    gpu_model, gpu_params = family(name, cuda_device)
    cpu_model, cpu_params = family(name, "cpu", torch.float64)
    rng = np.random.default_rng(5)
    obs = rng.standard_normal((B, 3))
    abuf = rng.uniform(-2.0, 2.0, (B, 4, 1))
    ts = rng.exponential(0.05, (B, 1))
    got = gpu_model.apply(gpu_params, *(torch.tensor(x, dtype=torch.float32, device=cuda_device)
                                        for x in (obs, abuf, ts)))
    exp = cpu_model.apply(cpu_params, *(torch.tensor(x) for x in (obs, abuf, ts)))
    assert got.shape == (B, 3) and bool(torch.isfinite(got).all())
    assert rel_err(got.double().cpu(), exp) < TOL


@pytest.mark.cuda
def test_dopri5_masked_steps_on_card(cuda_device):
    """The masked per-row dopri5 on the card at f64 against the CPU: the same
    solution to 1e-10 and the same accepted-step counts, on horizons from
    1e-4 to 10."""
    from neurallaplacecontrol_tpu_torch.ops.integrate import odeint_dopri5_with_stats

    rng = np.random.default_rng(6)
    w1, w2 = rng.standard_normal((5, 32)) / 2.0, rng.standard_normal((32, 5)) / 4.0
    y0 = rng.standard_normal((256, 5))
    t1 = 10.0 ** rng.uniform(-4.0, 1.0, 256)
    out = {}
    for dev in ("cpu", cuda_device):
        a, b = torch.tensor(w1, device=dev), torch.tensor(w2, device=dev)
        ts = torch.stack([torch.zeros(256, dtype=torch.float64, device=dev), torch.tensor(t1, device=dev)], dim=1)
        out[str(dev)] = odeint_dopri5_with_stats(lambda y, t: torch.tanh(y @ a) @ b, torch.tensor(y0, device=dev),
                                                 ts, max_steps=48)
    (ys_cpu, n_cpu), (ys_gpu, n_gpu) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(n_gpu.cpu(), n_cpu) and int(n_cpu.max()) > int(n_cpu.min())
    assert float((ys_gpu.cpu() - ys_cpu).abs().max()) < 1e-10


@pytest.mark.cuda
def test_carried_planner_ticks_on_card(cuda_device):
    """Three latent-ODE controller ticks with carried history on the card
    (K=1000, T=40, f32) against the same ticks at f64 on the CPU, on the
    same noise and z0 draw: the actions within 0.05 (pendulum acts in ±2)."""
    actions = {}
    noise = torch.randn((3, B, 40, 1), generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    for dev, dtype in ((cuda_device, torch.float32), ("cpu", torch.float64)):
        model, params = family("latent_ode", dev, dtype)
        ctrl = make_controller("latent_ode", "oderl-pendulum", 1, Config(), model_apply=model, params=params,
                               roll_outs=B, time_steps=40, dtype=dtype, device=dev)
        state = ctrl.reset(0)
        state = state._replace(U=torch.zeros_like(state.U))
        obs = torch.tensor([-1.0, 0.1, 0.5], dtype=dtype, device=dev)
        acts = []
        for tick in range(3):
            action, state = ctrl.step(state, obs, noise=(noise[tick] @ ctrl.mppi_params.noise_chol.T.cpu().double())
                                      .to(dtype=dtype, device=dev))
            acts.append(action.double().cpu())
        actions[str(dev)] = torch.stack(acts)
    assert float((actions[str(cuda_device)] - actions["cpu"]).abs().max()) < 0.05


@pytest.mark.cuda
def test_ensemble_segment_on_card_matches_cpu_f64(cuda_device):
    """20 updates of a 2-delay delta_t_rnn ensemble at f64 (full width, from
    the tracked pendulum d0 and d1 checkpoints, each member on data of its
    own) on the card and on the CPU: the losses at rtol 1e-9, and each member
    equal to its own per-delay segment on the card. The members do not
    interact on the card either."""
    from neurallaplacecontrol_tpu_torch.models.common import tree_leaves
    from neurallaplacecontrol_tpu_torch.training import ensemble, make_optimizer, make_train_segment_fn

    cfg = Config()
    rng = np.random.default_rng(4)
    n = 320
    s0 = rng.standard_normal((2, n, 3))
    data = [s0, rng.uniform(-2.0, 2.0, (2, n, 4, 1)), s0 + 0.1 * rng.standard_normal((2, n, 3)),
            rng.exponential(0.05, (2, n, 1))]
    idx = torch.tensor(rng.permutation(n).reshape(20, 16))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        model = make_model("delta_t_rnn", "oderl-pendulum", 3, 1, 2.0, cfg, dtype=torch.float64, device=dev)
        members = [load_pytree(REPO / "artifacts" / "checkpoints" / model_checkpoint_name(
            "delta_t_rnn", "oderl-pendulum", d, "exp", 0, True), device=dev, dtype=torch.float64) for d in (0, 1)]
        opt = make_optimizer(cfg)
        tensors = [torch.tensor(x, device=dev) for x in data]
        p, _, losses = ensemble.make_ensemble_segment_fn(model.apply, opt)(
            ensemble.stack_trees(members), ensemble.stack_states([opt.init(m) for m in members]), *tensors,
            idx.to(dev))
        out[dev.type] = losses.cpu()
        if dev.type == "cuda":
            segment = make_train_segment_fn(model, opt)
            for i, m in enumerate(members):
                pi, _, li = segment(m, opt.init(m), *(t[i] for t in tensors), idx.to(dev))
                np.testing.assert_allclose(losses[i].cpu().numpy(), li.cpu().numpy(), rtol=1e-10)
                for a, b in zip(tree_leaves(ensemble.slice_tree(p, i)), tree_leaves(pi)):
                    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(), rtol=1e-9)


@pytest.mark.cuda
def test_driver_mini_grid_on_card(cuda_device, tmp_path):
    """run_exp_multi_torch.main with --device cuda on a miniature grid
    (pendulum d1, 2 seeds, dt 0.5, K=64, T=5): nl trained for 2 s and gated
    through the fused forward kernel, beside the oracle and random; no
    record errored, every return finite, the kernel launched."""
    import sys

    sys.path.insert(0, str(REPO))
    import run_exp_multi_torch

    tnl.nl_forward_fused.launches = 0
    out = run_exp_multi_torch.main([
        "--envs", "oderl-pendulum", "--delays", "1", "--models", "nl,oracle,random", "--device", "cuda",
        "--results", str(tmp_path / "r.jsonl"), "--log_folder", str(tmp_path), "--seed_runs", "2",
        "--dt", "0.5", "--mppi_roll_outs", "64", "--mppi_time_steps", "5", "--retrain", "true",
        "--force_retrain", "true", "--train_seconds", "2", "--train_with_expert_trajectories", "false",
        "--train_samples_per_dim", "3", "--iters_per_log", "50", "--fused_nl_planner", "true",
        "--ensemble_gate_seeds", "2", "--train_gate_retries", "0", "--saved_models_path", str(tmp_path) + "/"])
    recs = out["records"]
    assert [r["model_name"] for r in recs] == ["nl", "oracle", "random"]
    assert all(not r["errored"] and np.isfinite(r["total_rewards"]).all() for r in recs)
    assert len(out["gates"]) == 1 and tnl.nl_forward_fused.launches == 2 * (20 + 1) * 5


@pytest.mark.cuda
def test_k_sharded_plan_in_a_one_rank_nccl_group(cuda_device):
    """The K-sharded planner in a real one-rank NCCL group, through the fused
    forward kernel at K=1,000: its reductions are NCCL calls that add
    nothing, so the plan is the one-process plan to the bit."""
    import socket

    import torch.distributed as dist

    from neurallaplacecontrol_tpu_torch.parallel import Mesh, make_k_sharded_mppi_command, multihost
    from neurallaplacecontrol_tpu_torch.planners import mppi_command
    from neurallaplacecontrol_tpu_torch.training.eval import build_planner
    from neurallaplacecontrol_tpu_torch.training.rollout import build_running_cost

    env_name = "oderl-cartpole"
    n, m, high = ENV_DIMS[env_name]
    model = make_model("nl", env_name, n, m, high, device=cuda_device)
    env, cfg, mp, dyn, _, _ = build_planner("nl", env_name, 1, Config(fused_nl_planner=True), model_apply=model.apply,
                                            params=trained(env_name, cuda_device), roll_outs=B, time_steps=40,
                                            device=cuda_device)
    cost = build_running_cost(env)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    U = torch.randn((40, m), generator=g, device=cuda_device)
    obs = env.observe(env.reset(g, torch.float32, cuda_device))
    buffer = torch.rand((4, m), generator=g, device=cuda_device) * 2 * high - high
    noise = torch.randn((B, 40, m), generator=g, device=cuda_device) @ mp.noise_chol.T
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        command = make_k_sharded_mppi_command(cfg, mp, dyn, cost, Mesh([0], ("k",), device=cuda_device))
        before = tnl.nl_forward_fused.launches
        a_sh, U_sh, aux = command(U, obs, buffer, noise=noise)
        assert tnl.nl_forward_fused.launches - before == 40
        a, U_new, _ = mppi_command(cfg, mp, dyn, cost, U, obs, buffer, noise=noise)
        torch.cuda.synchronize()
        assert torch.equal(a_sh, a) and torch.equal(U_sh, U_new) and aux["omega"].shape == (B,)
    finally:
        dist.destroy_process_group()


def fused_controller(device, K=B, T=40, width=128):
    """The fused cartpole-d1 controller: on the trained checkpoint at width
    128, on the port's seeded init at another width."""
    env = "oderl-cartpole"
    n, m, high = ENV_DIMS[env]
    cfg = Config(fused_nl_planner=True, nl_hidden_units=width)
    model = make_model("nl", env, n, m, high, cfg, device=device)
    params = trained(env, device) if width == 128 else model.init(torch.Generator(device=device).manual_seed(width))
    return make_controller("nl", env, 1, cfg, model_apply=model.apply, params=params, roll_outs=K,
                           time_steps=T, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 512])
def test_exported_fused_step_equals_eager_step(width, cuda_device, tmp_path):
    """The exported fused controller (cartpole d1, K=1000, T=40), loaded back,
    against ``Controller.step`` over 5 ticks on the same noise: actions and U
    within |got - exp| / (1 + |exp|) <= 1e-6 (the same kernel on the same
    operands, so 0 is expected); the program launches the kernel T times a
    tick, on the launch counter. At width 512 the kernel is the streamed
    variant."""
    from neurallaplacecontrol_tpu_torch import serving

    ctrl = fused_controller(cuda_device, width=width)
    path = tmp_path / "c.pt2"
    serving.export_controller(ctrl, path=str(path))
    step = serving.load_controller_step(path)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s1 = s2 = ctrl.reset(0)
    for _ in range(5):
        obs = torch.randn(5, generator=g, device=cuda_device)
        noise = torch.randn((B, 40, 1), generator=g, device=cuda_device)
        a1, s1 = ctrl.step(s1, obs, noise=noise)
        before = (tnl.nl_forward_fused.launches, tnl.nl_forward_fused.streamed_launches)
        a2, s2 = step(s2, obs, noise=noise)
        torch.cuda.synchronize()
        assert tnl.nl_forward_fused.launches - before[0] == 40
        assert tnl.nl_forward_fused.streamed_launches - before[1] == (40 if width > 128 else 0)
        assert rel_err(a2, a1) <= 1e-6 and rel_err(s2.U, s1.U) <= 1e-6


@pytest.mark.cuda
def test_operator_counts_launches_inside_an_exported_program(cuda_device):
    """``torch.ops.nlc.nl_forward`` and ``nl_head`` in a program of their own:
    each call of the program launches each kernel once, on its counter."""
    fused, obs, acts = forward_inputs("oderl-cartpole", 64, cuda_device)
    packed = list(fused.packed)
    head_hopper = torch.as_tensor(tilt.repack_head(packed[15:], 5, 17), device=cuda_device)

    class Both(torch.nn.Module):
        def forward(self, obs, acts):
            y = tnl.nl_forward_fused(obs, acts, packed, 5, 1, terms=17, hopper=fused.hopper)
            x = torch.tanh(torch.cat([y, y], dim=1).repeat(1, 13)[:, :128])
            return y, tilt.nl_head_fused(x.contiguous(), packed[15:], 5, terms=17, hopper=head_hopper)

    program = torch.export.export(Both(), (obs, acts), strict=False).module()
    before = (tnl.nl_forward_fused.launches, tilt.nl_head_fused.launches)
    got = program(obs, acts)
    exp = Both()(obs, acts)
    torch.cuda.synchronize()
    assert (tnl.nl_forward_fused.launches - before[0], tilt.nl_head_fused.launches - before[1]) == (2, 2)
    for g_, e in zip(got, exp):
        assert torch.equal(g_, e)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 999, 1001])
def test_operator_on_ragged_rows(cuda_device, rows):
    """The operator at ragged B, eager and inside an exported program traced
    at another B (the fake implementation's shape follows the rows), against
    the plain forward at 1e-3."""
    fused, obs, acts = forward_inputs("oderl-cartpole", rows, cuda_device, seed=rows)
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, 5, 1)
    got = torch.ops.nlc.nl_forward(obs, acts, list(fused.packed), fused.hopper, 5, 1, 17)
    assert got.shape == (rows, 5) and rel_err(got, exp) < TOL
    _, obs8, acts8 = forward_inputs("oderl-cartpole", 8, cuda_device)
    batch = torch.export.Dim("batch", max=100_000)

    class Fwd(torch.nn.Module):
        def forward(self, o, a):
            return tnl.nl_forward_fused(o, a, fused.packed, 5, 1, terms=17, hopper=fused.hopper)

    program = torch.export.export(Fwd(), (obs8, acts8), dynamic_shapes=({0: batch}, {0: batch}),
                                  strict=False).module()
    traced = program(obs, acts)
    torch.cuda.synchronize()
    assert traced.shape == (rows, 5) and torch.equal(traced, got)


REF_LATENT_ODE_PT = REPO / "artifacts" / "baseline_parity" / "ref_latent_ode_cartpole_d1_r4.pt"


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 17, 1000, 20000])
def test_int8_sums_on_card_equal_cpu(rows, cuda_device):
    """Every int8 matrix of the quantized cartpole-d1 NL through the padded
    ``torch._int_mm`` (fewer than 17 rows and widths that are no multiple of
    8 padded with zeros): the card's int32 sums equal the CPU's and the
    exact int64 product bit for bit."""
    from neurallaplacecontrol_tpu_torch.ops import quant

    q = quant.quantize_nl_params(trained("oderl-cartpole", cuda_device), state_dim=5, action_dim=1,
                                 s_recon_terms=17)
    mats = [(p[f"wq_{w}"], p[f"wq_{w}_mm"]) for p in q["gru"] for w in ("ih", "hh")]
    mats += [(q["enc_out"]["wq"], q["enc_out"]["wq_mm"])] + [(p["wq"], p["wq_mm"]) for p in q["mlp"]]
    g = torch.Generator().manual_seed(rows)
    for wq, wq_mm in mats:
        xq = torch.randint(-127, 128, (rows, wq.shape[0]), generator=g, dtype=torch.int8)
        card = quant.int8_matmul_int32(xq.to(cuda_device), wq_mm)[:, :wq.shape[1]].cpu()
        assert card.dtype == torch.int32 and card.shape == (rows, wq.shape[1])
        assert torch.equal(card, quant.int8_matmul_int32(xq, wq_mm.cpu())[:, :wq.shape[1]])
        assert torch.equal(card, (xq.long() @ wq.cpu().long()).int())


@pytest.mark.cuda
def test_int8_forward_on_card_matches_cpu(cuda_device):
    """The int8 (+fold) forward on the card against the same forward on the
    CPU: the int32 sums are exact, so the two part only by float32 rounding
    around them and the rare activation that rounds to the other int8 step
    (median relative gap < 1e-6, max < 2e-2)."""
    from neurallaplacecontrol_tpu_torch.ops import quant
    from neurallaplacecontrol_tpu_torch.envs import make_env

    spec = make_env("oderl-cartpole").spec
    apply = {d: quant.quantized_apply_for("nl", "oderl-cartpole", trained("oderl-cartpole", d), Config(), spec,
                                          fold_t=DT) for d in ("cpu", cuda_device)}
    rng = np.random.default_rng(5)
    obs = torch.tensor(rng.standard_normal((B, 5)), dtype=torch.float32)
    acts = torch.tensor(rng.uniform(-3.0, 3.0, (B, 4, 1)), dtype=torch.float32)
    ts = torch.full((B, 1), DT)
    exp = apply["cpu"](None, obs, acts, ts)
    got = apply[cuda_device](None, obs.to(cuda_device), acts.to(cuda_device), ts.to(cuda_device)).cpu()
    rel = (got - exp).abs() / (1.0 + exp.abs())
    assert float(rel.median()) < 1e-6 and float(rel.max()) < 2e-2


@pytest.mark.cuda
def test_latent_ode_ref_on_card_matches_cpu_f64(cuda_device):
    """The tracked reference checkpoint through ``interop``: the card's f32
    and f64 ``latent_ode_ref`` forwards against the CPU's f64 (limits 1e-3,
    chip_smoke's LOR_FORWARD_TOL, and 1e-10), and the export from the card's
    tree bit-exact to the file."""
    from neurallaplacecontrol_tpu_torch import interop
    from neurallaplacecontrol_tpu_torch.models.base import norm_stats_for

    sd = interop.load_torch_state_dict(str(REF_LATENT_ODE_PT))
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((B, 5)) * 3.0
    acts = rng.uniform(-3.0, 3.0, (B, 4, 1))
    ts = np.full((B, 1), DT)
    exp = None
    for device, dtype, limit in (("cpu", torch.float64, None), (cuda_device, torch.float64, 1e-10),
                                 (cuda_device, torch.float32, 1e-3)):
        model = make_model("latent_ode_ref", "oderl-cartpole", 5, 1, 3.0, dtype=dtype, device=device)
        params = interop.latent_ode_params_from_state_dict(sd, device=device, dtype=dtype)
        out = model.apply(params, *(torch.tensor(x, dtype=dtype, device=device) for x in (obs, acts, ts)))
        out = out.double().cpu()
        if exp is None:
            exp = out
        else:
            assert rel_err(out, exp) < limit
    back = interop.latent_ode_state_dict_from_params(
        interop.latent_ode_params_from_state_dict(sd, device=cuda_device),
        norm=norm_stats_for("oderl-cartpole", 3.0, 1), dt=float(sd["dt"]))
    raw = torch.load(REF_LATENT_ODE_PT, weights_only=True)
    assert set(back) == set(raw)
    for k, v in raw.items():
        assert back[k].dtype == v.numpy().dtype and np.array_equal(back[k], v.numpy()), k


@pytest.mark.cuda
def test_bf16_config_with_fused_planner_launches_the_f32_kernel(cuda_device):
    """``nl_compute_dtype="bfloat16"`` with ``fused_nl_planner``: the planner
    runs the forward kernel on float32 weights, T launches a tick, and ticks
    as the float32 config's kernel route does on the same noise (equal)."""
    params = trained("oderl-cartpole", cuda_device)
    noise = torch.randn((B, 40, 1), generator=torch.Generator(device=cuda_device).manual_seed(0),
                        device=cuda_device)
    actions = []
    for dtype in ("float32", "bfloat16"):
        cfg = Config(fused_nl_planner=True, nl_compute_dtype=dtype)
        model = make_model("nl", "oderl-cartpole", 5, 1, 3.0, cfg, device=cuda_device)
        ctrl = make_controller("nl", "oderl-cartpole", 1, cfg, model_apply=model.apply, params=params,
                               device=cuda_device)
        tnl.nl_forward_fused.launches = 0
        action, _ = ctrl.step(ctrl.reset(0), torch.zeros(5, device=cuda_device), noise=noise)
        torch.cuda.synchronize()
        assert tnl.nl_forward_fused.launches == 40
        actions.append(action)
    assert torch.equal(actions[0], actions[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dynamics", ["enode", "benode", "ibnode", "pets", "deep_pilco"])
def test_oderl_rollout_on_card_matches_cpu_f64(cuda_device, dynamics):
    """Each ODE-RL family's f64 rollout (nets 2x32, 8 states, 0.5 s) on the
    card against the CPU's on the same init and draws, < 1e-10."""
    from neurallaplacecontrol_tpu_torch import oderl
    from neurallaplacecontrol_tpu_torch.envs import make_env
    from neurallaplacecontrol_tpu_torch.models.common import tree_map

    env = make_env("oderl-pendulum")
    opts = dict(n_ens=4, nl_f=2, nn_f=32, nn_g=32, nn_V=32)
    cpu = oderl.make_ctrl(env, dynamics, dtype=torch.float64, device="cpu", **opts)
    card = oderl.make_ctrl(env, dynamics, dtype=torch.float64, device=cuda_device, **opts)
    params = cpu.init(torch.Generator().manual_seed(0))
    s0 = env.observe(torch.stack([env.reset(torch.Generator().manual_seed(i), torch.float64) for i in range(8)]))
    draws = []

    class Keep(oderl.OderlDraws):
        def f_noise(self, *a, **k):
            draws.append(super().f_noise(*a, **k))
            return draws[-1]

        def pets(self, *a, **k):
            draws.append(super().pets(*a, **k))
            return draws[-1]

        def moments(self, *a, **k):
            draws.append(super().moments(*a, **k))
            return draws[-1]

    exp = cpu.forward_simulate(params, Keep(torch.Generator().manual_seed(1)), 0.5, s0, L=4, tau=5.0,
                               compute_rew=True)

    def to_card(x):
        if isinstance(x, (list, tuple)):
            return type(x)(to_card(v) for v in x)
        return x.to(cuda_device) if torch.is_tensor(x) else x

    class Replay:
        def f_noise(self, *a, **k):
            return to_card(draws.pop(0))

        pets = moments = f_noise

    got = card.forward_simulate(tree_map(lambda x: x.to(cuda_device), params), Replay(), 0.5, s0.to(cuda_device),
                                L=4, tau=5.0, compute_rew=True)
    for g, e in zip(got, exp):
        assert rel_err(g.cpu(), e) < 1e-10

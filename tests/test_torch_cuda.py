"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports no JAX, so it also runs where JAX is not installed, without the
suite's conftest.py (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Metric: |got - exp| / (1 + |exp|) < 1e-2, as tests/test_pallas_nl.py holds the
TPU kernel to its XLA path.
"""

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
TOL = 1e-2
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


@pytest.mark.cuda
@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_forward_kernel_matches_plain(env, cuda_device):
    n, m, high = ENV_DIMS[env]
    fused = make_model("nl", env, n, m, high, device=cuda_device).make_fused_planner_apply(
        trained(env, cuda_device), DT
    )
    rng = np.random.default_rng(3)
    obs = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=cuda_device)
    acts = torch.tensor(rng.uniform(-high, high, (B, 4 * m)), dtype=torch.float32, device=cuda_device)
    before = tnl.nl_forward_fused.launches
    got = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=17)
    padded = tnl.nl_forward_fused(obs, acts, fused.packed, n, m, terms=32)  # padding adds 0
    exp = tnl.nl_forward_plain(obs, acts, fused.packed, n, m)
    torch.cuda.synchronize()
    assert tnl.nl_forward_fused.launches == before + 2
    assert got.shape == (B, n) and bool(torch.isfinite(got).all())
    assert rel_err(got, exp) < TOL
    assert rel_err(padded, exp) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 8, 1000])
def test_head_kernel_matches_plain(rows, cuda_device):
    """Row counts below, at and past the kernel's 8-row tile."""
    head = trained("oderl-acrobot", cuda_device)["laplace_rep"][-1]
    packed = tilt.to_device(tilt.pack_head_weights(head["w"], head["b"], 6, 17, 0.125), cuda_device)
    rng = np.random.default_rng(rows)
    x = torch.tensor(np.tanh(rng.standard_normal((rows, 128))), dtype=torch.float32, device=cuda_device)
    before = tilt.nl_head_fused.launches
    got = tilt.nl_head_fused(x, packed, 6, terms=17)
    exp = tilt.nl_head_plain(x, packed, 6)
    torch.cuda.synchronize()
    assert tilt.nl_head_fused.launches == before + 1
    assert got.shape == (rows, 6)
    assert rel_err(got, exp) < TOL


@pytest.mark.cuda
def test_kernels_reject_bad_operands(cuda_device):
    x = torch.zeros(4, 128, device=cuda_device)
    w = torch.zeros(128, 160, device=cuda_device)
    packed = (w, w, torch.zeros(160, device=cuda_device), torch.zeros(160, device=cuda_device),
              torch.zeros(160, 128, device=cuda_device), torch.zeros(160, 128, device=cuda_device))
    with pytest.raises(ValueError, match="dtype"):
        tilt.nl_head_fused(x.double(), packed, 5, terms=17)
    with pytest.raises(ValueError, match="contiguous"):
        tilt.nl_head_fused(torch.zeros(128, 4, device=cuda_device).T, packed, 5, terms=17)
    with pytest.raises(RuntimeError, match="invalid argument"):  # terms past the padded block
        nl_cuda.launch("nl_head_launch", (x, *packed, torch.empty(4, 5, device=cuda_device)),
                       (4, 128, 5, 33, 32, 160, 128))


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

"""The port's kernel modules (ops.pallas_nl, ops.pallas_ilt, ops.nl_cuda).

On the CPU each wrapper computes its kernel's plain PyTorch version; those
are held against the JAX Pallas kernels run in interpret mode (as
tests/test_pallas_nl.py runs them) and against the port's unfused apply,
with the relative metric |got - exp| / (1 + |exp|) < 1e-2 of
tests/test_pallas_nl.py. tests/test_torch_cuda.py holds the CUDA kernels
against these plain versions on a GPU.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.models.base import norm_stats_for
from neurallaplacecontrol_tpu.ops import pallas_ilt as jilt
from neurallaplacecontrol_tpu.ops import pallas_nl as jnl
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model as torch_make_model
from neurallaplacecontrol_tpu_torch.ops import nl_cuda
from neurallaplacecontrol_tpu_torch.ops import pallas_ilt as tilt
from neurallaplacecontrol_tpu_torch.ops import pallas_nl as tnl
from neurallaplacecontrol_tpu_torch.utils.checkpoint import load_pytree, model_checkpoint_name

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ENV_DIMS = {"oderl-pendulum": (3, 1, 2.0), "oderl-cartpole": (5, 1, 3.0), "oderl-acrobot": (6, 2, 5.0)}
TOL = 1e-2
DT = 0.05


def rel_err(got, exp):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float((np.abs(got - exp) / (1.0 + np.abs(exp))).max())


def trained(env, delay=1):
    path = REPO / "artifacts" / "checkpoints" / model_checkpoint_name("nl", env, delay, "exp", 0, True)
    return load_pytree(path, device="cpu")


def draw(env, B, seed=3, in_extra=0):
    """obs ~ N(0, 1) and actions ~ U(-high, high), as tests/test_pallas_nl.py draws them."""
    n, m, high = ENV_DIMS[env]
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, n)).astype(np.float32)
    abuf = rng.uniform(-high, high, (B, 4, m + in_extra)).astype(np.float32)
    if in_extra:
        abuf[..., -1] = np.abs(abuf[..., -1]) * 0.05
    return obs, abuf


def models(env, cfg_kw=None):
    n, m, high = ENV_DIMS[env]
    cfg_kw = cfg_kw or {}
    jmodel = jax_make_model("nl", env, n, m, high, JConfig(**cfg_kw), dtype=jnp.float32)
    tmodel = torch_make_model("nl", env, n, m, high, TConfig(**cfg_kw), device="cpu")
    return jmodel, tmodel


def jax_tree(tparams):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), tparams)


@pytest.mark.parametrize(
    "env,cfg_kw",
    [
        ("oderl-pendulum", {}),
        ("oderl-cartpole", {}),
        ("oderl-acrobot", {}),
        ("oderl-cartpole", {"encode_obs_time": True}),
        ("oderl-pendulum", {"normalize": False}),
    ],
    ids=["pendulum", "cartpole", "acrobot", "encode_obs_time", "no_normalize"],
)
def test_pack_nl_forward_matches_jax(env, cfg_kw):
    """The host-side fold is the JAX code: identical float32 operands."""
    n, m, high = ENV_DIMS[env]
    jmodel, _ = models(env, cfg_kw)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)), jparams)
    norm = norm_stats_for(env, high, m)
    args = (0.125, n, m, 17, norm.state_mean, norm.state_std, norm.action_mean, norm.action_std)
    kw = dict(normalize=cfg_kw.get("normalize", True), encode_obs_time=cfg_kw.get("encode_obs_time", False))
    exp = jnl.pack_nl_forward(jparams, *args, **kw)
    got = tnl.pack_nl_forward(tparams, *args, **kw)
    assert len(got) == len(exp) == 21
    for i, (g, e) in enumerate(zip(got, exp)):
        assert g.dtype == np.float32, i
        np.testing.assert_array_equal(g, np.asarray(e), err_msg=f"operand {i}")


@pytest.mark.parametrize("env", sorted(ENV_DIMS))
def test_plain_forward_matches_jax_pallas_kernel(env):
    """nl_forward_plain on trained delay-1 weights vs the JAX fused kernel in
    interpret mode, and vs the port's unfused apply."""
    n, m, _ = ENV_DIMS[env]
    tparams = trained(env)
    jmodel, tmodel = models(env)
    obs, abuf = draw(env, 96)
    ts = np.full((96, 1), DT, np.float32)
    with pltpu.force_tpu_interpret_mode():
        exp = np.asarray(jmodel.make_fused_planner_apply(jax_tree(tparams), DT)(None, obs, abuf, ts))

    fused = tmodel.make_fused_planner_apply(tparams, DT)
    got = fused(None, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts))
    assert got.shape == (96, n) and got.dtype == torch.float32
    assert rel_err(got, exp) < TOL
    plain = tnl.nl_forward_plain(torch.tensor(obs), torch.tensor(abuf.reshape(96, -1)), fused.packed, n, m)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())

    unfused = tmodel.apply(tparams, torch.tensor(obs), torch.tensor(abuf), torch.tensor(ts))
    assert rel_err(got, unfused) < TOL


@pytest.mark.parametrize("B", [16, 300])
def test_plain_head_matches_jax_pallas_kernel(B):
    """nl_head_plain vs the JAX head kernel in interpret mode: on the inputs
    of tests/test_pallas_ilt.py, and on trained head weights fed hidden
    states in the trunk's tanh range."""
    D, terms, H = 5, 17, 128
    rng = np.random.default_rng(B)
    x_normal = rng.standard_normal((B, H)).astype(np.float32)
    head = trained("oderl-cartpole")["laplace_rep"][-1]
    for x, w, b in (
        (x_normal, rng.standard_normal((H, 2 * D * terms)).astype(np.float32) * 0.05,
         rng.standard_normal(2 * D * terms).astype(np.float32) * 0.05),
        (np.tanh(x_normal), head["w"].numpy(), head["b"].numpy()),
    ):
        jpacked = jilt.pack_head_weights(w, b, D, terms, 0.125)
        with pltpu.force_tpu_interpret_mode():
            exp = np.asarray(jilt.nl_head_fused(jnp.asarray(x), jpacked, D))
        tpacked = tilt.to_device(tilt.pack_head_weights(w, b, D, terms, 0.125), "cpu")
        for g, e in zip(tpacked, jpacked):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
        got = tilt.nl_head_fused(torch.tensor(x), tpacked, D, terms=terms)
        assert got.shape == (B, D)
        assert rel_err(got, exp) < TOL


def test_fourier_weights_match_jax():
    for t in (0.125, 0.2, 2.5e-3):
        for g, e in zip(tilt.fourier_weights(t, 17), jilt.fourier_weights(t, 17)):
            np.testing.assert_array_equal(g, e)


def test_cpu_wrappers_compute_plain_and_count_no_launch():
    env = "oderl-cartpole"
    n, m, _ = ENV_DIMS[env]
    _, tmodel = models(env)
    fused = tmodel.make_fused_planner_apply(trained(env), DT)
    obs, abuf = (torch.tensor(a) for a in draw(env, 8))
    before = (tnl.nl_forward_fused.launches, tilt.nl_head_fused.launches)
    tnl.nl_forward_fused(obs, abuf.reshape(8, -1), fused.packed, n, m, terms=17)
    tilt.nl_head_fused(torch.zeros(8, 128), fused.packed[15:], n, terms=17)
    assert (tnl.nl_forward_fused.launches, tilt.nl_head_fused.launches) == before


def test_launch_rejects_cpu_operands_before_building():
    with pytest.raises(ValueError, match="expected"):
        nl_cuda.launch("nl_head_launch", (torch.zeros(2, 2),) * 8, (2,) * 7)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nl_kernels.cu(1): error: broken' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(nl_cuda, "find_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="error: broken"):
        nl_cuda.build(tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """A built library for the current sources is reused; nvcc is not run."""
    lib = tmp_path / nl_cuda._digest() / "libnl_kernels.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    monkeypatch.setattr(nl_cuda, "find_nvcc", lambda: pytest.fail("nvcc must not run"))
    assert nl_cuda.build(tmp_path) == lib

"""Port checkpoint loading (neurallaplacecontrol_tpu_torch.utils.checkpoint)
against the JAX package's utils.checkpoint on the 12 tracked NL checkpoints."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurallaplacecontrol_tpu.config import Config as JConfig
from neurallaplacecontrol_tpu.models import make_model as jax_make_model
from neurallaplacecontrol_tpu.utils import checkpoint as jck
from neurallaplacecontrol_tpu_torch.config import Config as TConfig
from neurallaplacecontrol_tpu_torch.models import make_model
from neurallaplacecontrol_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
NL_CHECKPOINTS = sorted(p.name for p in (REPO / "artifacts" / "checkpoints").glob("nl_*.npz"))
ENV_DIMS = {  # env -> (n_obs, m, action_high)
    "oderl-pendulum": (3, 1, 2.0),
    "oderl-cartpole": (5, 1, 3.0),
    "oderl-acrobot": (6, 2, 5.0),
}


def env_of(name: str) -> str:
    return next(e for e in ENV_DIMS if name.startswith(f"nl_{e}_"))


def test_all_twelve_nl_checkpoints_are_tracked():
    assert len(NL_CHECKPOINTS) == 12


@pytest.mark.parametrize("name", NL_CHECKPOINTS)
def test_checkpoint_loads_like_jax(name):
    """Same keys, dtypes and values as the JAX load_pytree; from_jax_params
    carries the JAX tree over to the same tensors."""
    env = env_of(name)
    n, m, high = ENV_DIMS[env]
    model = jax_make_model("nl", env, n, m, high, JConfig(), dtype=jnp.float32)
    path = tck.resolve_checkpoint(name)
    jparams = jck.load_pytree(path, model.init(jax.random.PRNGKey(0)))
    jflat = jck._flatten(jparams)

    tparams = tck.load_pytree(path, device="cpu")
    tflat = tck.flatten_params(tparams)
    assert sorted(tflat) == sorted(jflat)
    for key, value in jflat.items():
        assert tflat[key].dtype == value.dtype, key
        np.testing.assert_array_equal(tflat[key], value, err_msg=key)

    carried = tck.flatten_params(
        tck.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    )
    for key, value in jflat.items():
        np.testing.assert_array_equal(carried[key], value, err_msg=key)


@pytest.mark.parametrize(
    "args",
    [
        ("nl", "oderl-cartpole", 1, "exp", 0, True),
        ("nl", "oderl-acrobot", 3, "fixed", 2, False),
        ("nl", "oderl-pendulum", 0, "exp", 0, True, 10, None),
        ("nl", "oderl-pendulum", 0, "exp", 0, True, None, 1000),
    ],
)
def test_model_checkpoint_name_matches_jax(args):
    assert tck.model_checkpoint_name(*args) == jck.model_checkpoint_name(*args)


def test_resolver_reads_artifacts_checkpoints_only(tmp_path):
    name = "nl_x.npz"
    (tmp_path / "saved_models").mkdir()
    (tmp_path / "saved_models" / name).write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        tck.resolve_checkpoint(name, repo_root=tmp_path)
    (tmp_path / "artifacts" / "checkpoints").mkdir(parents=True)
    (tmp_path / "artifacts" / "checkpoints" / name).write_bytes(b"")
    assert tck.resolve_checkpoint(name, repo_root=tmp_path) == str(
        tmp_path / "artifacts" / "checkpoints" / name
    )


def test_load_casts_dtype():
    params = tck.load_pytree(tck.resolve_checkpoint(NL_CHECKPOINTS[0]), device="cpu",
                             dtype=torch.float64)
    assert params["encoder"]["gru"][1]["w_hh"].dtype == torch.float64
    assert isinstance(params["laplace_rep"], list) and len(params["laplace_rep"]) == 3


def test_port_saved_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port saves loads in the JAX package's load_pytree,
    and JAX's apply on it equals the port's at f64 (rtol 1e-10)."""
    env = "oderl-pendulum"
    n, m, high = ENV_DIMS[env]
    tmodel = make_model("nl", env, n, m, high, TConfig(nl_hidden_units=16), dtype=torch.float64, device="cpu")
    tparams = tmodel.init(torch.Generator().manual_seed(3))
    path = tmp_path / "port.npz"
    tck.save_pytree(path, tparams)
    jmodel = jax_make_model("nl", env, n, m, high, JConfig(nl_hidden_units=16), dtype=jnp.float64)
    jparams = jck.load_pytree(path, jmodel.init(jax.random.PRNGKey(0)))
    for key, value in tck.flatten_params(tparams).items():
        np.testing.assert_array_equal(np.asarray(jck._flatten(jparams)[key]), value, err_msg=key)
    rng = np.random.default_rng(0)
    obs, abuf, ts = rng.standard_normal((16, n)), rng.uniform(-high, high, (16, 4, m)), np.full((16, 1), 0.05)
    exp = np.asarray(jmodel.apply(jparams, jnp.asarray(obs), jnp.asarray(abuf), jnp.asarray(ts)))
    got = tmodel.apply(tparams, *(torch.tensor(x) for x in (obs, abuf, ts))).detach().numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-10, atol=1e-10)


def test_jax_saved_checkpoint_loads_in_port(tmp_path):
    """A checkpoint the JAX package saves loads into the port's tree with
    ``like`` (values, dtype and device from the template); a file with
    other shapes or keys is refused."""
    env = "oderl-acrobot"
    n, m, high = ENV_DIMS[env]
    jparams = jax_make_model("nl", env, n, m, high, JConfig(nl_hidden_units=16),
                             dtype=jnp.float32).init(jax.random.PRNGKey(1))
    path = tmp_path / "jax.npz"
    jck.save_pytree(path, jparams)
    tmodel = make_model("nl", env, n, m, high, TConfig(nl_hidden_units=16), dtype=torch.float64, device="cpu")
    like = tmodel.init(torch.Generator().manual_seed(0))
    loaded = tck.load_pytree(path, like=like)
    for key, value in jck._flatten(jparams).items():
        got = tck.flatten_params(loaded)[key]
        assert got.dtype == np.float64, key
        np.testing.assert_array_equal(got, value.astype(np.float64), err_msg=key)
    wider = make_model("nl", env, n, m, high, TConfig(nl_hidden_units=32), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        tck.load_pytree(path, like=wider.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="keys"):
        tck.load_pytree(path, like={"encoder": like["encoder"]})
